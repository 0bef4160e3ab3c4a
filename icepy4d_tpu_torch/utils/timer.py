"""Named-checkpoint timer with exponential smoothing, and the `timeit`
decorator (counterpart of `icepy4d_tpu/utils/timer.py`)."""

from __future__ import annotations

import functools
import logging
import time

import torch

from icepy4d_tpu_torch.utils.logger import LOGGER_NAME, get_logger

logger = logging.getLogger(LOGGER_NAME)


class AverageTimer:
    """Wall-clock time between named checkpoints.

    With a CUDA `device`, each checkpoint first waits for the device, so
    a stage's time includes the kernels it queued and not only their
    launch.
    """

    def __init__(self, smoothing: float = 0.3, device=None):
        self.smoothing = smoothing
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self.times: dict[str, float] = {}
        self.reset()

    def _now(self) -> float:
        if self._cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    def reset(self) -> None:
        self.start = self._now()
        self.last_time = self.start

    def update(self, name: str = "default") -> None:
        now = self._now()
        dt = now - self.last_time
        if name in self.times:
            dt = self.smoothing * dt + (1.0 - self.smoothing) * self.times[name]
        self.times[name] = dt
        self.last_time = now

    def print(self, text: str = "Timer") -> None:
        parts = [f"{name}={t:.3f}" for name, t in self.times.items()]
        total = sum(self.times.values())
        logger.info(f"[{text}] " + ", ".join(parts) + f" total={total:.3f} s")
        self.reset()


def timeit(func):
    """Decorator: log the wall-clock time of each call of `func`."""
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        result = func(*args, **kwargs)
        get_logger().info(
            f"Function {func.__name__} took {time.perf_counter() - t0:.4f} s"
        )
        return result

    return wrapper
