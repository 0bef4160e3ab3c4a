"""Span recorder of named stages, and the `timeit` decorator (counterpart
of `icepy4d_tpu/utils/timer.py`).

`AverageTimer` records spans. Each holds its name, its `times` key, its
parent span, the id of the call it belongs to, its host start and end
(`time.perf_counter_ns`) and, on a CUDA device, a pair of timing events
recorded on the current stream at its start and end. While a span is
open under an attached profiler it holds a `torch.profiler` range of its
name, so in a traced run it sits on the profiler's clock beside the
kernels; with no profiler attached it opens none, which saves the
range's cost.

No span synchronises the device. On a CUDA device a span's seconds are
the device time between its two events, so they include the work the
span queued and leave out the host time that the device hid; they are
resolved when `times` is read, with one wait on the last event. The
next call records the same events again (creating and destroying events
costs more host time than recording them). On the CPU a span's seconds
come from the host clock.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import time
from dataclasses import dataclass

import torch

from icepy4d_tpu_torch.utils.logger import LOGGER_NAME, get_logger
from icepy4d_tpu_torch.utils.profiler import annotate

logger = logging.getLogger(LOGGER_NAME)


@dataclass
class Span:
    """One recorded span. `name` is its profiler range (a checkpoint
    opens none), `key` its `times` key (None: not in `times`), `parent`
    the index in `AverageTimer.spans` of the span it opened in;
    `seconds` is None until the span is closed and, on a CUDA device,
    resolved."""

    name: str
    key: str | None
    parent: int | None
    call: int
    start_ns: int
    end_ns: int | None = None
    start_event: object = None
    end_event: object = None
    seconds: float | None = None


class AverageTimer:
    """Spans of one call at a time, with no device synchronisation.

    `call(name)` starts a call (its id is `call_id`, counted from 1;
    the previous call's spans are dropped) inside a span `name`;
    `span(name, key)` or `begin` / `end` record a nested span;
    `update(name)` records a checkpoint, a span from the previous
    checkpoint (or the call's start) to now, with no profiler range.
    `times` is `{key: seconds}` over the call's closed spans; a repeated
    key sums.
    """

    def __init__(self, device=None):
        self._cuda = None     # the CUDA device whose stream takes the events
        if device is not None and torch.device(device).type == "cuda":
            self._cuda = torch.device(device)
        self.call_id = 0
        self.spans: list[Span] = []
        self._open: list[tuple[int, object]] = []   # (span index, range)
        self._stream = None   # the current stream when the call began
        self._pool: list = []   # events no span reads, free to record again
        self._last_event = None
        self._times: dict | None = None
        self._begin_call()

    def _begin_call(self) -> None:
        if self._cuda is not None:
            self._stream = torch.cuda.current_stream(self._cuda)
        self._mark = self._stamp()

    def _stamp(self) -> tuple:
        event = None
        if self._stream is not None:
            event = (self._pool.pop() if self._pool
                     else torch.cuda.Event(enable_timing=True))
            event.record(self._stream)
            self._last_event = event
        return time.perf_counter_ns(), event

    def reset(self) -> None:
        """Start a new call: drop the spans, whose events go back to the
        pool; checkpoints count from now."""
        free = {id(e): e for s in self.spans
                for e in (s.start_event, s.end_event) if e is not None}
        if self._mark[1] is not None:
            free[id(self._mark[1])] = self._mark[1]
        self._pool.extend(free.values())
        self.call_id += 1
        self.spans = []
        self._open = []
        self._times = None
        self._begin_call()

    @property
    def current(self) -> str | None:
        """Name of the innermost open span."""
        return self.spans[self._open[-1][0]].name if self._open else None

    def _parent(self) -> int | None:
        return self._open[-1][0] if self._open else None

    def begin(self, name: str, key: str | None = None) -> None:
        """Open a span, and its profiler range where a profiler is
        attached."""
        rng = None
        if torch.autograd._profiler_enabled():
            rng = annotate(name)
            rng.__enter__()
        start_ns, event = self._stamp()
        self.spans.append(Span(name, key, self._parent(), self.call_id,
                               start_ns, start_event=event))
        self._open.append((len(self.spans) - 1, rng))

    def end(self, name: str) -> None:
        """Close the innermost open span, which must be `name`."""
        if self.current != name:
            raise RuntimeError(f"span {name!r} ends while {self.current!r} "
                               "is the innermost open span")
        index, rng = self._open.pop()
        span = self.spans[index]
        span.end_ns, span.end_event = self._stamp()
        if span.end_event is None:
            span.seconds = (span.end_ns - span.start_ns) / 1e9
        if rng is not None:
            rng.__exit__(None, None, None)
        self._times = None

    @contextlib.contextmanager
    def span(self, name: str, key: str | None = None):
        self.begin(name, key)
        try:
            yield
        finally:
            self.end(name)

    @contextlib.contextmanager
    def call(self, name: str):
        """A new call inside a span `name`; spans its body leaves open
        close with it."""
        self.reset()
        self.begin(name)
        try:
            yield
        finally:
            while self._open:
                self.end(self.current)

    def update(self, name: str = "default") -> None:
        """Checkpoint: a span `name` from the previous checkpoint (or
        the call's start) to now."""
        end_ns, event = self._stamp()
        start_ns, start_event = self._mark
        self.spans.append(Span(
            name, name, self._parent(), self.call_id, start_ns, end_ns,
            start_event, event,
            None if event is not None else (end_ns - start_ns) / 1e9))
        self._mark = (end_ns, event)
        self._times = None

    def _resolve(self) -> None:
        """Seconds of the closed spans from their events, after one wait
        on the last event."""
        todo = [s for s in self.spans
                if s.seconds is None and s.end_event is not None]
        if not todo:
            return
        self._last_event.synchronize()
        for s in todo:
            s.seconds = s.start_event.elapsed_time(s.end_event) / 1e3

    @property
    def times(self) -> dict[str, float]:
        """{key: seconds} of the call's closed spans, a repeated key
        summed."""
        if self._times is None:
            self._resolve()
            times: dict[str, float] = {}
            for s in self.spans:
                if s.key is not None and s.seconds is not None:
                    times[s.key] = times.get(s.key, 0.0) + s.seconds
            self._times = times
        return self._times

    def stages(self) -> dict[str, float]:
        """`times` of the keyed spans that no keyed span encloses."""
        self._resolve()
        out: dict[str, float] = {}
        for s in self.spans:
            if s.key is None or s.seconds is None:
                continue
            p = s.parent
            while p is not None and self.spans[p].key is None:
                p = self.spans[p].parent
            if p is None:
                out[s.key] = out.get(s.key, 0.0) + s.seconds
        return out

    def print(self, text: str = "Timer") -> None:
        if not logger.isEnabledFor(logging.INFO):
            return
        parts = [f"{name}={t:.3f}" for name, t in self.times.items()]
        total = sum(self.stages().values())
        logger.info(f"[{text}] " + ", ".join(parts) + f" total={total:.3f} s")


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
