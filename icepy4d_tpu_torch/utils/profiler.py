"""Device tracing (counterpart of `icepy4d_tpu/utils/profiler.py`, which
wraps `jax.profiler`): `trace` records the enclosed block with
`torch.profiler` (CPU, and CUDA where a card is present) and writes a
Chrome trace; `annotate` names a region of that timeline."""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str = "profile"):
    """Profile the enclosed block; yields the `torch.profiler.profile`
    and writes `<log_dir>/trace.json` (chrome://tracing or Perfetto)
    when the block ends."""
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def annotate(name: str):
    """Named region for the profiler timeline (use as context manager)."""
    return torch.profiler.record_function(name)
