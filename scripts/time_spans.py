"""Cost of the port's span recorder (`utils/timer.py::AverageTimer`) on a
CUDA device: host microseconds of one call of `--per-call` spans (the
call's own span and the rest nested in it, as a tiled `match()` records
them), with the read of `times` that follows it (one wait on the last
event, then each span's elapsed time), with no profiler attached and
under `torch.profiler`. Prints one JSON line with the card's name and
power limit.

    python3 scripts/time_spans.py [--calls 2000] [--per-call 9]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]


def call_us(timer, per_call: int, calls: int) -> float:
    t0 = time.perf_counter()
    for _ in range(calls):
        with timer.call("cost"):
            for _ in range(per_call - 1):
                with timer.span("cost.span", "span"):
                    pass
        timer.times
    return 1e6 * (time.perf_counter() - t0) / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--per-call", type=int, default=9)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_spans.py measures on a CUDA device; none found")
    sys.path.insert(0, str(REPO))
    from icepy4d_tpu_torch.utils.timer import AverageTimer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    timer = AverageTimer(device="cuda")
    call_us(timer, args.per_call, 100)                 # warm-up
    off = call_us(timer, args.per_call, args.calls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = call_us(timer, args.per_call, args.calls // 4)
    print(json.dumps({
        "card": card, "spans_per_call": args.per_call,
        "call_us_profiler_off": off, "call_us_profiler_on": on}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
