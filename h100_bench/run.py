"""One run of one cell of the benchmark.

    python3 -m h100_bench --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the kernels' build or load, weights, inputs made from
the seed on the card, warm-up of the cell's own shapes) is timed as
`setup_s`. The window then drives the cell's loop closed: one item after
another until the item in flight at the deadline completes; rates are
all completed items over all of that time. With `--trace 1` the first
`trace_seconds` of the window (the traffic's) run under `torch.profiler`
and the run reports the cell's per-layer metrics; with `--trace 0` its
end-to-end metrics. After the window the peak memory is read, the
program's state freed, and the items sampled from the seed are compared
with the plain reference: each number compared is printed beside its
limit as the last lines of standard error and under `checks`, the last
key of the result, which is the last line of standard output.

The run refuses (exit 2, no result) without enough CUDA devices, and
fails (exit 3, no result) when `jax`, `jaxlib`, `flax` or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

from h100_bench import spec

# top-level module names that no run may load, compared whole (the
# port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "icepy4d_tpu")


def forbidden_modules(modules=None) -> list:
    names = {m.split(".", 1)[0] for m in (modules if modules is not None
                                          else list(sys.modules))}
    return sorted(names & set(FORBIDDEN))


@dataclass
class Run:
    """What a metric reader reads: the cell, its window and its trace."""
    workload: str
    config: dict
    traffic: dict
    loop: object
    setup_s: float = 0.0
    window_s: float = 0.0
    items: list = field(default_factory=list)     # seconds of each item
    trace: object = None                           # trace.Trace
    traced_items: int = 0


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(run: Run, seconds: float, trace: bool, device) -> None:
    """Drive the loop closed for `seconds`; trace its first part."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from h100_bench import trace as tr

    loop = run.loop
    trace_s = float(run.traffic.get("trace_seconds", seconds))
    prof = span = None
    _sync(device)
    if trace:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        span = record_function("bench.window")
        span.__enter__()

    def stop_trace():
        _sync(device)
        span.__exit__(None, None, None)
        prof.stop()
        run.traced_items = len(run.items)
        events = prof.profiler.kineto_results.events()
        w = next(e for e in events if e.name() == "bench.window")
        run.trace = tr.read(events, int(w.start_ns()), int(w.end_ns()))

    t0 = time.perf_counter()
    deadline = t0 + seconds
    now = t0
    while now < deadline:
        a = time.perf_counter()
        if prof is not None:
            with record_function("bench.item"):
                loop.step()
        else:
            loop.step()
        now = time.perf_counter()
        run.items.append(now - a)
        if prof is not None and now - t0 >= trace_s:
            stop_trace()
            prof = None
            now = time.perf_counter()
    run.window_s = now - t0
    if prof is not None:
        stop_trace()


def perform(bench: dict, workload: str, config: dict, traffic: dict,
            seed: int, seconds: float, trace: bool, device,
            t_start: float) -> tuple:
    """Everything of a run after the look for the devices: (exit code,
    the result, {number: (value, limit)})."""
    cell = spec.cell(bench, workload)
    loop = spec.module("loops", traffic["loop"]).Loop(config, traffic, seed,
                                                      device)
    run = Run(workload, config, traffic, loop)
    loop.setup()
    _sync(device)
    run.setup_s = time.perf_counter() - t_start
    print(f"setup {run.setup_s:.3f} s: {loop.setup_parts}", file=sys.stderr,
          flush=True)

    window(run, seconds, trace, device)
    cuda = device.type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    loaded = forbidden_modules()
    if loaded:
        print(f"h100_bench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3, None, {}
    for line in loop.item_lines():
        print(line, file=sys.stderr)
    loop.release()
    checks = loop.check()
    correct = all(v <= lim for v, lim in checks.values())

    metrics = {}
    for m in spec.metrics_of(bench, workload, trace):
        value = spec.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else device.type,
                   "count": int(cell["chips"]), "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(run.items), "failed": 0,
           "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info.update(busy_s=run.trace.busy_s,
                           window_s=run.trace.window_s)
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return 0, out, checks


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(cell["chips"]):
        print(f"h100_bench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s), found {found}", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", file=sys.stderr, flush=True)
    rc, out, checks = perform(
        bench, args.workload, spec.config(bench, cell["config"]),
        spec.traffic(cell["traffic"]), args.seed, args.seconds,
        bool(args.trace), torch.device("cuda"), t_start)
    if rc:
        return rc
    out["device"]["power_limit"] = card.split(",")[-1].strip()
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
