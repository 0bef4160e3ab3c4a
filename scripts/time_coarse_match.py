#!/usr/bin/env python3
"""LoFTR's coarse match on one card: where the dual-softmax kernel's time
goes, at the benchmark cell's shape.

    python3 scripts/time_coarse_match.py [--pairs 2] [--tokens 30000]
                                         [--reps 10] [--seed 0]

`chip_smoke.py` holds the kernel against its plain version and prints
its ms beside the plain dense path's and the bound (its kernels line);
this script reuses those helpers and adds what the smoke run does not
print. On seeded features (`chip_smoke.dual_softmax_inputs`: a third of
c1's rows noisy copies of c0's, every cell valid), per tile pair, in ms:

  kernel_ms    a launch of `ops/dual_softmax.py::dual_softmax_kernel`
               from CUDA events (`chip_smoke.cuda_ms`), twice
  device_ms    its CUDA kernels' device time under torch.profiler
               (split into TF32 parts, pass 1, reduction, pass 2,
               reduction), and the gap between their sum and kernel_ms
  plain_ms     the dense path, `best_of(confidence_plain(...))`
  bound_ms     `chip_smoke.lower_bound`: the similarity's 2 L0 L1 d
               operations at the dense tensor-core rate

and the kernel's rate in TF32 operations (two passes of three products)
against the 495 TFLOP/s TF32 peak, each path's peak memory beyond its
inputs, the kernel's registers and spills as ptxas reports them, and the
agreement of the two paths (`chip_smoke.hold_best_matches`; exit 1 if
they disagree). Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from icepy4d_tpu_torch.ops import _build  # noqa: E402
from icepy4d_tpu_torch.ops import dual_softmax as ds  # noqa: E402

PEAK_TF32 = 495e12


def peak_extra(fn) -> int:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - base


def device_ms(fn) -> dict:
    """Device ms of each of the launch's CUDA kernels under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if us and ("dual_" in e.key or "split_tf32" in e.key):
            ops[e.key[:80]] = us / 1000.0
    return ops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=cs.DSMAX_SHAPE[0])
    ap.add_argument("--tokens", type=int, default=cs.DSMAX_SHAPE[1])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("time_coarse_match: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    b, n = args.pairs, args.tokens
    c0, c1, m0, m1 = cs.dual_softmax_inputs(b, n, n, dev, seed=args.seed)

    def kernel():
        return ds.dual_softmax_kernel(c0, c1, m0, m1, cs.DSMAX_T)

    def plain():
        return ds.best_of(ds.confidence_plain(c0, c1, m0, m1, cs.DSMAX_T))

    got = kernel()
    ptxas = [ln.strip() for ln in
             _build.build_logs.get(ds.KERNEL.source, "").splitlines()
             if "registers" in ln or "spill" in ln]
    conf = ds.confidence_plain(c0, c1, m0, m1, cs.DSMAX_T)
    try:
        agree = cs.hold_best_matches(got, conf, m0, m1, f"{(b, n, n)}")
    except AssertionError as e:
        agree = {"fault": str(e)}
    del conf, got
    torch.cuda.empty_cache()

    k_ms = [cs.cuda_ms(kernel, args.reps) / b for _ in range(2)]
    p_ms = cs.cuda_ms(plain, 3) / b
    flop = 2.0 * n * n * ds.FEATURE_DIM
    bound_ms, bound_by = cs.lower_bound(
        2 * n * (ds.FEATURE_DIM * 4 + 1) + n * 20, flop, cs.BF16_FLOPS)
    dev_ms = {k: v / b for k, v in device_ms(kernel).items()}
    best = min(k_ms)
    out = {
        "card": cs.card_line(), "torch": torch.__version__,
        "shape": [b, n, n, ds.FEATURE_DIM], "ptxas": ptxas,
        "kernel_ms": k_ms, "device_ms": dev_ms,
        "gap_ms": best - sum(dev_ms.values()),
        "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "roofline_share_pct": 100.0 * bound_ms / best,
        "tf32_ops_share_pct": 100.0 * 6 * flop / (best * 1e-3) / PEAK_TF32,
        "kernel_peak_extra_gb": peak_extra(kernel) / 1e9,
        "plain_peak_extra_gb": peak_extra(plain) / 1e9,
        "agreement": agree, "launches": ds.KERNEL.launches,
    }
    print(json.dumps(out))
    return 1 if "fault" in agree else 0


if __name__ == "__main__":
    sys.exit(main())
