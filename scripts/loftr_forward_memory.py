#!/usr/bin/env python3
"""What one LoFTR forward of B tile pairs allocates and takes on one card.

    python3 scripts/loftr_forward_memory.py [--height 1200] [--width 1600]
                                            [--batches 1 2 4 8] [--reps 3]

For each batch size B, `LoFTR.match_batch` over B random tile pairs of
height x width (random weights from `loftr_tree`, the benchmark cell's
threshold 1e-8 and 1024 matches a tile pair, TF32 convolutions): the
peak bytes allocated beyond what was allocated before the call
(`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats`),
that peak a tile pixel (B x height x width), and the wall ms of a warm
forward, which ends in a synchronise, over `reps` forwards. The peak a
tile pixel is what `LoFTRMatcher.CARD_BYTES_PER_PIXEL` budgets. One
JSON line, with the card's name and power limit. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import card_line  # noqa: E402
from icepy4d_tpu_torch.matching import LoFTRMatcher  # noqa: E402
from icepy4d_tpu_torch.models.convert import loftr_params  # noqa: E402
from icepy4d_tpu_torch.models.loftr import LoFTR, loftr_tree  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--height", type=int, default=1200)
    ap.add_argument("--width", type=int, default=1600)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("loftr_forward_memory: needs a CUDA device")
    dev = torch.device("cuda")
    model = LoFTR(thr=1e-8, max_matches=1024, device=dev)
    model.load_state_dict(loftr_params(loftr_tree(args.seed)))
    g = torch.Generator(device=dev).manual_seed(args.seed)
    h, w = args.height, args.width
    rows = []
    for b in args.batches:
        imgs0 = torch.rand(b, h, w, generator=g, device=dev)
        imgs1 = imgs0.roll(8, 2)
        valid = np.ones(b, bool)
        model.match_batch(imgs0, imgs1, valid)      # warm: cuDNN's plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        out = model.match_batch(imgs0, imgs1, valid)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        del out
        ms = []
        for _ in range(args.reps):
            t = time.perf_counter()
            model.match_batch(imgs0, imgs1, valid)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
        del imgs0, imgs1
        torch.cuda.empty_cache()
        rows.append({"pairs": b, "peak_bytes": peak,
                     "bytes_per_pixel": peak / (b * h * w),
                     "forward_ms": ms, "ms_per_pair": min(ms) / b})
    print(json.dumps({
        "card": card_line(), "torch": torch.__version__,
        "tile": [h, w], "budgeted_bytes_per_pixel":
            LoFTRMatcher.CARD_BYTES_PER_PIXEL,
        "total_bytes": torch.cuda.get_device_properties(dev).total_memory,
        "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
