#!/usr/bin/env python3
"""Where a warm full-size run of the PyTorch/CUDA port spends its time.

    python3 scripts/profile_torch_match.py [--path match|dense] [--top 25]

`--path match` (the default) runs `chip_smoke.py`'s matcher path
(synthetic 6012x4008 pair, 2x2 EXHAUSTIVE tiles, 4096 keypoints per
tile, bundled weights, PYDEGENSAC); `--path dense` its dense path
(PlaneSweepStereo at the pipeline's settings on the synthetic 6012x4008
plane pair). Each runs once cold, then once under `torch.profiler` with
CPU and CUDA activity. Prints the card, the device kernels with the most
device time (and the port's own kernels wherever they rank), the run's
stage split, and the device's busy and idle share
of the warm run's wall time (one stream, so kernels do not overlap and
busy time is their sum). Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]


def matcher_run(chip_smoke):
    """(warm-run callable, object whose .timer holds the stage split)."""
    from icepy4d_tpu_torch.matching import (GeometricVerification,
                                            LightGlueMatcher, Quality,
                                            TileSelection)

    img0, img1 = chip_smoke.shifted_pair()
    matcher = LightGlueMatcher({"max_keypoints": 4096})
    call = dict(quality=Quality.HIGH, tile_selection=TileSelection.EXHAUSTIVE,
                grid=[2, 2], overlap=200,
                geometric_verification=GeometricVerification.PYDEGENSAC,
                threshold=1.0)
    return (lambda: matcher.match(img0, img1, **call)), matcher


def dense_run(chip_smoke):
    from icepy4d_tpu_torch.sfm import PlaneSweepStereo

    cams, imgs = chip_smoke.plane_pair()
    z = chip_smoke.PLANE_Z
    pss = PlaneSweepStereo(cams, imgs, depth_min=0.7 * z, depth_max=1.5 * z,
                           n_planes=128, window=7, downscale=1,
                           cost_threshold=0.4, uniqueness_threshold=0.99,
                           lr_check=True, lr_tau=2.0)
    return pss.run, pss


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("match", "dense"), default="match",
                    help="which of chip_smoke.py's paths to profile")
    ap.add_argument("--top", type=int, default=25,
                    help="device kernels to list")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_match: no CUDA device")
    sys.path.insert(0, str(REPO))
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    make = matcher_run if args.path == "match" else dense_run
    run, owner = make(chip_smoke)
    run()                                      # cold: builds, cuDNN plans
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(chip_smoke.card_line())
    print(f"warm {args.path} wall {wall:.4f} s, stages {owner.timer.times}")
    print(f"{'device ms':>10} {'calls':>6}  kernel")
    own = ("nms_border_kernel", "masked_attention_kernel", "sweep_kernel")
    for i, e in enumerate(kernels):
        # the top of the list, and the port's own kernels wherever they are
        if i < args.top or any(name in e.key for name in own):
            print(f"{e.self_device_time_total / 1e3:10.3f} {e.count:6d}  "
                  f"{e.key[:110]}")
    # the PyTorch ops that launched the most device time, by input shape
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.key.startswith("aten::") and e.self_device_time_total > 0]
    ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(f"{'device ms':>10} {'calls':>6}  op [input shapes]")
    for e in ops[:args.top]:
        print(f"{e.self_device_time_total / 1e3:10.3f} {e.count:6d}  "
              f"{e.key} {str(e.input_shapes)[:100]}")
    print(json.dumps({
        "path": args.path, "wall_s": wall, "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "stages_s": owner.timer.times,
        "kernels_listed_share": sum(e.self_device_time_total
                                    for e in kernels[:args.top]) / busy_us,
    }))


if __name__ == "__main__":
    main()
