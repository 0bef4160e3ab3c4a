#!/usr/bin/env python3
"""Where a warm full-size run of the PyTorch/CUDA port spends its time.

    python3 scripts/profile_torch_match.py
        [--path match|dense|season|sift|superpoint_train|lightglue_train|
                aliked_train] [--top 25]

`--path match` (the default) runs `chip_smoke.py`'s matcher path
(synthetic 6012x4008 pair, 2x2 EXHAUSTIVE tiles, 4096 keypoints per
tile, bundled weights, PYDEGENSAC); `--path dense` its dense path
(PlaneSweepStereo at the pipeline's settings on the synthetic 6012x4008
plane pair); `--path sift` SIFT at the real season's settings
(`chip_smoke.SIFT_MATCHING`: 16384 keypoints, one orientation) on one
frame of the 6012x4008 pair. `--path superpoint_train`,
`lightglue_train` and `aliked_train` run one train step of
`chip_smoke.py` phase 18 from the bundled weights: SuperPoint on 32
synthetic pairs at 120x160, LightGlue (9 layers) on 16 pairs of 512
keypoints at 240x320, ALIKED on 16 synthetic pairs at 240x320. Each runs
once cold, then once under `torch.profiler` with CPU and CUDA activity.

`--path season` runs `Pipeline.run()` on `chip_smoke.py`'s season
(`chip_smoke.season_config`, three epochs, tracking and dense on as in
its phase 7): epoch 0 is the cold run,
epoch 1 runs under the full profiler, and the device time is also split
by the pipeline's profiler ranges (matcher, track, ransac,
triangulation, ba, dense)
and the host's share of the wall time; epoch 2 runs under a profiler
that traces CUDA activity only, which costs far less a launch, for the
device's busy and idle share of an epoch closer to an untraced one. The
profiled windows run from the end of one epoch to the end of the next,
so they hold the next epoch's decode in the worker thread, as a season
does.

Prints the card, the device kernels with the most device time (and the
port's own kernels wherever they rank), the run's stage split, and the
device's busy and idle share of the warm run's wall time (one stream,
so kernels do not overlap and busy time is their sum). Needs one CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from functools import partial
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
# the Pipeline's profiler ranges (icepy4d_tpu_torch/pipeline.py)
STAGES = ("matcher", "track", "ransac", "triangulation", "ba", "dense")
OWN = ("nms_border_kernel", "masked_attention_kernel", "sweep_kernel")


def matcher_run(chip_smoke):
    """(warm-run callable, callable returning the run's stage split)."""
    from icepy4d_tpu_torch.matching import (GeometricVerification,
                                            LightGlueMatcher, Quality,
                                            TileSelection)

    img0, img1 = chip_smoke.shifted_pair()
    matcher = LightGlueMatcher({"max_keypoints": 4096})
    call = dict(quality=Quality.HIGH, tile_selection=TileSelection.EXHAUSTIVE,
                grid=[2, 2], overlap=200,
                geometric_verification=GeometricVerification.PYDEGENSAC,
                threshold=1.0)
    return (lambda: matcher.match(img0, img1, **call)), \
        (lambda: matcher.timer.times)


def dense_run(chip_smoke):
    from icepy4d_tpu_torch.sfm import PlaneSweepStereo

    cams, imgs = chip_smoke.plane_pair()
    z = chip_smoke.PLANE_Z
    pss = PlaneSweepStereo(cams, imgs, depth_min=0.7 * z, depth_max=1.5 * z,
                           n_planes=128, window=7, downscale=1,
                           cost_threshold=0.4, uniqueness_threshold=0.99,
                           lr_check=True, lr_tau=2.0)
    return pss.run, (lambda: pss.timer.times)


def sift_run(chip_smoke):
    from icepy4d_tpu_torch.models import SIFT

    opt = chip_smoke.SIFT_MATCHING["options"]
    sift = SIFT(max_keypoints=chip_smoke.SIFT_MATCHING["max_keypoints"],
                contrast_threshold=0.015, edge_threshold=12.0,
                dual_orientation=opt["dual_orientation"])
    img = torch.from_numpy(chip_smoke.shifted_pair()[0]).cuda()
    img = img[None].float() / 255.0
    return (lambda: sift.extract(img)), dict


def train_run(chip_smoke, which: str):
    """One train step of phase 18's trainer `which`, from the bundled
    weights on a seeded batch."""
    import numpy as np

    from icepy4d_tpu_torch.models import ALIKED, LightGlue, SuperPoint
    from icepy4d_tpu_torch.models import convert
    from icepy4d_tpu_torch.models.superpoint import SuperPointNet
    from icepy4d_tpu_torch.training import _optim
    from icepy4d_tpu_torch.training import aliked_train as at
    from icepy4d_tpu_torch.training import lightglue_train as lt
    from icepy4d_tpu_torch.training import superpoint_train as st
    from icepy4d_tpu_torch.training.synthetic import make_pair_batch

    dev = torch.device("cuda")
    z = chip_smoke.TRAINING
    rng = np.random.default_rng(0)

    def tree(name):
        return convert.load_params(convert.bundled_checkpoint(name))

    if which == "superpoint_train":
        net = SuperPointNet()
        net.load_state_dict(convert.superpoint_state_dict(
            tree("superpoint_synthetic.npz")))
        net.to(dev)
        step = st.make_train_step(net, _optim.superpoint_optimizer(
            net.parameters(), 1e-3))
        args = [torch.from_numpy(a).to(dev) for a in make_pair_batch(
            rng, z["sp_batch"], 120, 160)]
    elif which == "lightglue_train":
        sp = SuperPoint(max_keypoints=z["lg_keypoints"],
                        detection_threshold=0.0005).load_state_dict(
            convert.superpoint_state_dict(tree("superpoint_synthetic.npz")))
        ds = lt.make_lightglue_dataset(rng, sp.extract, 1, z["lg_batch"])
        lg = LightGlue()
        lg.load_state_dict(convert.lightglue_params(
            tree("lightglue_synthetic.npz")))
        step = lt.make_train_step(lg, _optim.Adam(lg.parameters(), 1e-4,
                                                  clip_norm=1.0))
        args = [{k: torch.from_numpy(v[0]).to(dev) for k, v in ds.items()}]
    else:
        al = ALIKED().load_state_dict(convert.aliked_params(
            tree("aliked_synthetic.npz")))
        step = at.make_train_step(al, _optim.aliked_optimizer(
            al.model.parameters(), 3e-4, z["al_steps"]))
        args = [torch.from_numpy(a).to(dev) for a in make_pair_batch(
            rng, z["al_batch"], 240, 320)] + [
            torch.ones(z["al_batch"], device=dev)]
    return (lambda: step(*args)), dict


def device_kernels(prof) -> list:
    """The run's device kernels and copies, most device time first (the
    stages' ranges also appear on the device timeline: not kernels)."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in STAGES]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return kernels


def stage_device_ms(prof) -> dict:
    """Device time of the kernels launched inside each stage's range (the
    host-side range, whose children's kernels the profiler sums)."""
    out = {}
    for e in prof.events():
        if e.name in STAGES and \
                e.device_type == torch.autograd.DeviceType.CPU:
            t = getattr(e, "device_time_total", None)
            if t is None:                       # older torch
                t = e.cuda_time_total
            out[e.name] = out.get(e.name, 0.0) + t / 1e3
    return out


def report(prof, wall: float, stages: dict, args) -> dict:
    """Print the kernel and op tables of a full profile; return the
    numbers of the JSON line."""
    kernels = device_kernels(prof)
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"warm {args.path} wall {wall:.4f} s, stages {stages}")
    print(f"{'device ms':>10} {'calls':>6}  kernel")
    for i, e in enumerate(kernels):
        # the top of the list, and the port's own kernels wherever they are
        if i < args.top or any(name in e.key for name in OWN):
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
    return {"path": args.path, "wall_s": wall,
            "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "stages_s": stages,
            "kernels_listed_share": sum(e.self_device_time_total
                                        for e in kernels[:args.top])
            / max(busy_us, 1.0)}


def profile_season(chip_smoke, args) -> dict:
    from icepy4d_tpu_torch.pipeline import Pipeline

    tmp = tempfile.TemporaryDirectory()
    _, cfg = chip_smoke.season_config(torch.device("cuda"), tmp.name,
                                      n_epochs=3)
    cfg["proc"].update(do_tracking=True, do_dense=True)   # phase 7's path
    pipe = Pipeline(cfg)
    full = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=True)
    light = profile(activities=[ProfilerActivity.CUDA])
    windows = (full, light)
    spans = []                  # [start, end] of each traced epoch

    def on_epoch(epoch):
        # epoch 0 is cold; 1 runs under `full`, 2 under `light`; each
        # span leaves out the profilers' own start and stop
        torch.cuda.synchronize()
        if spans:
            spans[-1][1] = time.perf_counter()
            windows[len(spans) - 1].stop()
        if len(spans) < len(windows):
            windows[len(spans)].start()
            spans.append([time.perf_counter(), None])

    pipe.run(on_epoch=on_epoch)
    tmp.cleanup()
    (a1, b1), (a2, b2) = spans
    out = report(full, b1 - a1, pipe.stage_times[1], args)
    stages_ms = stage_device_ms(full)
    print("device ms by stage: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages_ms.items())
        + f"; host {out['wall_s'] * 1e3 - out['device_busy_s'] * 1e3:.3f} "
        "ms of the wall time without device work")
    wall2 = b2 - a2
    busy2 = sum(e.self_device_time_total
                for e in device_kernels(light)) / 1e6
    print(f"epoch 2 under CUDA-only tracing: wall {wall2:.4f} s, device "
          f"busy {busy2:.4f} s, stages {pipe.stage_times[2]}")
    out.update(stage_device_ms=stages_ms, light={
        "wall_s": wall2, "device_busy_s": busy2,
        "device_idle_share": 1.0 - busy2 / wall2,
        "stages_s": pipe.stage_times[2]})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("match", "dense", "season", "sift",
                                       "superpoint_train", "lightglue_train",
                                       "aliked_train"),
                    default="match",
                    help="which of chip_smoke.py's paths to profile")
    ap.add_argument("--top", type=int, default=25,
                    help="device kernels to list")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_match: no CUDA device")
    sys.path.insert(0, str(REPO))
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line())
    if args.path == "season":
        out = profile_season(chip_smoke, args)
    else:
        paths = {"match": matcher_run, "dense": dense_run,
                 "sift": sift_run}
        for name in ("superpoint_train", "lightglue_train", "aliked_train"):
            paths[name] = partial(train_run, which=name)
        run, stages = paths[args.path](chip_smoke)
        run()                                  # cold: builds, cuDNN plans
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out = report(prof, wall, stages(), args)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
