#!/usr/bin/env python3
"""CPU rehearsal of `chip_smoke.py`'s season and matcher phases (7:
LightGlue with tracking and dense; 8: the SIFT season; 10: the adaptive
matcher; 11: the n-camera season; 12: PnP, MAGSAC and the stereo season
with space resection and the match writer; 13: SuperGlue; 14: DISK and
ALIKED; 15: semi-dense and LoFTR; 16: warmup, watch and the EXIF
scanner; 17: the 4D products on phase 7's outputs, which it runs first;
18: training; 19: the batched, multi-process and staged seasons, after
phase 7; 20: ring attention and the sequence- and pipeline-parallel
matchers; 21: the command lines, after phase 7) at a reduced frame
size.

    python3 scripts/rehearse_seasons_cpu.py \
        [--phase 7|8|10|11|12|13|14|15|16|17|18|19|20|21|both|all]

Runs every stage of the phases on the CPU on 1000x1504 frames (f = 1500
px, 5 m baseline, 1024 keypoints a tile), in a few minutes ("both" is
phases 7 and 8, "all" every one). Launches are
counted on the kernels' plain versions (the CPU runs no kernel). The
gates, set from full-size card runs, are checked and a gate that fails
is printed, not raised: at this size the tie-point and rotation gates
are expected to fail. Phase 18 runs on a 3-epoch 480x640 season of the
port's Pipeline (about 20 s) at toy sizes (64 keypoints, batches of
2, a few steps), which checks its control flow
and launch counts, not its gates on the loss. Phase 20 runs on the
reduced pair with 1024 tokens a frame, phase 4's tile pairs at 1024
keypoints and LoFTR coarse tokens of four 240x320 crops (random
weights) in place of phase 15's. Phase 21's subprocess gets `--device
cpu` appended (a new process sees none of these patches).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("7", "8", "10", "11", "12", "13",
                                        "14", "15", "16", "17", "18", "19",
                                        "20", "21", "both", "all"),
                    default="both")
    args = ap.parse_args()

    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.empty_cache = lambda *a, **k: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.memory_allocated = lambda *a, **k: 0
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    import chip_smoke as cs
    import icepy4d_tpu_torch.matching.matchers as matchers
    import icepy4d_tpu_torch.parallel.mesh as mesh
    import icepy4d_tpu_torch.pipeline as pipeline
    from icepy4d_tpu_torch.models import superpoint
    from icepy4d_tpu_torch.ops import attention, dense

    cs.H_IMG, cs.W_IMG = 1000, 1504
    cs.SEASON_F = 1500.0
    cs.SEASON_KEYPOINTS = 1024
    cs.SEASON_BASELINE = 5.0    # at 4 m the faces' disparities collapse
    cs.SEMIDENSE_CROP = (504, 752)
    cs.cuda_ms = lambda fn, reps: (fn(), 0.0)[1]   # no timing on the CPU
    cs.card_line = lambda: "CPU rehearsal"
    import icepy4d_tpu_torch.cli as cli
    import icepy4d_tpu_torch.examples as examples

    commands = [__import__(f"icepy4d_tpu_torch.cli.{c}", fromlist=["main"])
                for c in cli.COMMANDS]
    walkthroughs = [__import__(f"icepy4d_tpu_torch.examples.{c}",
                               fromlist=["main"]) for c in (
        "single_epoch_stereo", "multitemporal_4d", "matching_benchmark")]
    del examples
    for mod in (pipeline, matchers, mesh, *commands, *walkthroughs):
        mod.resolve_device = lambda device=None: torch.device("cpu")
    run_process = cs.subprocess.run

    def on_cpu(cmd, *a, **k):
        if "run_pipeline" in cmd:
            cmd = [*cmd, "--device", "cpu"]
        return run_process(cmd, *a, **k)

    cs.subprocess.run = on_cpu
    counts = {"nms": 0, "attention": 0, "sweep": 0}

    def counted(mod, name, key):
        fn = getattr(mod, name)

        def call(*a, **k):
            counts[key] += 1
            return fn(*a, **k)

        setattr(mod, name, call)

    counted(superpoint, "fused_nms_border", "nms")
    counted(attention, "attention_plain", "attention")
    counted(dense, "disparity_sweep_plain", "sweep")
    # the kernel's own entry, which phase 10 calls on captured operands
    attention.flash_attention = attention.attention_plain

    def reset():
        for k in counts:
            counts[k] = 0

    def read():
        return dict(counts)

    dev = torch.device("cpu")
    want = {"both": ("7", "8"),
            "all": ("7", "8", "10", "11", "12", "13", "14", "15", "16",
                    "17", "18", "19", "20", "21")}.get(
        args.phase, (args.phase,))
    with tempfile.TemporaryDirectory() as tmp:
        scene, cfg = cs.season_config(dev, tmp, n_epochs=3)
        # one extraction chunk an image at this size; one pair chunk
        first = {"nms": 2, "attention": 36, "sweep": 2}
        tracked = dict(first, attention=72)
        # three cameras: two matches an epoch; a tracked epoch extracts
        # the three frames and seeds one forward of 12 tile pairs
        first3 = {"nms": 4, "attention": 72, "sweep": 0}
        tracked3 = {"nms": 7, "attention": 108, "sweep": 0}
        phases = []
        epoches = []

        season_out = []

        def season():
            out, eps = cs.season_path(dev, reset, read, scene, cfg,
                                      [first, tracked, tracked])
            season_out.append(out)
            epoches.append(eps)

        if "7" in want or "17" in want or "19" in want or "21" in want:
            phases.append(("7", season))
        if "8" in want:
            phases.append(("8", lambda: cs.sift_season_path(
                dev, reset, read, scene, cfg)))
        from icepy4d_tpu_torch.matching import (GeometricVerification,
                                                Quality, TileSelection)
        img0, img1 = cs.shifted_pair()
        call = dict(quality=Quality.HIGH,
                    tile_selection=TileSelection.EXHAUSTIVE,
                    grid=[2, 2], overlap=50, threshold=1.0,
                    geometric_verification=GeometricVerification.PYDEGENSAC)
        if "10" in want:
            phases.append(("10", lambda: cs.adaptive_path(
                dev, reset, read, img0, img1, call, 2, 0.0,
                max_keypoints=cs.SEASON_KEYPOINTS)))
        if "11" in want:
            def multicam():
                scene3, cfg3 = cs.multicam_config(dev, Path(tmp) / "mc",
                                                  n_epochs=3)
                return cs.multicam_path(dev, reset, read, scene3, cfg3,
                                        [first3, tracked3, tracked3])
            phases.append(("11", multicam))
        if "12" in want:
            phases.append(("12", lambda: (
                cs.pnp_check(dev),
                cs.resection_season_path(cfg, n_epochs=2))))
        if "13" in want:
            phases.append(("13", lambda: cs.superglue_path(
                dev, reset, read, img0, img1, call, 2,
                max_keypoints=cs.SEASON_KEYPOINTS)))
        if "14" in want:
            phases.append(("14", lambda: cs.extractor_path(
                dev, reset, read, img0, img1, call,
                max_keypoints=cs.SEASON_KEYPOINTS)))
        if "15" in want:
            phases.append(("15", lambda: cs.loftr_semidense_path(
                dev, reset, read, img0, img1)))
        if "16" in want:
            untracked = {"nms": 2, "attention": 36, "sweep": 0}
            phases.append(("16", lambda: (
                cs.season_tools_path(reset, read, cfg, [
                    untracked, dict(untracked, attention=72)], 0.0),
                cs.exif_check(tmp))))
        if "17" in want or "19" in want or "21" in want:
            # phases 17, 19 and 21 need phase 7's outputs: the full-size
            # gates of phase 7 are not checked here
            cs.check_epoch = lambda st, gates: None
            cs.SEASON_GATES = dict(cs.SEASON_GATES, points=0, dense_points=0,
                                   dense_surface_m=float("inf"),
                                   track_px=float("inf"))
            cs.BATCHED_GATES = dict(cs.BATCHED_GATES, points=0)
            cs.BATCHED_SIFT_GATES = dict(cs.BATCHED_SIFT_GATES, points=0)
        if "17" in want:
            phases.append(("17", lambda: cs.products_path(
                dev, reset, read, scene, epoches[-1], tmp)))
        if "18" in want:
            def training():
                from icepy4d_tpu_torch.pipeline import Pipeline
                from torch_port_inputs import REPO_WEIGHTS, StereoSeason

                cfg18 = StereoSeason(480, 640, 640.0).write(
                    Path(tmp) / "s18", n_epochs=3, options={
                        "superpoint_weights": str(
                            REPO_WEIGHTS / "superpoint_synthetic.npz"),
                        "lightglue_weights": str(
                            REPO_WEIGHTS / "lightglue_synthetic.npz"),
                        "activation_dtype": "float32"})
                Pipeline(cfg18, device="cpu").run()
                cs.TRAINING = dict(
                    sp_steps=4, sp_batch=2, sp_cached=2, ha_patches=2,
                    lg_batches=3, lg_eval=1, lg_batch=2, lg_keypoints=64,
                    lg_steps=2, ft_batches=1, ft_steps=2,
                    al_steps=2, al_batch=2, al_batches=2, chunk=2, reps=1)
                return cs.training_path(dev, reset, read,
                                        cfg18["paths"]["image_dir"],
                                        cfg18["paths"]["results_dir"], tmp)
            phases.append(("18", training))
        if "19" in want:
            def batched():
                eps = epoches[-1]
                ref = cs.season_summary(list(eps), list(eps[0].features))
                warm = [cs.epoch_seconds(season_out[-1]["stage_times_s"][k])
                        for k in ("1", "2")]
                return cs.batched_path(dev, reset, read, scene, cfg, ref,
                                       warm, img0, img1, call)
            phases.append(("19", batched))
        if "20" in want:
            # the raw matches' shift precision is gated at full size only;
            # the CPU's f32 matmuls block differently for one tile pair
            # and for four, which moves the 9-layer log assignment by
            # ~1e-2 (the card reads 0)
            cs.SHARDED_GATES = dict(cs.SHARDED_GATES, precision=0.0,
                                    pp_logassign=0.1)

            def sharded():
                from icepy4d_tpu_torch.matching import (LightGlueMatcher,
                                                        LoFTRMatcher)
                m = LightGlueMatcher({"max_keypoints": cs.SEASON_KEYPOINTS})
                pairs = []
                run_matcher = m._run_matcher
                m._run_matcher = lambda d: (pairs.append(d),
                                            run_matcher(d))[1]
                m.match(img0, img1, **call)
                tile_pairs = {k: v[:4] for k, v in pairs[0].items()}
                loftr = LoFTRMatcher({"seed": 0}).matcher
                crops = [torch.stack([torch.from_numpy(
                    im[240 * i:240 * (i + 1), :320] / 255.0).float()
                    for i in range(4)]) for im in (img0, img1)]
                cells = torch.ones((4, 30 * 40), dtype=torch.bool)
                with torch.inference_mode():
                    c0, c1, *_ = loftr.coarse_features(*crops, cells, cells)
                return cs.sharded_path(
                    dev, reset, read, img0, img1, tile_pairs,
                    [(loftr.net.coarse, c0, c1, cells, cells)],
                    n_tokens=cs.SEASON_KEYPOINTS)
            phases.append(("20", sharded))
        if "21" in want:
            def commands():
                # the matcher benchmark builds LightGlue with its default
                # bf16 trunk, whose matmuls the CPU runs ~100x slower
                # than f32
                lg_init = matchers.LightGlueMatcher.__init__

                def lg_f32(self, opt=None, *a, **k):
                    lg_init(self, dict({"activation_dtype": "float32"},
                                       **(opt or {})), *a, **k)

                matchers.LightGlueMatcher.__init__ = lg_f32
                return cs.commands_path(dev, reset, read, scene, cfg,
                                        season_out[-1], tmp, img0, img1)
            phases.append(("21", commands))
        for name, run in phases:
            t0 = time.perf_counter()
            try:
                run()
                cs.log(f"phase {name}: every gate held")
            except AssertionError as e:
                cs.log(f"phase {name}: gate failed at this size: {e}")
            cs.log(f"phase {name}: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
