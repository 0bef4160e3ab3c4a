#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (icepy4d_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run (traceback, non-zero exit) when
anything in it fails:

1. card: a CUDA device must be present; prints nvidia-smi's name and
   power limit;
2. build: compiles every kernel in icepy4d_tpu_torch/csrc with nvcc, one
   process per source, all at once;
3. kernel vs plain: each kernel against its plain PyTorch version, at
   small odd shapes and at the main path's shapes (NMS bitwise equal,
   also at heights and widths around its tile sides and its 32-pixel
   mask words, at widths that are no multiple of 4, at every radius
   from 1 to 4, with the pre-pad extent below the map's, and on maps
   with negative scores, of one value and of zeros;
   attention within 2e-3 of the plain bf16 version, relative to the
   output's largest magnitude, also at key and query counts around its
   128-wide tiles, with padding masks, a run of fully masked tiles and
   strided head views; the disparity sweep at (67, 45) with window 5,
   (161, 203) over [-12, 12] and over [-20, -4], at sizes off its tile
   and at every window it is built for: cost within
   1e-5 and inbounds equal on every pixel, disparity and uniqueness
   within 5e-3 on every pixel that is not a near tie, i.e. whose best
   and runner-up plain costs are more than 1e-5 apart, and disparity on
   >= 99.99% of all pixels); attention also at the adaptive LightGlue's
   packed capacities, B = the tile-pair batch, (Nq, Nk) in
   {64, ..., 2048}^2 with padding masks and head views, where a shape
   over 2e-3 passes only if the kernel is as close to the plain f32
   version as the plain bf16 one is (see check_attention); the
   dual-softmax coarse match at LoFTR's tile-pair batch (2, 30000,
   30000, d 256, every cell valid) and at ragged sizes with masks and
   wholly masked rows and columns: bj and bi equal wherever the best two
   plain confidences are no near tie (1e-4 of the best apart) and on
   every wholly masked row, bv within 1e-4 relative
   (see check_dual_softmax);
4. matcher path: LightGlueMatcher.match on a synthetic 6012x4008 pair
   with a known 8-px shift, 2x2 EXHAUSTIVE tiles, 4096 keypoints per
   tile, bundled weights, PYDEGENSAC; run cold, then warm with every
   launch count set to 0, and checked against the ground-truth shift;
   one NMS launch per extraction chunk, and the NMS kernel once more
   against its plain version on the run's own SuperPoint heat map;
5. LightGlue on the matcher path's tile-pair batch, with the attention
   kernel and with the plain bf16 attention: >= 98% of the match
   decisions agree with an f32 trunk, and with the matcher's bf16 trunk
   they agree as well as two plain versions do (see the phase);
6. dense path: PlaneSweepStereo at the pipeline's settings (128 planes,
   window 7, downscale 1, cost 0.4, uniqueness 0.99, left-right check
   at tau 2) on a synthetic 6012x4008 pair of a textured plane at
   Z = 200 seen by f = 6000 px cameras 10 m apart, the second yawed by
   1 degree and rolled by 0.5; run cold, then warm with every launch
   count set to 0: exactly 2 sweep launches, >= half of the inner
   pixels valid, median |depth - 200| / 200 < 0.5%, the point cloud's
   median |Z - 200| < 1 m, and the cloud written as PLY and read back;
   then the sweep kernel against its plain version on the run's
   rectified 4008x6012 pair, 128 hypotheses, both directions (the
   phase-3 rule);
7. season path: a synthetic 3-epoch season of 6012x4008 frames
   (tests/torch_port_inputs.py::StereoSeason, rendered on the card:
   three textured faces 79-100 m away, two f = 6000 px cameras 4 m
   apart, five surveyed targets on stable faces, mtime timestamps)
   through the port's Pipeline(cfg).run() with bundled weights, 2x2
   EXHAUSTIVE tiles with 200 px overlap, 4096 keypoints a tile,
   PYDEGENSAC at 1 px, temporal tracking, orientation, AO and BA at the
   pipeline's defaults with the "metashape" intrinsics, and dense
   reconstruction at the pipeline's defaults; every epoch ok with no
   recovery and within SEASON_GATES (BA RMSE <= 0.15 px, >= 4500 tie
   points, relative rotation within 0.01 degrees of the truth, median
   distance of the georeferenced points to the true faces <= 0.025 m,
   median displacement of the tracks on the stable faces <= 1 px, >=
   11.5 M dense points whose median distance to the true faces is <=
   0.15 m), both CSV sinks,
   three checkpoints and a dense PLY an epoch. Launches an epoch: phase
   4's NMS launches (the tracking reads the pair match's cached
   features and extracts nothing), phase 4's attention launches, plus on
   epochs 1 and 2 one seeded forward's (both cameras' 2 x 4 tile pairs
   ride one LightGlue forward: 4 launches a layer, 9 layers, one chunk
   of 8 pairs at 4096 keypoints, so 36 more), and 2 sweep launches;
   prints the cold and warm epoch times by stage;
8. SIFT season: the same frames through Pipeline(cfg).run() with the
   real-season matcher settings of bench.py (SIFT, quality high, no
   tiles, 16384 keypoints, one orientation, PYDEGENSAC at 2 px), the
   GCP prior from the surveyed centres (so the guided rematch runs on
   it), tracking on, the "metashape" BA trimmed toward 0.5 px; every
   epoch ok with no recovery, within SIFT_GATES (BA RMSE <= 0.25 px,
   >= 5000 putatives and verified matches, >= 12000 tie points,
   relative rotation within 0.075 degrees, median distance to the faces
   <= 0.15 m), and no kernel launch at all (SIFT and the
   nearest-neighbour matcher run none of the three);
9. times: each kernel, its plain version, the library call that
   computes the same function (where there is one) and the card's lower
   bound, printed as one JSON line;
10. adaptive matcher: phase 4's pair through LightGlueMatcher with
   `adaptive` at the default confidences (early exit and pruning as
   the bundled weights decide), then with every token-confidence head
   forced to sigmoid(10), once at the default depth confidence (it
   exits after the first segment) and once with the exit off and a
   width confidence that prunes both sides of every tile pair to at
   most half; each run >= 90% of the inliers within 1.5 px of the
   shift, and attention launches = 4 x the layers each pair chunk ran;
   the kernel against the plain bf16 attention on a pruned segment's
   own q, k, v and mask (the phase-3 rule); the kernel, the plain
   version, SDPA and the bound at two pruned shapes;
11. n-camera season: a 3-camera, 3-epoch synthetic season at 6012x4008
   (StereoSeason with n_cameras=3, rendered on the card) through
   Pipeline(cfg).run() with phase 7's matcher settings, tracking, space
   resection, the "metashape" BA block and homography warping on (the
   n-camera path, as in the JAX package, runs neither the resection
   nor the BA block's intrinsics); every epoch ok, within MULTICAM_GATES
   (BA RMSE, tie points, each slave's rotation relative to the master,
   distance to the faces), exact NMS and attention launches an epoch
   (derived below), one warped image an epoch and the reference epoch's
   warp near identity; epoch 0's BA problem solved again with
   BundleAdjustment(compute_covariance=True) and its covariances held
   against the same function run in float64 on the card (relative
   Frobenius error <= 1e-2 on every point, symmetric, positive
   definite); the cold and warm epoch times by stage;
12. PnP, MAGSAC, space resection in the season, the match writer:
   SpaceResection on 12 noise-free GCPs 40-60 m away, 3 of them gross
   outliers (the 3 rejected by the PnP RANSAC, the pose within 0.01
   degrees and 0.01 m of the truth); MAGSAC on phase 4's putatives
   (>= 90% of the inliers within 1.5 px of the shift); phase 7's frames
   through a 2-epoch stereo Pipeline with do_space_resection and
   other.do_viz: resection_targets_<cam> for both cameras, each
   resected centre within 1 mm of its surveyed centre (the known-centre
   branch pins it), matches.png and both keypoint files an epoch.

13. SuperGlue path: SuperGlueMatcher.match on phase 4's pair with
   phase 4's call (2x2 EXHAUSTIVE tiles, 200 px overlap, 4096 keypoints
   a tile, PYDEGENSAC), the JAX package's defaults (SuperPoint at NMS
   radius 3, keypoint threshold 0.001; 18 layers, d 256, 4 heads, 20
   Sinkhorn iterations, match threshold 0.3), bundled SuperPoint,
   random SuperGlue weights from seed 0; cold, then warm; launches
   exactly phase 4's NMS count and 36 attention launches (18 layers x
   2) per pair chunk; the NMS kernel bit for bit against its plain
   version on the run's own heat map at r = 3, the attention kernel
   against the plain bf16 version on the first layer's own f32 q, k, v
   and mask (the phase-3 rule); the forward on the run's tile-pair
   batch with the kernel and with the plain bf16 attention: the
   log-assignment row argmax agrees on >= 98% of the valid rows, the
   match decisions as well as two plain versions do (phase 5's
   yardstick; random weights make the shift meaningless); the kernel,
   the plain bf16 version, SDPA and the bound at SuperGlue's attention
   shape (f32 in, head-major views), and the NMS kernel at r = 3;
14. DISK and ALIKED: phase 4's pair and call through
   NearestNeighborMatcher over ALIKED (bundled weights; >= 50% of the
   inliers within 1.5 px of the shift, the floor
   tests/test_trained_aliked.py sets for this checkpoint), over DISK
   (random weights; precision and counts printed), and LightGlueMatcher
   over ALIKED (input dim 128, random LightGlue weights): no NMS launch
   (both detectors pool in plain PyTorch, as in the JAX package) and
   exactly 36 attention launches per pair chunk;
15. semi-dense and LoFTR: SemiDenseMatcher (bundled SuperPoint, 8-px
   tokens, OC refinement, which runs on full-frame matches) on the
   centre SEMIDENSE_CROP of phase 4's pair (the whole frame would be
   376k tokens): >= 90% of the inliers within 1.5 px of the shift, the
   refined share printed; LoFTRMatcher at the published architecture
   with random weights (confidence threshold 1e-8) on the finest n x n
   GRID whose tiles stay under MAX_COARSE_TOKENS (tile sizes from
   compute_tile_limits); neither launches the NMS, attention or sweep
   kernel, and the warm LoFTR match launches the dual-softmax kernel
   once a forward (LoFTRMatcher.counters["forwards"]); LoFTR's coarse
   confidences and match sets on the card against the same weights on
   the card's CPU on a LOFTR_CROP crop (f32, no TF32): confidences
   within 5e-4 of the largest, match sets Jaccard >= 0.99, common fine
   keypoints within 3e-4 px (10x the first H100 run's differences), the
   card's forward one dual-softmax launch, and the kernel's best matches
   on the card's coarse features against the same confidences in f64:
   the phase-3 rule, bv within the larger of 1e-4 and the plain f32
   version's own error (random weights give scores of ~85, which f32
   rounds at ~1e-4 of bv; see hold_best_matches);
16. season tools: Pipeline.warmup() then run() on phase 7's frames, two
   epochs with tracking (warmup's launches printed; the epochs'
   launches exactly phase 4's, plus one seeded forward on epoch 1),
   and watch(poll_interval=0, stop_after=2) on the same frames: every
   epoch ok without recovery, BA RMSE within SEASON_GATES, the same
   epochs; the first epoch's time after warmup and phase 7's first
   epoch (no warmup) printed; the native EXIF scanner, built with g++
   on this machine, against the Python reader on JPEGs whose EXIF
   block the script writes byte by byte;
17. products: the 4D products on phase 7's full-size outputs (its three
   dense clouds of 14.6-14.7 M points, the frames, the target tables
   and the Epoches that Pipeline.run() returned), each step run cold
   then warm with its time printed beside the card's name and power
   limit: DEMs of difference of consecutive clouds along y at 0.1 m
   (|mean dz| and net volume a m^2, the median dz and the matching share
   gated), the first DoD's DSM against the true depth of the seen face
   on cells 1 m from any face or occlusion edge, orthophotos of both
   frames of epoch 0 on a z-up DSM in a local frame (a Rototranslation
   x' = X, y' = Z, z' = -Y) whose NCC on the stable faces is gated,
   voxels at 0.25 m and binned statistics at 0.5 m whose counts equal
   the in-bounds points exactly, geometric features and detect_border
   (k = 32) on a PRODUCTS_CROP polyline crop of ~300 k points (median
   planarity and verticality on its faces gated; the card's kNN equal
   to the CPU's on a 20 k subset wherever the k-th and (k+1)-th squared
   distances are more than 8 float32 steps apart), Poisson at depth 8
   on the centres of the voxels holding a face (median vertex distance
   to the faces within a voxel), TrackTargets from epoch 0's first
   frame into epochs 1 and 2 at PRODUCTS_TARGETS (every target within
   0.2 px of the pixel its template sits on; the defaults' SNRs are
   printed), the tracked points' time series (median displacement of
   the stable faces' tracks gated, the tongue's printed), and epoch 0's
   COLMAP binary model and database, Bundler .out and CALGE files read
   back equal. PRODUCT_GATES holds the gates. Products launch no kernel:
   the counts are set to 0 before the phase and must be 0 after it. It
   needs pandas, not matplotlib, h5py or rasterio: the plots, the h5
   export and the GeoTIFF are not run on the card.

18. training, on phase 7's frames (the real-patch pool) and epochs:
   (a) one train step of each trainer at full width with batch 2
   (SuperPoint 120x160, LightGlue 9 layers at 512 keypoints, ALIKED
   240x320, bundled weights) on the card and on the CPU from the same
   state and batch, in f32 without TF32: losses within 1e-4 relative,
   every gradient tensor within 1e-3 of its largest magnitude (ALIKED's
   peaks, supervision anchors, are the card's in both runs; the share
   of the CPU's own peaks that equal them is printed); (b)
   train_superpoint at its published width and defaults (batch 32,
   120x160, lr 1e-3) from a fresh init, 32 cached batches, 300 steps:
   the last 50-step chunk's mean loss below the first's, the warm
   ms/step printed; (c) homographic adaptation of 8 patches with 24
   warps by the bundled SuperPoint (some pseudo-label found); (d) make_lightglue_dataset with the bundled SuperPoint, 8
   batches of 16 pairs at 240x320 (exactly 4 NMS launches), LightGlue
   from the bundled checkpoint trained 200 steps on 6 of them (9 layers,
   256-d, 4 heads) and evaluated on the other 2 before and after
   (exactly 36 attention launches a batch and evaluation): the trained
   recall not below the loaded one's by more than 0.05; (e)
   collect_epoch_pairs on phase 7's results at scale 0.25 (3 pairs,
   exactly 2 NMS launches a pair), make_correspondence_dataset (4
   batches) mixed with homography_to_explicit of (d)'s 6, 100
   explicit-GT steps; (f) train_aliked at its defaults from the bundled
   checkpoint, 100 steps; (g) each trained model through save_params and
   load_params bit for bit, and the reloaded SuperPoint's extract equal
   to the trained one's bit for bit (2 NMS launches). Timed training
   runs as the port's inference does: f32 storage, cuDNN convolutions
   in TF32, matmuls in f32 (this script turns matmul TF32 off).

19. batched, multi-process and staged seasons, on phase 7's frames:
   (a) Pipeline.run_batched(mesh=make_mesh(2)) with phase 7's matcher
   settings (bundled weights, SEASON_KEYPOINTS, matched full frame and
   untiled, as run_batched does), groups {0, 1} and {2, 2 repeated},
   cold and then warm with every launch count set to 0 before it: every
   epoch ok within BATCHED_GATES, track ids equal across the cameras and
   unique across the epochs, the NMS and attention launches exactly
   batched_expected's (one NMS launch an extraction chunk of each side,
   4 attention launches a layer for each group's one forward), the warm
   epochs/min printed beside phase 7's warm run(); (b) the same call
   with SIFT_MATCHING, SIFT_BA and the guided round on the GCP prior:
   every epoch within BATCHED_SIFT_GATES and no kernel launch; (c)
   run_distributed() on one process with phase 7's settings (tracking
   on, dense and checkpoints off, which change no count): statuses,
   SEASON_COUNTS and track ids equal to phase 7's run(); (d)
   StagedPipeline(devices=[cuda, cuda]), SuperPoint extraction on one
   stream and LightGlue on another, over 4 batches of 4 of phase 4's
   16 tile pairs: outputs bit for bit those of sequential calls, the
   staged and sequential wall times printed (cold and warm).

20. ring attention and the sequence- and pipeline-parallel matchers
   (`parallel/`), at the published widths, the sequence axis four slots
   of the card (make_mesh(4, dp=1, tp=4, axis_names=("data", "seq"))):
   (a) make_ring_attention at (1, 4, 16384, 64) f32 against
   ops/attention.py::dense_attention (TF32 off), once with a 0.9
   padding mask and a whole ring block of keys masked, once with every
   key masked (every query row fully masked: uniform averages), each
   within 1.5e-5 of the largest output magnitude, and no attention-kernel
   launch; (b) phase 4's pair untiled through LightGlueMatcher at 16384
   keypoints (both full frames, f32 trunk, bundled weights), then
   make_sequence_parallel_lightglue on those tokens against the dense
   LightGlue.match over dense_attention (matches0 and matches1 >= 99%
   of the valid slots equal, mscores within rtol 1e-3 / atol 1e-5 where
   both match) and over the kernel (>= 98.8%; phase 5's yardstick is
   98%), and >= 90% of its mutual matches within 1.5 px of the shift; (c)
   make_sequence_parallel_superglue (SuperGlueMatcher's SuperGlue: 18
   layers, 20 Sinkhorn iterations, random weights from seed 0, match
   threshold 0) on the same tokens against the dense SuperGlue.match
   over dense_attention, (b)'s bars; (d)
   make_pipeline_parallel_lightglue, 3 stages of 3 layers, on 4 of
   phase 4's tile pairs at 4096 keypoints in 4 microbatches: exactly
   144 attention launches a forward (4 x 9 layers x 4 microbatches),
   >= 99.9% of the match decisions and the log assignment within 1e-3
   on its valid entries against the dense forward on the same batch;
   (e) make_pipeline_parallel_loftr_coarse, 4 stages of one pair, on
   phase 15's first coarse tokens (its first pair chunks, cut to a
   multiple of 4 tile pairs) against the batched lft_apply, within 4e-5
   and no kernel launch. Each forward runs cold, then warm, with its
   warm seconds and peak torch.cuda.max_memory_allocated printed beside
   the card's name and power limit. SHARDED_GATES holds the gates.
21. command lines, on phase 7's frames and clouds and phase 4's pair:
   (a) `python -m icepy4d_tpu_torch run_pipeline cfg.yaml` as a
   subprocess, phase 7's config (tracking, dense) written as YAML over
   CLI_EPOCHS epochs: exit 0, "processed 2 epochs", and its checkpoints
   and sinks meet SEASON_GATES (every epoch ok without recovery, BA
   RMSE, relative rotation, distance to the faces, tie points, dense
   clouds; a checkpoint, a dense PLY and a sink row an epoch); (b)
   run_pipeline.main in-process on the same config with the counts set
   to 0 before: NMS, attention and sweep launches exactly phase 7's for
   those epochs, and the same gates; (c) build_dem, update_dem,
   volume_variations, voxelization (with --mesh), extract_section,
   pcd_rototranslation (both ways) and track_targets in-process on two
   of phase 17's clouds cut to PRODUCTS_CROP (z-up) and on phase 7's
   frames, each equal to the library call it wraps on the same input
   (atomically scattered float32 sums within 8 float32 steps;
   plot_sections and dynamic_visualization need matplotlib, which this
   script does not need); (d) the single-epoch walkthrough on phase 7's
   epoch-0 frames in the asset layout (WALKTHROUGH_GATES) and the
   matcher benchmark on a SEMIDENSE_CROP centre crop of phase 4's pair
   (NN's and LightGlue's inliers on the shift; WALKTHROUGH_GATES). Each
   time is printed beside the card's name and power limit, and the
   phase's seconds.

Phase 10 runs after phase 5 on its pair and phases 13-15 after it,
phase 20 after those, phase 12 after phase 8 on phase 7's frames, phase
16 after it, phase 19 after it, phase 17 after it on phase 7's outputs,
phase 21 after it, phase 18 after it, and phase 11 after those, all
before the timing of phase 9; their results are in the same JSON line.
The kernels line's launches are those of the matcher paths of phases
4, 13 and 14, of phase 20 ((b)'s untiled match and dense forward over
the kernel, (d)'s pipeline), of phase 18, of phase 19 (a)'s warm run
and of phase 21 (b)'s season (the sweep's of phase 6 and phase 21 (b);
the dual softmax's of phase 15's warm LoFTR match and its crop).

The last line of standard output is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
DX, DY = 16, 8                 # ground-truth shift of the matcher's pair
H_IMG, W_IMG = 4008, 6012      # the pairs' full size
PLANE_Z = 200.0                # depth of the dense pair's plane, m
SEASON_F = 6000.0              # focal of the season's cameras, px
SEASON_BASELINE = 4.0          # m: disparities of 240-304 px, < 10% of a tile
SEASON_CELL_PX = 24.0          # texture cell, px: 10-px cells left
                               # DEGENSAC's consensus unstable at 6012 px
SEASON_KEYPOINTS = 4096        # keypoints a tile on the season path
# Gates of every season epoch, each about 3x (20% for the points) off
# what two H100 runs of this season read: BA rmse 0.044-0.052 px,
# 5540-5655 tie points, relative rotation 0.0022-0.0028 degrees off the
# truth, median distance to the true faces 3-8 mm.
# With tracking and dense on, three H100 runs read: tracks on the stable
# faces 0.0 px off, a dense cloud of 14.62-14.75 M points 5.2-5.7 cm
# from the faces; the tracks gate is the 1 px bar of the real season.
SEASON_GATES = {"rmse_px": 0.15, "points": 4500, "rotation_deg": 0.01,
                "surface_m": 0.025, "track_px": 1.0,
                "dense_points": 11_500_000, "dense_surface_m": 0.15}
# Gates of every SIFT season epoch, about 3x (20% for the points) off
# what the first H100 run read: BA rmse 0.076-0.081 px, 14962-14968
# putatives, 14958-14967 verified, 14940-31118 tie points, relative
# rotation 0.0029-0.0249 degrees off, 6-47 mm to the faces. They sit
# well inside the parity bar (0.5 px, BASELINE.md) and bench.py's floor
# (100 putatives, 50 verified).
SIFT_GATES = {"rmse_px": 0.25, "putative": 5000, "verified": 5000,
              "points": 12000, "rotation_deg": 0.075, "surface_m": 0.15}
# Gates of every epoch of phase 19's batched seasons, about 3x (20% for
# the points) off what the first H100 run read. run_batched matches one
# untiled frame of SEASON_KEYPOINTS keypoints, not phase 7's 2x2 tiles of
# 4096 each, and keeps the matches that one 128-hypothesis essential
# RANSAC takes, without verification, tracking or recovery: 2449-2488
# tie points (SEASON_GATES asks 4500), BA rmse 0.028-0.039 px, relative
# rotation 0.0021-0.0153 degrees off (SEASON_GATES: 0.01) and 9.5-43 mm
# to the faces (0.025 m). The SIFT step (512 hypotheses, the guided round
# on the GCP prior) read 14932-14948 tie points, BA rmse 0.081-0.085 px,
# 0.0027-0.0147 degrees, 5-28 mm: SIFT_GATES' points and rmse hold, its
# rotation and distance gates tighten to 3x the reading.
BATCHED_GATES = {"rmse_px": 0.12, "points": 1950, "rotation_deg": 0.045,
                 "surface_m": 0.13}
BATCHED_SIFT_GATES = {"rmse_px": 0.25, "points": 12000, "rotation_deg": 0.045,
                      "surface_m": 0.085}
# Gates of every n-camera season epoch (phase 11), about 3x (20% for the
# points) off what the first H100 run read: BA rmse 0.053-0.078 px,
# 7621-7782 tie points, the worst slave's rotation relative to the
# master 0.0009-0.0033 degrees off the truth, 2-10 mm to the faces.
MULTICAM_GATES = {"rmse_px": 0.25, "points": 6000, "rotation_deg": 0.01,
                  "surface_m": 0.03}
SIFT_MATCHING = {"matcher": "sift", "quality": "high",
                 "tile_selection": "none", "max_keypoints": 16384,
                 "options": {"dual_orientation": False}}
SIFT_BA = {"camera_location_accuracy": 0.5, "fit_f": True,
           "free_intrinsics": "metashape", "trim_target_rmse_px": 0.5,
           "trim_frac": 0.1, "trim_rounds": 6, "max_iters": 60,
           "min_points": 8}
TIE = 1e-5                     # runner-up minus best cost of a near tie
# f32 operations per pixel and hypothesis of the disparity sweep, each
# box filter counted as separable running sums: the shift's lerp 3, the
# products I1s^2 and I0*I1s 2, three box filters (2 passes x 2 adds) 12
# and their scaling 3, variance and covariance 4, the ZNCC (v0*v1, max,
# sqrt, divide, clip, 1 -) 7, the out-of-bounds fill 1, the streaming
# argmin update 20
SWEEP_OPS = 3 + 2 + 12 + 3 + 4 + 7 + 1 + 20
MEM_BPS = 3.35e12              # H100 SXM device memory rate, bytes/s
DSMAX_T = 0.1                  # LoFTR's dual-softmax temperature
DSMAX_SHAPE = (2, 30000, 30000)  # LoFTR's tile-pair batch: 2 tile pairs of
                               # 1600 x 1200 px, 30000 coarse tokens each
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core rate
F32_FLOPS = 67e12              # H100 SXM f32 rate outside the tensor cores


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def lower_bound(n_bytes: float, n_ops: float, ops_rate: float):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    operations over their peak rate."""
    t_bytes, t_ops = n_bytes / MEM_BPS, n_ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of one call, from CUDA events over `reps` calls
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def plane_pair(seed: int = 7):
    """Cameras and uint8 images of phase 6: a fronto-parallel plane at
    Z = PLANE_Z textured with band-limited noise (0.04 m texels, 8
    texels per noise cell, about 10 px in the images), camera 0 at the
    origin, camera 1 centred at (10, 0, 0) and turned by yaw and roll."""
    import cv2
    from icepy4d_tpu_torch.core import Camera

    f = 6000.0
    K = np.array([[f, 0, W_IMG / 2], [0, f, H_IMG / 2], [0, 0, 1]],
                 np.float32)
    yaw, roll = np.deg2rad(1.0), np.deg2rad(0.5)
    Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                   [-np.sin(yaw), 0, np.cos(yaw)]])
    Rz = np.array([[np.cos(roll), -np.sin(roll), 0],
                   [np.sin(roll), np.cos(roll), 0], [0, 0, 1]])
    E0 = np.eye(4, dtype=np.float32)
    E1 = np.eye(4, dtype=np.float32)
    E1[:3, :3] = Rz @ Ry
    E1[:3, 3] = -E1[:3, :3] @ np.array([10.0, 0.0, 0.0], np.float32)
    x0, y0, res = -120.0, -80.0, 0.04           # texture origin, m per texel
    rng = np.random.default_rng(seed)
    tw, th = int(260 / res), int(160 / res)
    lo = rng.uniform(size=(th // 8 + 1, tw // 8 + 1)).astype(np.float32)
    tex = cv2.resize(lo, (tw, th), interpolation=cv2.INTER_CUBIC)
    ys, xs = np.mgrid[0:H_IMG, 0:W_IMG].astype(np.float32)

    def render(E):
        R = E[:3, :3]
        C = -R.T @ E[:3, 3]
        rays = [((xs - K[0, 2]) / f), ((ys - K[1, 2]) / f)]
        world = [rays[0] * R[0, j] + rays[1] * R[1, j] + R[2, j]
                 for j in range(3)]                     # R^T @ ray
        s = (PLANE_Z - C[2]) / world[2]
        u = (C[0] + s * world[0] - x0) / res
        v = (C[1] + s * world[1] - y0) / res
        img = cv2.remap(tex, u.astype(np.float32), v.astype(np.float32),
                        cv2.INTER_LINEAR)
        return np.clip(img * 255, 0, 255).astype(np.uint8)

    cams = [Camera.create(width=W_IMG, height=H_IMG, K=K, extrinsics=E)
            for E in (E0, E1)]
    return cams, [render(E0), render(E1)]


def shifted_pair(seed: int = 21):
    """Band-limited texture (8 px per noise cell) and its (DX, DY)-shifted
    copy: img0[y, x] == img1[y - DY, x - DX]."""
    import cv2

    rng = np.random.default_rng(seed)
    lo = rng.uniform(size=((H_IMG + DY) // 8, (W_IMG + DX) // 8))
    base = cv2.resize(lo.astype(np.float32), (W_IMG + DX, H_IMG + DY),
                      interpolation=cv2.INTER_CUBIC)
    base = np.clip(base * 255, 0, 255).astype(np.uint8)
    return base[:H_IMG, :W_IMG], base[DY:, DX:]


def heat_map(shape, dev, seed=0) -> torch.Tensor:
    """Random scores with plateaus of exact ties."""
    g = torch.Generator(device=dev).manual_seed(seed)
    heat = torch.rand(shape, generator=g, device=dev)
    heat[:, 10:30, 40:90] = 0.25
    return heat


def attention_inputs(b, h, nq, nk, dev, seed=0, p_keep=0.9):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, h, n, 64), generator=g, device=dev)
               for n in (nq, nk, nk))
    mask = torch.rand((b, nk), generator=g, device=dev) < p_keep
    return q, k, v, mask


def nms_map(shape, dev, kind: str, seed=0) -> torch.Tensor:
    """Scores of one kind: `ties` random in [0, 1) with a plateau;
    `negative` random in [-1, 1) with plateaus of 0.0, -0.0 and -0.5
    and denormals of both signs; `equal` 0.3 everywhere; `zero`."""
    if kind == "equal":
        return torch.full(shape, 0.3, device=dev)
    if kind == "zero":
        return torch.zeros(shape, device=dev)
    heat = heat_map(shape, dev, seed)
    if kind == "negative":
        heat = heat * 2 - 1
        heat[:, 30:50, 5:40] = 0.0
        heat[:, 5:9, 50:70] = -0.5
        heat[:, 20:24, 100:140] = -0.0
        heat[:, 60:64, 10:14] = 1e-42
        heat[:, 64:66, 10:14] = -1e-42
    return heat


def nms_cases(nms) -> list:
    """(shape, radius, (h0, w0) deficit, kind of map) of phase 3's NMS
    checks, B = 3: heights and widths of 1, one less than, equal to, one
    more than and 2 x + 5 the tile's sides, for every radius from 1 to 4
    (all pairs at the main path's radius 4, the diagonal elsewhere);
    widths around the 32-pixel mask words; each kind of map."""
    cases = []
    for r in (4, 3, 2, 1):
        th, tw = nms.tile_shape(r)
        hs = (1, th - 1, th, th + 1, 2 * th + 5)
        ws = (1, tw - 1, tw, tw + 1, 2 * tw + 5)
        sizes = [(h, w) for h in hs for w in ws] if r == 4 else zip(hs, ws)
        for i, (h, w) in enumerate(sizes):
            pad = (5, 3) if i % 2 and h > 5 and w > 3 else (0, 0)
            cases.append(((3, h, w), r, pad, "ties"))
    for w in (31, 32, 33, 63, 65, 95, 97, 127, 129, 191, 193, 517):
        cases.append(((3, 77, w), 4, (0, 0), "ties"))
        cases.append(((3, 70, w), 2, (2, 1), "negative"))
    for kind in ("negative", "equal", "zero"):
        for r in (1, 2, 3, 4):
            cases.append(((3, 301, 517), r, (5, 3), kind))
            cases.append(((3, 40, 170), r, (0, 0), kind))
    return cases


def check_nms(nms, heat, r, pad, label) -> float:
    """NMS kernel vs plain on a CUDA map, bit for bit (the sign of a
    zero included); the pre-pad extent is the map's less `pad`."""
    h0, w0 = heat.shape[1] - pad[0], heat.shape[2] - pad[1]
    got = nms.fused_nms_border(heat, r, 4, h0, w0)
    ref = nms.nms_border_plain(heat, r, 4, h0, w0)
    torch.cuda.synchronize()
    differ = got.view(torch.int32) != ref.view(torch.int32)
    if differ.any().item():
        raise AssertionError(
            f"NMS kernel != plain at {tuple(heat.shape)} r={r} pad={pad} "
            f"{label}: {differ.sum().item()} pixels differ")
    return 0.0


def attention_mask(mode: str, b: int, nk: int, dev) -> torch.Tensor:
    """prefix: each batch row keeps its first 1..nk keys (padding after);
    middle: keys nk/4 .. 3nk/4 masked, a run of whole tiles at nk >= 512."""
    if mode == "prefix":
        g = torch.Generator(device=dev).manual_seed(nk)
        n_valid = torch.randint(1, nk + 1, (b, 1), generator=g, device=dev)
        return torch.arange(nk, device=dev)[None] < n_valid
    mask = torch.ones((b, nk), dtype=torch.bool, device=dev)
    mask[:, nk // 4: 3 * nk // 4] = False
    return mask


def check_attention(attention, dev, b, h, nq, nk, mode="rand",
                    head_views=False, yardstick=False) -> float:
    """Attention kernel vs plain bf16 on f32 inputs; the last batch row
    is fully masked. `head_views` passes q, k, v as (B, H, N, hd) views
    of (B, N, H, hd) storage, as LightGlue's blocks do.

    With `yardstick`, a shape whose kernel-vs-plain error exceeds 2e-3
    still passes when the kernel is as close to the plain f32 version
    as the plain bf16 one is (within 1e-4 of the output's largest
    magnitude): the two bf16 versions sum q.k in other orders, so a
    probability that lies on a bf16 rounding boundary rounds apart in
    them, by 2^-8 of itself; in a row of a few valid keys that moves
    the output by up to 3e-3 of its largest magnitude, in either
    (tests/test_torch_attention.py::
    test_kernel_as_far_from_f32_as_plain_bf16 holds this on the inputs
    of the four adaptive shapes that need it)."""
    q, k, v, mask = attention_inputs(b, h, nq, nk, dev)
    if mode != "rand":
        mask = attention_mask(mode, b, nk, dev)
    mask[-1] = False                             # one fully masked row
    if head_views:
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (q, k, v))
    got = attention.masked_attention(q, k, v, mask)
    ref = attention.attention_plain(q, k, v, mask,
                                    operand_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    if torch.count_nonzero(got[-1]).item() != 0:
        raise AssertionError("fully masked row did not give zeros")
    if not torch.isfinite(got).all().item():
        raise AssertionError("attention output is not finite")
    scale = ref[:-1].abs().max().item()
    err = (got[:-1] - ref[:-1]).abs().max().item()
    rel = err / scale
    note = ""
    ok = rel <= 2e-3
    if yardstick and not ok:
        ref32 = attention.attention_plain(q, k, v, mask)
        to32 = (got[:-1] - ref32[:-1]).abs().max().item() / scale
        plain_to32 = (ref[:-1] - ref32[:-1]).abs().max().item() / scale
        ok = to32 <= plain_to32 + 1e-4
        note = (f"; to plain f32: kernel {to32:.3e}, plain bf16 "
                f"{plain_to32:.3e}")
    log(f"  attention B={b} H={h} Nq={nq} Nk={nk} {mode}"
        f"{' head views' if head_views else ''}: max abs err {err:.3e}, "
        f"relative {rel:.3e}{note}")
    if not ok:
        raise AssertionError(f"attention kernel vs plain bf16: {rel}{note}")
    return err


def dual_softmax_inputs(b, l0, l1, dev, seed=0, p_keep=1.0, dead=False):
    """c0 (b, l0, 256) and c1 (b, l1, 256) f32 unit normal, a third of
    c1's rows noisy copies of c0's (clear best matches, as trained
    features give), and cell masks keeping `p_keep`; with `dead`, tile
    pair 1 has every column masked and tile pair 2 every row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    c0 = torch.randn(b, l0, 256, generator=g, device=dev)
    c1 = torch.randn(b, l1, 256, generator=g, device=dev)
    n = min(l0, l1) // 3
    src = torch.randperm(l0, generator=g, device=dev)[:n]
    dst = torch.randperm(l1, generator=g, device=dev)[:n]
    c1[:, dst] = c0[:, src] + 0.3 * torch.randn(b, n, 256, generator=g,
                                                device=dev)
    m0 = torch.rand(b, l0, generator=g, device=dev) < p_keep
    m1 = torch.rand(b, l1, generator=g, device=dev) < p_keep
    if dead and b > 1:
        m1[1] = False
    if dead and b > 2:
        m0[2] = False
    return c0, c1, m0, m1


def no_near_tie(conf: torch.Tensor, dim: int, rtol: float = 1e-4):
    """Rows (dim 2) or columns (dim 1) of confidences whose best is
    normal and exceeds the runner-up by more than rtol of it."""
    if conf.shape[dim] < 2:
        return conf.amax(dim) > 1e-30
    top = conf.topk(2, dim=dim).values
    a, b = top.select(dim, 0), top.select(dim, 1)
    return (a > 1e-30) & (a - b > rtol * a)


def hold_best_matches(got: tuple, conf: torch.Tensor, m0, m1,
                      label: str, conf64: torch.Tensor | None = None) -> dict:
    """The kernel's (bj, bv, bi) against the plain confidences conf:
    bj and bi equal off near ties and on wholly masked rows, bv within
    1e-4 relative (each side rounds scores of ~10 at ~1e-6, and bv is
    the exponential of a sum of three of them). Where scores are far
    larger (LoFTR's random-weight features: ~85), the plain f32 version
    itself strays ~1e-4 from the exact bv; given the same confidences
    in f64 (`conf64`), the kernel is held against those instead, bv
    within the larger of 1e-4 and the plain f32 version's own largest
    relative error. Returns the gaps."""
    from icepy4d_tpu_torch.ops import dual_softmax as ds

    bj, bv, bi = got
    rtol, plain_rel = 1e-4, None
    if conf64 is not None:
        p32 = conf.amax(2).double()
        conf = conf64
    pj, pv, pi = ds.best_of(conf)
    normal = pv > 1e-30
    if conf64 is not None:
        plain_rel = ((p32 - pv).abs()[normal] / pv[normal]).max().item() \
            if normal.any() else 0.0
        rtol = max(rtol, plain_rel)
    rows, cols = no_near_tie(conf, 2), no_near_tie(conf, 1)
    dead = ~m0 | ~m1.any(1, keepdim=True)
    gap = (bv.to(pv.dtype) - pv).abs()
    rel = gap[normal] / pv[normal]
    out = {"bj_off": int((bj != pj)[rows].sum()),
           "bi_off": int((bi != pi)[cols].sum()),
           "dead_rows_off": int((bj != pj)[dead].sum()),
           "rows_clear": rows.float().mean().item(),
           "cols_clear": cols.float().mean().item(),
           "bv_max_abs": gap.max().item(),
           "bv_max_rel": rel.max().item() if normal.any() else 0.0,
           "plain_bv_max_rel": plain_rel,
           "bv_out": int((rel > rtol).sum() + (gap[~normal] > 1e-30).sum())}
    log(f"  dual softmax {label}: {out}")
    if out["bj_off"] or out["bi_off"] or out["dead_rows_off"] \
            or out["bv_out"]:
        raise AssertionError(f"dual softmax {label}: {out}")
    return out


def check_dual_softmax(ds, dev, b, l0, l1, p_keep=1.0, dead=False,
                       seed=0) -> dict:
    """The dual-softmax kernel (one launch) against its plain version
    on `dual_softmax_inputs` (see hold_best_matches)."""
    c0, c1, m0, m1 = dual_softmax_inputs(b, l0, l1, dev, seed, p_keep, dead)
    before = ds.KERNEL.launches
    got = ds.best_matches(c0, c1, m0, m1, DSMAX_T)
    torch.cuda.synchronize()
    if ds.KERNEL.launches != before + 1:
        raise AssertionError("the dual softmax did not launch its kernel")
    conf = ds.confidence_plain(c0, c1, m0, m1, DSMAX_T)
    out = hold_best_matches(got, conf, m0, m1, f"{(b, l0, l1)}")
    del conf
    torch.cuda.empty_cache()
    return out


def check_sweep(dense, I0, I1, lo, hi, n, window, label) -> float:
    """Sweep kernel vs plain on CUDA tensors; returns the largest cost
    error. Cost within 1e-5 and inbounds equal on every pixel; disparity
    and uniqueness within 5e-3 on every pixel that is not a near tie, and
    disparity on at least 99.99% of all pixels."""
    got = dense.disparity_sweep(I0, I1, lo, hi, n_disp=n, window=window)
    ref = dense.disparity_sweep_plain(I0, I1, lo, hi,
                                      dense._pad_bucket(lo, hi),
                                      n_disp=n, window=window)
    tie = dense.runner_up_gap(I0, I1, lo, hi, n_disp=n,
                              window=window) <= TIE
    torch.cuda.synchronize()
    cost_err = (got["cost"] - ref["cost"]).abs().max().item()
    inb_diff = (got["inbounds"] != ref["inbounds"]).sum().item()
    bad = {k: ((got[k] - ref[k]).abs() > 5e-3) for k in ("disparity",
                                                         "uniqueness")}
    off_tie = {k: (v & ~tie).sum().item() for k, v in bad.items()}
    disp_share = 1.0 - bad["disparity"].float().mean().item()
    bitwise = (got["cost"] == ref["cost"]).float().mean().item()
    log(f"  sweep {label} {tuple(I0.shape)} [{lo:.3f}, {hi:.3f}] n={n} "
        f"w={window}: cost max err {cost_err:.3e} (bitwise on "
        f"{bitwise:.6f}), inbounds differ {inb_diff}, near ties "
        f"{tie.float().mean().item():.3e}, off-tie pixels over 5e-3 "
        f"{off_tie}, disparity within 5e-3 on {disp_share:.6f}")
    if not cost_err <= 1e-5 or inb_diff:
        raise AssertionError(f"sweep kernel vs plain: cost {cost_err}, "
                             f"{inb_diff} inbounds differ")
    if any(off_tie.values()) or disp_share < 0.9999:
        raise AssertionError(f"sweep kernel vs plain: {off_tie} off-tie "
                             f"pixels, disparity share {disp_share}")
    return cost_err


def sweep_inputs(dev, h, w, shift, seed=0):
    """Smooth noise and its copy shifted by `shift` px along x."""
    import cv2

    rng = np.random.default_rng(seed)
    lo = rng.uniform(size=(h // 4 + 2, (w + 64) // 4 + 2)).astype(np.float32)
    base = cv2.resize(lo, (w + 64, h), interpolation=cv2.INTER_CUBIC)
    xs = np.arange(w) - shift + 32
    x0 = np.floor(xs).astype(int)
    f = (xs - x0).astype(np.float32)
    I1 = base[:, x0] * (1 - f) + base[:, x0 + 1] * f
    return (torch.from_numpy(np.ascontiguousarray(base[:, 32:32 + w])).to(dev),
            torch.from_numpy(np.ascontiguousarray(I1)).to(dev))


def season_config(dev, root, n_epochs: int,
                  cell_px: float = SEASON_CELL_PX):
    """Render the synthetic full-size season on `dev`, write it under
    `root` and return (scene, the Pipeline config of the season path):
    2x2 EXHAUSTIVE tiles with 200 px overlap, SEASON_KEYPOINTS a tile,
    the "metashape" BA preset."""
    sys.path.insert(0, str(REPO / "tests"))
    from torch_port_inputs import StereoSeason

    scene = StereoSeason(H_IMG, W_IMG, SEASON_F, baseline=SEASON_BASELINE,
                         cell_px=cell_px, device=dev)
    cfg = scene.write(root, n_epochs=n_epochs, max_keypoints=SEASON_KEYPOINTS)
    cfg["matching"].update(tile_selection="exhaustive", grid=[2, 2],
                           overlap=round(200 * W_IMG / 6012))
    cfg["ba"] = {"free_intrinsics": "metashape"}
    del scene.tex
    torch.cuda.empty_cache()
    return scene, cfg


def rotation_error_deg(epoch, cams) -> float:
    """Angle of the epoch's relative rotation (true: the identity)."""
    R0, R1 = (np.asarray(epoch.cameras[c].R, np.float64) for c in cams)
    rel = R1 @ R0.T
    s = np.linalg.norm([rel[2, 1] - rel[1, 2], rel[0, 2] - rel[2, 0],
                        rel[1, 0] - rel[0, 1]]) / 2
    return float(np.degrees(np.arctan2(s, (np.trace(rel) - 1) / 2)))


def run_season(pipe, reset_counts, read_counts):
    """Run the pipeline's season with every launch count set to 0 before
    it; returns (epochs, seconds, each epoch's launch counts)."""
    counts = []

    def on_epoch(epoch):
        counts.append(read_counts())
        reset_counts()

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    epochs = list(pipe.run(on_epoch=on_epoch))
    return epochs, time.perf_counter() - t0, counts


def season_stats(scene, pipe, epochs) -> list:
    stats = []
    for e in epochs:
        stats.append(dict(e.quality["stats"], status=e.quality["status"],
                          flags=e.quality["flags"], n_points=len(e.points),
                          rel_rotation_err_deg=rotation_error_deg(
                              e, pipe.cams),
                          median_surface_dist_m=float(np.median(
                              scene.surface_distance(e.points.to_numpy())))))
    return stats


def track_motion(scene, prev, cur, cam: str) -> dict:
    """Features of `cur` tracked from `prev`: how many, and the median
    displacement (px) in camera `cam` of those whose triangulated point
    lies on the stable faces (rock wall, boulders) and on the tongue."""
    ids0 = prev.features[cam].track_ids_to_numpy()
    ids1 = cur.features[cam].track_ids_to_numpy()
    common, i0, i1 = np.intersect1d(ids0, ids1, return_indices=True)
    disp = np.linalg.norm(cur.features[cam].kpts_to_numpy()[i1]
                          - prev.features[cam].kpts_to_numpy()[i0], axis=1)
    _, ip, ic = np.intersect1d(cur.points.track_ids_to_numpy(), common,
                               return_indices=True)
    face = scene.face_index(cur.points.to_numpy()[ip])
    stable = disp[ic][(face == 0) | (face == 2)]
    tongue = disp[ic][face == 1]

    def med(a):
        return float(np.median(a)) if len(a) else float("nan")

    return {"tracks": int(len(common)), "stable": int(len(stable)),
            "tongue": int(len(tongue)), "stable_median_px": med(stable),
            "tongue_median_px": med(tongue)}


def season_path(dev, reset_counts, read_counts, scene, base_cfg: dict,
                expected: list):
    """Phase 7: the port's Pipeline with tracking and dense on; each
    epoch's launch counts must equal `expected[epoch]`. Returns what the
    JSON line reports and the Epoches (phase 17 reads them)."""
    import copy
    import csv

    from icepy4d_tpu_torch.pipeline import Pipeline

    cfg = copy.deepcopy(base_cfg)
    res = Path(cfg["paths"]["image_dir"]).parent / "res_lightglue"
    cfg["paths"]["results_dir"] = str(res)
    cfg["proc"].update(do_tracking=True, do_dense=True)
    pipe = Pipeline(cfg)
    epochs, run_s, counts = run_season(pipe, reset_counts, read_counts)
    sinks = {}
    for name in ("residuals_image.csv", "estimated_cameras.csv"):
        with open(res / name) as f:
            sinks[name] = len(list(csv.reader(f)))
    n_ckpt = len(list((res / "epochs").rglob("*.pickle")))
    n_ply = len(list((res / "epochs").rglob("dense_*.ply")))

    stats = season_stats(scene, pipe, epochs)
    tracks = [track_motion(scene, a, b, pipe.cams[0])
              for a, b in zip(epochs, epochs[1:])]
    dense = []
    for e in epochs:
        pts = e.point_cloud.points
        d = scene.surface_distance(pts[::max(len(pts) // 200000, 1)])
        dense.append({"points": len(pts),
                      "median_surface_dist_m": float(np.median(d))})
    out = {"run_s": run_s,
           "stage_times_s": {str(k): v for k, v in pipe.stage_times.items()},
           "epochs": stats, "tracks": tracks, "dense": dense,
           "launches": counts, "sink_rows": sinks, "checkpoints": n_ckpt,
           "dense_ply": n_ply}
    log(f"season path: {len(epochs)} epochs of {W_IMG}x{H_IMG} pairs with "
        f"tracking and dense, run {run_s:.1f} s")
    for ep, t in pipe.stage_times.items():
        log(f"  epoch {ep} ({'cold' if ep == 0 else 'warm'}): "
            + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else
                        f"{k} {v}" for k, v in t.items()))
    for st, c, dn in zip(stats, counts, dense):
        log(f"  {st['status']} {st['flags']}: putative {st['n_putative']}, "
            f"verified {st['n_matches']}, orientation inliers "
            f"{st['n_orientation_inliers']}, BA rmse "
            f"{st.get('ba_rmse_px', float('nan')):.4f} px, points "
            f"{st['n_points']}, relative rotation error "
            f"{st['rel_rotation_err_deg']:.5f} deg, median surface distance "
            f"{st['median_surface_dist_m']:.4f} m, dense cloud "
            f"{dn['points']} points at {dn['median_surface_dist_m']:.4f} m, "
            f"launches {c}")
    for i, tr in enumerate(tracks, 1):
        log(f"  tracks into epoch {i}: {tr}")
    for st, c, want, dn in zip(stats, counts, expected, dense):
        check_epoch(st, SEASON_GATES)
        if st["n_points"] < SEASON_GATES["points"]:
            raise AssertionError(f"{st['n_points']} tie points < "
                                 f"{SEASON_GATES['points']}")
        if dn["points"] < SEASON_GATES["dense_points"] or not \
                dn["median_surface_dist_m"] <= SEASON_GATES["dense_surface_m"]:
            raise AssertionError(f"dense cloud {dn} against "
                                 f"{SEASON_GATES}")
        if c != want:
            raise AssertionError(f"epoch launches {c} != {want}")
    for tr in tracks:
        if not tr["stable"] or not tr["stable_median_px"] <= \
                SEASON_GATES["track_px"]:
            raise AssertionError(f"tracks on the stable faces: {tr}")
    if len(epochs) != 3 or n_ckpt != 3 or n_ply != 3 or any(
            n != 4 for n in sinks.values()):
        raise AssertionError(f"{len(epochs)} epochs, {n_ckpt} checkpoints, "
                             f"{n_ply} dense PLYs, sink rows {sinks}")
    return out, pipe.epoches


def check_epoch(st: dict, gates: dict) -> None:
    """An epoch ok without recovery, within the gates' BA RMSE, relative
    rotation and distance to the faces."""
    if st["status"] != "ok" or st["flags"] or "recovered" in st:
        raise AssertionError(f"season epoch not ok: {st}")
    if not st.get("ba_rmse_px", np.inf) <= gates["rmse_px"]:
        raise AssertionError(f"BA rmse {st.get('ba_rmse_px')} > "
                             f"{gates['rmse_px']} px")
    if not st["rel_rotation_err_deg"] <= gates["rotation_deg"]:
        raise AssertionError(f"relative rotation error "
                             f"{st['rel_rotation_err_deg']} deg > "
                             f"{gates['rotation_deg']}")
    if not st["median_surface_dist_m"] <= gates["surface_m"]:
        raise AssertionError(f"median surface distance "
                             f"{st['median_surface_dist_m']} m > "
                             f"{gates['surface_m']}")


def sift_season_path(dev, reset_counts, read_counts, scene,
                     base_cfg: dict) -> dict:
    """Phase 8: the same frames through the real season's SIFT settings
    with the GCP prior and tracking; no kernel may launch."""
    import copy

    from icepy4d_tpu_torch.pipeline import Pipeline

    cfg = copy.deepcopy(base_cfg)
    cfg["paths"]["results_dir"] = str(
        Path(cfg["paths"]["image_dir"]).parent / "res_sift")
    cfg["proc"].update(do_tracking=True, save_checkpoints=False)
    cfg["matching"] = copy.deepcopy(SIFT_MATCHING)
    cfg["ba"] = dict(SIFT_BA)
    cfg["other"] = {"pydegensac_threshold": 2.0}
    pipe = Pipeline(cfg)
    epochs, run_s, counts = run_season(pipe, reset_counts, read_counts)
    priors = [pipe._gcp_prior(e) is not None for e in epochs]
    stats = season_stats(scene, pipe, epochs)
    tracks = [track_motion(scene, a, b, pipe.cams[0])
              for a, b in zip(epochs, epochs[1:])]
    out = {"run_s": run_s,
           "stage_times_s": {str(k): v for k, v in pipe.stage_times.items()},
           "epochs": stats, "tracks": tracks, "launches": counts,
           "gcp_prior": priors}
    log(f"SIFT season: {len(epochs)} epochs, run {run_s:.1f} s")
    for ep, t in pipe.stage_times.items():
        log(f"  epoch {ep} ({'cold' if ep == 0 else 'warm'}): "
            + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else
                        f"{k} {v}" for k, v in t.items()))
    for st, c in zip(stats, counts):
        log(f"  {st['status']} {st['flags']}: putative {st['n_putative']}, "
            f"verified {st['n_matches']}, orientation inliers "
            f"{st['n_orientation_inliers']}, BA rmse "
            f"{st.get('ba_rmse_px', float('nan')):.4f} px, points "
            f"{st['n_points']}, relative rotation error "
            f"{st['rel_rotation_err_deg']:.5f} deg, median surface distance "
            f"{st['median_surface_dist_m']:.4f} m, launches {c}")
    for i, tr in enumerate(tracks, 1):
        log(f"  tracks into epoch {i}: {tr}")
    for st, c in zip(stats, counts):
        check_epoch(st, SIFT_GATES)
        if st["n_putative"] < SIFT_GATES["putative"] or \
                st["n_matches"] < SIFT_GATES["verified"] or \
                st["n_points"] < SIFT_GATES["points"]:
            raise AssertionError(f"SIFT matches below {SIFT_GATES}: {st}")
        if any(c.values()):
            raise AssertionError(f"SIFT epoch launched kernels: {c}")
    if len(epochs) != 3 or not all(priors):
        raise AssertionError(f"{len(epochs)} epochs, GCP prior {priors}")
    return out


# -- phase 19: the batched, multi-process and staged seasons ------------------

# Counts that phase 19 (c) holds equal between run_distributed() and
# phase 7's run(), beside the statuses and the track ids.
SEASON_COUNTS = ("n_putative", "n_matches", "n_orientation_inliers")


def season_summary(epochs, cams) -> list:
    """Each epoch's status, flags, SEASON_COUNTS and both cameras' track
    ids."""
    return [{"status": e.quality["status"], "flags": list(e.quality["flags"]),
             "counts": [e.quality["stats"].get(k) for k in SEASON_COUNTS],
             "ids": [e.features[c].track_ids_to_numpy() for c in cams]}
            for e in epochs]


def batched_expected(pipe, b: int, n_epochs: int) -> dict:
    """The launches of one run_batched over n_epochs in groups of b: per
    group one NMS launch a SuperPoint call (each side's b frames in the
    matcher's extraction chunks) and one LightGlue forward over the b
    pairs (4 attention launches a layer)."""
    groups = -(-n_epochs // b)
    chunk = pipe.matcher._extract_chunk(b, H_IMG, W_IMG)
    return {"nms": groups * 2 * (b // chunk),
            "attention": groups * 4 * pipe.matcher.matcher.n_layers,
            "sweep": 0, "dual_softmax": 0}


def run_batched_timed(pipe, mesh, reset_counts, read_counts):
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    epochs = list(pipe.run_batched(mesh=mesh))
    torch.cuda.synchronize()
    return epochs, time.perf_counter() - t0, read_counts()


def batched_stats(scene, pipe, epochs) -> list:
    return [dict(st, n_features=len(e.features[pipe.cams[0]]))
            for st, e in zip(season_stats(scene, pipe, epochs), epochs)]


def check_batched(label: str, pipe, epochs, stats, gates: dict,
                  n_epochs: int) -> None:
    """Every epoch ok within the gates, track ids equal across the two
    cameras and unique across the epochs, and only the real epochs."""
    if len(epochs) != n_epochs:
        raise AssertionError(f"{label}: {len(epochs)} epochs")
    for st in stats:
        check_epoch(st, gates)
        if st["n_points"] < gates["points"]:
            raise AssertionError(f"{label}: {st['n_points']} tie points < "
                                 f"{gates['points']}")
    ids = []
    for e in epochs:
        i0, i1 = (e.features[c].track_ids_to_numpy() for c in pipe.cams)
        if not np.array_equal(i0, i1):
            raise AssertionError(f"{label}: track ids differ by camera")
        ids.append(i0)
    ids = np.concatenate(ids)
    if len(np.unique(ids)) != len(ids):
        raise AssertionError(f"{label}: a track id in two epochs")


def batched_path(dev, reset_counts, read_counts, scene, base_cfg: dict,
                 season_ref: list, season_warm_s: list, img0, img1,
                 call: dict) -> dict:
    """Phase 19 (see the module doc). Returns what the JSON line
    reports; "launches" are (a)'s warm run's."""
    import copy

    from icepy4d_tpu_torch.parallel import StagedPipeline, make_mesh
    from icepy4d_tpu_torch.pipeline import Pipeline

    def config(name, **proc):
        cfg = copy.deepcopy(base_cfg)
        cfg["paths"]["results_dir"] = str(
            Path(cfg["paths"]["image_dir"]).parent / name)
        cfg["proc"].update(save_checkpoints=False, **proc)
        return cfg

    t_phase = time.perf_counter()
    n = 3
    b = 2
    mesh = make_mesh(b)
    out = {"mesh": mesh.shape}

    # -- (a) the learned family, cold then warm
    runs = {}
    for run in ("cold", "warm"):
        pipe = Pipeline(config(f"res_batched_{run}"))
        epochs, run_s, launches = run_batched_timed(pipe, mesh, reset_counts,
                                                    read_counts)
        runs[run] = run_s
    want = batched_expected(pipe, b, n)
    stats = batched_stats(scene, pipe, epochs)
    warm_epm = 60.0 * n / runs["warm"]
    run_epm = 60.0 / float(np.mean(season_warm_s))
    out["learned"] = {"cold_s": runs["cold"], "warm_s": runs["warm"],
                      "warm_epochs_per_min": warm_epm,
                      "season_run_epochs_per_min": run_epm,
                      "epochs": stats, "launches": launches,
                      "expected_launches": want}
    log(f"batched season, LightGlue: {n} epochs of {W_IMG}x{H_IMG} pairs in "
        f"groups of {b} (mesh {mesh.shape}), untiled, "
        f"{SEASON_KEYPOINTS} keypoints a frame: cold {runs['cold']:.3f} s, "
        f"warm {runs['warm']:.3f} s = {warm_epm:.2f} epochs/min (phase 7's "
        f"warm run() with tiles, tracking and dense: {run_epm:.2f} "
        f"epochs/min) on {card_line()}; launches {launches}, expected "
        f"{want}")
    for st in stats:
        log(f"  {st['status']} {st['flags']}: step-verified "
            f"{st['n_features']}, orientation inliers "
            f"{st['n_orientation_inliers']}, BA rmse "
            f"{st.get('ba_rmse_px', float('nan')):.4f} px, points "
            f"{st['n_points']}, relative rotation error "
            f"{st['rel_rotation_err_deg']:.5f} deg, median surface distance "
            f"{st['median_surface_dist_m']:.4f} m")
    check_batched("batched LightGlue", pipe, epochs, stats, BATCHED_GATES, n)
    if launches != want:
        raise AssertionError(f"batched launches {launches} != {want}")
    out["launches"] = launches

    # -- (b) the SIFT family with the guided round on the GCP prior
    cfg = config("res_batched_sift")
    cfg["matching"] = copy.deepcopy(SIFT_MATCHING)
    cfg["ba"] = dict(SIFT_BA)
    cfg["other"] = {"pydegensac_threshold": 2.0}
    pipe = Pipeline(cfg)
    epochs, run_s, launches = run_batched_timed(pipe, mesh, reset_counts,
                                                read_counts)
    stats = batched_stats(scene, pipe, epochs)
    priors = [pipe._gcp_prior(e) is not None for e in epochs]
    out["sift"] = {"run_s": run_s, "epochs": stats, "launches": launches,
                   "gcp_prior": priors,
                   "guided_rounds": pipe.matcher._guided_rounds}
    log(f"batched season, SIFT with the guided round: run {run_s:.3f} s, "
        f"GCP prior {priors}, launches {launches}")
    for st in stats:
        log(f"  {st['status']} {st['flags']}: step-verified "
            f"{st['n_features']}, orientation inliers "
            f"{st['n_orientation_inliers']}, BA rmse "
            f"{st.get('ba_rmse_px', float('nan')):.4f} px, points "
            f"{st['n_points']}, relative rotation error "
            f"{st['rel_rotation_err_deg']:.5f} deg, median surface distance "
            f"{st['median_surface_dist_m']:.4f} m")
    check_batched("batched SIFT", pipe, epochs, stats, BATCHED_SIFT_GATES, n)
    if any(launches.values()) or not all(priors) \
            or pipe.matcher._guided_rounds < 1:
        raise AssertionError(f"batched SIFT launches {launches}, prior "
                             f"{priors}")

    # -- (c) run_distributed() on one process against phase 7's run()
    pipe = Pipeline(config("res_distributed", do_tracking=True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = season_summary(list(pipe.run_distributed()), pipe.cams)
    dist_s = time.perf_counter() - t0
    same = len(got) == len(season_ref) and all(
        g["status"] == r["status"] and g["flags"] == r["flags"]
        and g["counts"] == r["counts"]
        and all(np.array_equal(x, y) for x, y in zip(g["ids"], r["ids"]))
        for g, r in zip(got, season_ref))
    out["distributed"] = {"run_s": dist_s, "equal_to_run": same,
                          "counts": [g["counts"] for g in got],
                          "run_counts": [r["counts"] for r in season_ref]}
    log(f"run_distributed() on one process: {dist_s:.3f} s, statuses, "
        f"counts {out['distributed']['counts']} and track ids equal to "
        f"phase 7's run() ({out['distributed']['run_counts']}): {same}")
    if not same:
        raise AssertionError("run_distributed() differs from run()")

    # -- (d) the staged pipeline on two streams of the card
    from icepy4d_tpu_torch.matching import LightGlueMatcher
    from icepy4d_tpu_torch.matching.matchers import _preprocess, _to_device
    from icepy4d_tpu_torch.matching.tiling import Tiler
    from icepy4d_tpu_torch.ops.image import extract_tiles

    matcher = LightGlueMatcher({"max_keypoints": SEASON_KEYPOINTS})
    k = matcher._max_keypoints
    tiles = []
    for img in (img0, img1):
        g = _preprocess(_to_device(img, dev), "high")
        tiler = Tiler(grid=call["grid"], overlap=call["overlap"])
        tiler.compute_limits_by_grid(np.empty(img.shape[:2]))
        th, tw = tiler.tile_size
        tiles.append(extract_tiles(g, tiler.tile_origins(), th, tw))
    pairs = [(i, j) for i in range(len(tiles[0]))
             for j in range(len(tiles[1]))]
    per = len(pairs) // 4
    batches = [{"im0": tiles[0][[i for i, _ in pairs[q:q + per]]],
                "im1": tiles[1][[j for _, j in pairs[q:q + per]]]}
               for q in range(0, len(pairs), per)]
    size = torch.tensor([tw, th], dtype=torch.float32, device=dev)

    def extract(batch):
        with torch.inference_mode():
            return [matcher._extract(batch[s], k) for s in ("im0", "im1")]

    def match(feats):
        f0, f1 = feats
        p = f0["keypoints"].shape[0]
        data = {"kpts0": f0["keypoints"], "desc0": f0["descriptors"],
                "mask0": f0["mask"], "size0": size.expand(p, 2),
                "kpts1": f1["keypoints"], "desc1": f1["descriptors"],
                "mask1": f1["mask"], "size1": size.expand(p, 2)}
        res = matcher.matcher.match(data)
        return {"matches0": res["matches0"], "mscores0": res["mscores0"],
                "kpts0": f0["keypoints"], "kpts1": f1["keypoints"]}

    stage = StagedPipeline(extract, match, devices=[dev, dev])
    times = {}
    for run in ("sequential", "staged", "sequential_warm", "staged_warm"):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = stage.run(batches) if run.startswith("staged") else \
            [match(extract(bt)) for bt in batches]
        torch.cuda.synchronize()
        times[run] = time.perf_counter() - t0
        if run == "sequential":
            ref = res
        elif run == "staged":
            staged_out = res
    equal = len(staged_out) == len(ref) == 4 and all(
        torch.equal(a[key], r[key]) for a, r in zip(staged_out, ref)
        for key in r)
    out["staged"] = {"batches": len(batches), "pairs_a_batch": per,
                     "times_s": times, "bitwise_equal": equal,
                     "launches": read_counts()}
    log(f"staged pipeline, SuperPoint -> LightGlue on two streams of the "
        f"card, {len(batches)} batches of {per} of phase 4's tile pairs: "
        f"times {times} s, outputs bitwise equal to sequential calls: "
        f"{equal}, launches a run {out['staged']['launches']}")
    if not equal:
        raise AssertionError("staged outputs differ from sequential calls")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  batched, multi-process and staged seasons: {out['phase_s']:.1f} s")
    return out


# -- phase 10: the adaptive matcher -------------------------------------------

def force_confidence(lg, bias: float = 10.0) -> None:
    """Pin every token-confidence head of `lg` to sigmoid(bias), as
    tests/test_lightglue_adaptive.py forces them."""
    with torch.no_grad():
        for head in lg.confidence:
            head.token.weight.zero_()
            head.token.bias.fill_(bias)


def pruning_width(lg, data, check_every: int = 3) -> float:
    """A width confidence that, with every token confident, prunes both
    sides of every pair of the batch `data` to at most half: the
    smallest matchability threshold of a grid under which no side keeps
    more than half its slots after the first segment."""
    from icepy4d_tpu_torch.models import lightglue as lgm

    with torch.inference_mode():
        d0 = lgm._linear(lg.input_proj, data["desc0"].float())
        d1 = lgm._linear(lg.input_proj, data["desc1"].float())
        enc0 = lgm.rotary_encoding(lg.posenc, lgm.normalize_keypoints(
            data["kpts0"], data["size0"]))
        enc1 = lgm.rotary_encoding(lg.posenc, lgm.normalize_keypoints(
            data["kpts1"], data["size1"]))
        d0, d1 = lg._run_segment(lg.layers[:check_every], d0, d1, enc0, enc1,
                                 data["mask0"], data["mask1"])
        head = lg.assign[check_every - 1]
        s0 = torch.where(data["mask0"], lgm.matchability(head, d0), 0.0)
        s1 = torch.where(data["mask1"], lgm.matchability(head, d1), 0.0)
    half = max(data["mask0"].shape[1], data["mask1"].shape[1]) // 2
    for th in (0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.99, 0.999):
        if max(int((s0 > th).sum(1).max()), int((s1 > th).sum(1).max())) \
                <= half:
            return 1.0 - th
    raise AssertionError("no matchability threshold prunes to half")


def valid_rows_check(attention, q, k, v, mask, label: str) -> float:
    """The phase-3 rule on captured operands: kernel vs plain bf16,
    relative to the output's largest magnitude, over the batch rows that
    have a valid key (a fully masked row is zeros in the kernel and
    the uniform average in the XLA reference)."""
    got = attention.flash_attention(q, k, v, mask)
    ref = attention.attention_plain(q, k, v, mask,
                                    operand_dtype=torch.bfloat16)
    rows = mask.any(1)
    err = (got[rows].float() - ref[rows].float()).abs().max().item()
    rel = err / ref[rows].float().abs().max().item()
    log(f"  attention on {label} {tuple(q.shape)} x Nk={k.shape[2]}: max "
        f"abs err {err:.3e}, relative {rel:.3e}")
    if not rel <= 2e-3 or torch.count_nonzero(got[~rows]).item():
        raise AssertionError(f"attention kernel vs plain bf16 on {label}: "
                             f"{rel}")
    return err


def adaptive_path(dev, reset_counts, read_counts, img0, img1, call: dict,
                  n_chunks_nms: int, static_warm_s: float,
                  max_keypoints: int = 4096) -> dict:
    """Phase 10 (see the module doc). Returns what the JSON line reports."""
    from icepy4d_tpu_torch.matching import LightGlueMatcher
    from icepy4d_tpu_torch.models import lightglue as lgm
    from icepy4d_tpu_torch.ops import attention

    matcher = LightGlueMatcher({"max_keypoints": max_keypoints,
                                "adaptive": True}, device=dev)
    captured, pruned = [], []
    run_matcher = matcher._run_matcher
    run_attention = lgm.masked_attention

    def capture(data):
        captured.append(data)
        return run_matcher(data)

    def capture_pruned(q, k, v, kmask):
        if not pruned and k.shape[2] < captured[-1]["mask1"].shape[1]:
            pruned.append(tuple(t.clone() for t in (q, k, v, kmask)))
        return run_attention(q, k, v, kmask)

    matcher._run_matcher = capture
    lgm.masked_attention = capture_pruned

    def run(label: str, **opts) -> dict:
        matcher._depth_confidence = opts.get("depth_confidence", 0.95)
        matcher._width_confidence = opts.get("width_confidence", 0.99)
        captured.clear()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        matcher.match(img0, img1, **call)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        err = np.linalg.norm(matcher.mkpts0 - matcher.mkpts1 - [DX, DY],
                             axis=1)
        out = {"warm_s": wall, "runs": list(matcher.adaptive_runs),
               "layers_run": [r[0] for r in matcher.adaptive_runs],
               "launches": counts, "putative": len(matcher.inlier_mask),
               "inliers": len(matcher.mkpts0),
               "precision": float((err < 1.5).mean()) if len(err) else 0.0,
               **opts}
        log(f"  adaptive {label}: {wall:.3f} s (static warm "
            f"{static_warm_s:.3f} s), layers run and capacities "
            f"{out['runs']}, putative {out['putative']}, inliers "
            f"{out['inliers']}, precision {out['precision']:.4f}, launches "
            f"{counts}")
        want_att = 4 * sum(out["layers_run"])
        if counts["attention"] != want_att or counts["nms"] != n_chunks_nms:
            raise AssertionError(f"adaptive {label}: launches {counts}, want "
                                 f"attention {want_att}, nms {n_chunks_nms}")
        if out["precision"] < 0.9:
            raise AssertionError(f"adaptive {label}: precision "
                                 f"{out['precision']} < 0.9")
        return out

    log("adaptive matcher:")
    try:
        run("cold")
        res = {"default": run("warm, default confidences")}
        lg = matcher.matcher
        force_confidence(lg)
        res["forced_exit"] = run("forced confidence, exit on")
        if res["forced_exit"]["layers_run"] != [3] * len(captured):
            raise AssertionError("the forced early exit did not fire at "
                                 "the first checkpoint")
        width = pruning_width(lg, captured[0])
        pruned.clear()
        res["forced_prune"] = run("forced confidence, exit off",
                                  depth_confidence=0.0,
                                  width_confidence=width)
    finally:
        lgm.masked_attention = run_attention
        matcher._run_matcher = run_matcher
    caps = [r[1] for r in res["forced_prune"]["runs"]]
    if not pruned or max(caps) > 2048:
        raise AssertionError(f"pruning did not fire: capacities {caps}")
    q, k, v, kmask = pruned[0]
    res["pruned_check_err"] = valid_rows_check(
        attention, q, k, v, kmask, "a pruned segment's operands")
    del captured, pruned, matcher
    torch.cuda.empty_cache()
    return res


def attention_times(attention, dev, shape, seed: int = 2) -> dict:
    """The kernel, the plain bf16 version, SDPA and the bound at one
    (B, H, Nq, Nk) shape with a 0.9 key mask."""
    q, k, v, mask = attention_inputs(*shape, dev, seed=seed)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    ms = cuda_ms(lambda: attention.masked_attention(qb, kb, vb, mask), 20)
    plain = cuda_ms(lambda: attention.attention_plain(
        qb, kb, vb, mask, operand_dtype=torch.bfloat16), 5)
    sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=mask[:, None, None, :]), 20)
    b, h, nq, nk = shape
    bound, by = lower_bound(
        b * h * 64 * (2 * nq + 4 * nk) + b * nk + b * h * nq * (64 + 1) * 4,
        4 * b * h * nq * nk * 64, BF16_FLOPS)
    log(f"  attention {shape}: kernel {ms:.4f} ms, plain {plain:.4f}, SDPA "
        f"{sdpa:.4f}, bound {bound:.4f} ({by})")
    return {"shape": shape, "ms": ms, "plain_ms": plain, "library_ms": sdpa,
            "bound_ms": bound, "bound_by": by}


# -- phase 11: the n-camera season --------------------------------------------

def multicam_config(dev, root, n_epochs: int):
    """Render the 3-camera full-size season on `dev` under `root`; the
    config is phase 7's (tiles, keypoints, "metashape" BA block) with
    tracking, space resection and homography warping on."""
    sys.path.insert(0, str(REPO / "tests"))
    from torch_port_inputs import StereoSeason

    scene = StereoSeason(H_IMG, W_IMG, SEASON_F, baseline=SEASON_BASELINE,
                         cell_px=SEASON_CELL_PX, device=dev, n_cameras=3)
    cfg = scene.write(root, n_epochs=n_epochs, max_keypoints=SEASON_KEYPOINTS)
    cfg["matching"].update(tile_selection="exhaustive", grid=[2, 2],
                           overlap=round(200 * W_IMG / 6012))
    cfg["ba"] = {"free_intrinsics": "metashape"}
    cfg["proc"].update(do_tracking=True, do_space_resection=True,
                       do_homography_warping=True, save_checkpoints=False)
    del scene.tex
    torch.cuda.empty_cache()
    return scene, cfg


def covariance_check(dev, problem) -> dict:
    """Epoch 0's BA problem again with compute_covariance and the
    master's pose fixed, and the same covariance function on the same
    solution in float64. (The n-camera BA takes no targets, and the
    season's camera centres lie on one line: with every pose free, the
    rotation about that line is a null direction of the reduced camera
    system and no covariance exists. Fixing the master is the datum.)"""
    from icepy4d_tpu_torch.ops.ba import BAProblem, lm_solve, point_covariances
    from icepy4d_tpu_torch.sfm import BundleAdjustment

    args, kwargs = problem
    cfg = kwargs["cfg"]
    cfg.compute_covariance = True
    cfg.fix_cameras = [next(iter(args[0]))]
    ba = BundleAdjustment(*args, device=dev, **kwargs)
    out = ba.run()
    leaves, _, n_tie = ba._assemble_numpy()
    free = (0, 1) if cfg.fit_f and not cfg.free_intrinsics \
        else tuple(cfg.free_intrinsics)
    prob = BAProblem.from_numpy(dev, **leaves)
    res = lm_solve(prob, free_intr=free, max_iters=cfg.max_iters,
                   robust_delta=cfg.robust_delta)
    cov32 = point_covariances(prob, res.cam_theta, res.intrinsics,
                              res.points, free_intr=free,
                              robust_delta=cfg.robust_delta)
    prob64 = BAProblem(*(t.double() if t.is_floating_point() else t
                         for t in prob))
    cov64 = point_covariances(prob64, res.cam_theta.double(),
                              res.intrinsics.double(), res.points.double(),
                              free_intr=free, robust_delta=cfg.robust_delta)
    cov32, cov64 = cov32[:n_tie].double(), cov64[:n_tie]

    def rel(a, b):
        return (torch.linalg.matrix_norm(a - b)
                / torch.linalg.matrix_norm(b)).max().item()

    entry = torch.as_tensor(out.point_covariances, device=dev).double()
    stats = {"points": n_tie, "rel_frobenius_f32_vs_f64": rel(cov32, cov64),
             "rel_frobenius_entry_vs_f64": rel(entry, cov64),
             "asymmetry": rel(cov32, cov32.mT),
             "min_eigenvalue": torch.linalg.eigvalsh(cov64).min().item()}
    log(f"  covariances of epoch 0's {n_tie} tie points: {stats}")
    if not (stats["rel_frobenius_f32_vs_f64"] <= 1e-2
            and stats["rel_frobenius_entry_vs_f64"] <= 1e-2
            and stats["asymmetry"] <= 1e-3 and stats["min_eigenvalue"] > 0):
        raise AssertionError(f"point covariances: {stats}")
    return stats


def multicam_path(dev, reset_counts, read_counts, scene, cfg: dict,
                  expected: list) -> dict:
    """Phase 11 (see the module doc). Returns what the JSON line reports."""
    from icepy4d_tpu_torch.pipeline import Pipeline

    class Recording(Pipeline):
        """The Pipeline with its first BA problem kept."""

        problem = None

        def _solve(self, *args, **kwargs):
            if self.problem is None:
                self.problem = (args, dict(kwargs))
            return super()._solve(*args, **kwargs)

    pipe = Recording(cfg)
    epochs, run_s, counts = run_season(pipe, reset_counts, read_counts)
    master = pipe.cams[0]
    stats = []
    for e in epochs:
        st = dict(e.quality["stats"], status=e.quality["status"],
                  flags=e.quality["flags"], n_points=len(e.points),
                  median_surface_dist_m=float(np.median(
                      scene.surface_distance(e.points.to_numpy()))))
        st["rel_rotation_err_deg"] = max(
            rotation_error_deg(e, [master, sl]) for sl in pipe.cams[1:])
        stats.append(st)
    res = Path(cfg["paths"]["results_dir"])
    warped = sorted((res / "warped").glob("warped_*.jpg"))
    import cv2

    ref_warp = cv2.imread(str(warped[0])) if warped else None
    nonzero = float((ref_warp > 0).mean()) if ref_warp is not None else 0.0
    log(f"n-camera season: {len(epochs)} epochs of 3 {W_IMG}x{H_IMG} "
        f"frames, run {run_s:.1f} s")
    for ep, t in pipe.stage_times.items():
        log(f"  epoch {ep} ({'cold' if ep == 0 else 'warm'}): "
            + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else
                        f"{k} {v}" for k, v in t.items()))
    for st, c in zip(stats, counts):
        log(f"  {st['status']} {st['flags']}: "
            + ", ".join(f"{k} {st[k]}" for k in sorted(st)
                        if k.startswith(("n_", "ba_"))) +
            f", worst slave rotation {st['rel_rotation_err_deg']:.5f} deg, "
            f"median surface distance {st['median_surface_dist_m']:.4f} m, "
            f"launches {c}")
    log(f"  warped images {[p.name for p in warped]}, reference epoch's "
        f"warp non-zero on {nonzero:.4f}")
    cov = covariance_check(dev, pipe.problem)
    for st, c, want in zip(stats, counts, expected):
        check_epoch(st, MULTICAM_GATES)
        if st["n_points"] < MULTICAM_GATES["points"]:
            raise AssertionError(f"{st['n_points']} tie points < "
                                 f"{MULTICAM_GATES['points']}")
        if c != want:
            raise AssertionError(f"epoch launches {c} != {want}")
    if len(epochs) != len(expected) or len(warped) != len(epochs) \
            or not nonzero > 0.5:
        raise AssertionError(f"{len(epochs)} epochs, warped {warped}, "
                             f"reference warp non-zero {nonzero}")
    return {"run_s": run_s,
            "stage_times_s": {str(k): v for k, v in pipe.stage_times.items()},
            "epochs": stats, "launches": counts, "warped": len(warped),
            "reference_warp_nonzero": nonzero, "covariances": cov}


# -- phase 12: PnP, MAGSAC, resection in the season, the match writer ---------

def pnp_check(dev) -> dict:
    """SpaceResection and its PnP RANSAC on 12 noise-free GCPs 40-60 m in
    front of a turned camera, 3 of them moved by 40-90 px."""
    sys.path.insert(0, str(REPO / "tests"))
    from icepy4d_tpu_torch.core import Camera
    from icepy4d_tpu_torch.sfm import SpaceResection
    from torch_port_inputs import rotation_zyx

    rng = np.random.default_rng(1)
    K = np.array([[6000.0, 0, W_IMG / 2], [0, 6000.0, H_IMG / 2], [0, 0, 1]],
                 np.float32)
    R = rotation_zyx(0.2, -0.05, 0.03).astype(np.float64)
    C = np.array([503.0, 1198.0, 301.0])
    Xc = np.c_[rng.uniform(-12, 12, (12, 2)), rng.uniform(40, 60, 12)]
    X = (Xc @ R + C).astype(np.float32)
    E = np.eye(4, dtype=np.float32)
    E[:3, :3] = R
    E[:3, 3] = -R @ C
    truth = Camera.create(width=W_IMG, height=H_IMG, K=K, extrinsics=E)
    uv = truth.project_point(X)
    uv[:3] += rng.uniform(40, 90, (3, 2)) * rng.choice([-1, 1], (3, 2))
    start = Camera.create(width=W_IMG, height=H_IMG, K=K,
                          extrinsics=np.eye(4, dtype=np.float32))
    sr = SpaceResection(start, device=dev)
    cam = sr.estimate(uv, X)
    inl = sr.inliers
    rel = np.asarray(cam.R, np.float64) @ R.T
    s = np.linalg.norm([rel[2, 1] - rel[1, 2], rel[0, 2] - rel[2, 0],
                        rel[1, 0] - rel[0, 1]]) / 2
    out = {"rotation_err_deg": float(np.degrees(np.arctan2(
               s, (np.trace(rel) - 1) / 2))),
           "center_err_m": float(np.linalg.norm(np.asarray(cam.C).ravel()
                                                - C)),
           "inliers": int(inl.sum()),
           "outliers_rejected": bool(not inl[:3].any() and inl[3:].all())}
    log(f"  space resection, 12 GCPs with 3 outliers: {out}")
    if not (out["outliers_rejected"] and out["rotation_err_deg"] <= 0.01
            and out["center_err_m"] <= 0.01):
        raise AssertionError(f"space resection: {out}")
    return out


def magsac_check(dev, putatives) -> dict:
    """MAGSAC (sigma_max 1 px) on phase 4's putatives."""
    from icepy4d_tpu_torch.matching import GeometricVerification
    from icepy4d_tpu_torch.matching.geometric_verification import \
        geometric_verification

    mk0, mk1, conf = putatives
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, inl = geometric_verification(mk0, mk1,
                                    method=GeometricVerification.MAGSAC,
                                    threshold=1.0, scores=conf, device=dev)
    wall = time.perf_counter() - t0
    err = np.linalg.norm(mk0[inl] - mk1[inl] - [DX, DY], axis=1)
    out = {"putative": len(mk0), "inliers": int(inl.sum()), "s": wall,
           "precision": float((err < 1.5).mean()) if len(err) else 0.0}
    log(f"  MAGSAC on phase 4's putatives: {out}")
    if out["precision"] < 0.9:
        raise AssertionError(f"MAGSAC precision {out['precision']} < 0.9")
    return out


def resection_season_path(base_cfg: dict, n_epochs: int) -> dict:
    """Phase 7's frames through a stereo Pipeline with do_space_resection
    and other.do_viz (no tracking, dense or checkpoints)."""
    import copy

    from icepy4d_tpu_torch.pipeline import Pipeline

    class Recording(Pipeline):
        """The Pipeline with the cameras' centres kept right after each
        space resection."""

        resected: list = []

        def _space_resection(self, epoch, centers):
            super()._space_resection(epoch, centers)
            self.resected.append({c: np.asarray(epoch.cameras[c].C,
                                                np.float64).ravel()
                                  for c in self.cams})

    cfg = copy.deepcopy(base_cfg)
    cfg["paths"]["results_dir"] = str(
        Path(cfg["paths"]["image_dir"]).parent / "res_resection")
    cfg["proc"].update(do_space_resection=True, save_checkpoints=False,
                       epoch_to_process=list(range(n_epochs)))
    cfg["other"] = dict(cfg.get("other", {}), do_viz=True)
    pipe = Recording(cfg)
    pipe.resected = []
    epochs = list(pipe.run())
    centers = np.asarray(cfg["georef"]["camera_centers_world"], np.float64)
    errs = [max(float(np.linalg.norm(r[c] - centers[i]))
                for i, c in enumerate(pipe.cams)) for r in pipe.resected]
    files = [sorted(p.name for p in Path(e.epoch_dir).iterdir())
             for e in epochs]
    targets = [{k: v for k, v in e.quality["stats"].items()
                if k.startswith("resection")} for e in epochs]
    out = {"epochs": len(epochs), "status": [e.quality["status"]
                                             for e in epochs],
           "resection_targets": targets, "center_err_m": errs,
           "files": files}
    log(f"  stereo season with space resection and do_viz: {out}")
    want = {"matches.png", "keypoints_0.txt", "keypoints_1.txt"}
    if len(epochs) != n_epochs or len(errs) != n_epochs \
            or any(e > 1e-3 for e in errs) \
            or any(sorted(t) != [f"resection_targets_{c}" for c in pipe.cams]
                   for t in targets) \
            or any(not want <= set(f) for f in files):
        raise AssertionError(f"space resection season: {out}")
    return out


# -- phase 13: the SuperGlue path ----------------------------------------------

def superglue_path(dev, reset_counts, read_counts, img0, img1, call: dict,
                   n_chunks_nms: int, max_keypoints: int = 4096) -> dict:
    """Phase 13 (see the module doc). Returns what the JSON line
    reports."""
    from icepy4d_tpu_torch.matching import SuperGlueMatcher
    from icepy4d_tpu_torch.models import superglue as sgm
    from icepy4d_tpu_torch.models import superpoint as spm
    from icepy4d_tpu_torch.ops import attention, nms

    matcher = SuperGlueMatcher({"max_keypoints": max_keypoints, "seed": 0},
                               device=dev)
    captured, heats, operands = [], [], []
    run_matcher = matcher._run_matcher
    run_nms = spm.fused_nms_border
    run_attention = sgm.masked_attention

    def capture(data):
        captured.append(data)
        return run_matcher(data)

    def capture_heat(heat, *a):
        if not heats:
            heats.append(heat)
        return run_nms(heat, *a)

    def capture_operands(q, k, v, kmask):
        if not operands:
            operands.append((q, k, v, kmask))
        return run_attention(q, k, v, kmask)

    matcher._run_matcher = capture
    spm.fused_nms_border = capture_heat
    sgm.masked_attention = capture_operands
    times = {}
    try:
        for run in ("cold", "warm"):
            captured.clear()
            heats.clear()
            operands.clear()
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            matcher.match(img0, img1, **call)
            torch.cuda.synchronize()
            times[run] = time.perf_counter() - t0
            counts = read_counts()
    finally:
        matcher._run_matcher = run_matcher
        spm.fused_nms_border = run_nms
        sgm.masked_attention = run_attention
    err = np.linalg.norm(matcher.mkpts0 - matcher.mkpts1 - [DX, DY], axis=1)
    out = {"cold_s": times["cold"], "warm_s": times["warm"],
           "stages_s": dict(matcher.timer.times), "launches": counts,
           "pair_chunks": len(captured),
           "putative": len(matcher.inlier_mask)
           if matcher.inlier_mask is not None else 0,
           "inliers": len(matcher.mkpts0),
           "precision": float((err < 1.5).mean()) if len(err) else 0.0}
    log(f"superglue path: {W_IMG}x{H_IMG} pair, random SuperGlue weights "
        f"(seed 0), cold {times['cold']:.3f} s, warm {times['warm']:.3f} s, "
        f"stages {out['stages_s']}")
    log(f"  putative {out['putative']}, inliers {out['inliers']}, "
        f"precision {out['precision']:.4f} (random weights: no gate), pair "
        f"chunks {len(captured)}, launches {counts}")
    n_layers = len(matcher.matcher.gnn)
    want = {"nms": n_chunks_nms, "attention": 2 * n_layers * len(captured),
            "sweep": 0, "dual_softmax": 0}
    if counts != want:
        raise AssertionError(f"superglue launches {counts} != {want}")
    # the NMS kernel at r = 3 on the run's own heat map, bit for bit
    heat = heats[0]
    out["nms_err"] = check_nms(nms, heat, 3, (0, 0),
                               "SuperGlue's SuperPoint heat map")
    log(f"  nms on the run's heat map {tuple(heat.shape)} at r=3: bitwise "
        f"equal")
    q, k, v, kmask = operands[0]
    out["attention_err"] = valid_rows_check(
        attention, q, k, v, kmask, "SuperGlue's first layer (f32 heads)")

    # the forward with the kernel against the plain bf16 attention
    sg = matcher.matcher
    data = captured[0]
    valid = data["mask0"]
    plain_bf16 = partial(attention.attention_plain,
                         operand_dtype=torch.bfloat16)
    plain_f32 = partial(attention.attention_plain,
                        operand_dtype=torch.float32)
    got = sg.match(data)
    ref = sg.match(data, attn=plain_bf16)
    ref32 = sg.match(data, attn=plain_f32)

    def rows(a, b) -> float:
        return ((a == b) & valid).sum().item() / valid.sum().item()

    la, la_ref = got["log_assignment"], ref["log_assignment"]
    out["argmax_agreement"] = rows(la[:, :-1].argmax(-1),
                                   la_ref[:, :-1].argmax(-1))
    out["match_agreement"] = rows(got["matches0"], ref["matches0"])
    out["yardstick"] = rows(ref32["matches0"], ref["matches0"])
    log(f"  superglue B={valid.shape[0]}x{valid.shape[1]}: kernel vs plain "
        f"bf16 attention: log-assignment row argmax agrees on "
        f"{out['argmax_agreement']:.5f} of valid rows, match decisions on "
        f"{out['match_agreement']:.5f} (yardstick, plain f32 vs plain bf16: "
        f"{out['yardstick']:.5f})")
    if out["argmax_agreement"] < 0.98:
        raise AssertionError(f"superglue argmax agreement "
                             f"{out['argmax_agreement']} < 0.98")
    if out["match_agreement"] < out["yardstick"] - 0.01:
        raise AssertionError(f"superglue match agreement "
                             f"{out['match_agreement']} below the yardstick "
                             f"{out['yardstick']}")
    del captured, heats, operands, data, got, ref, ref32, la, la_ref
    torch.cuda.empty_cache()

    # times at SuperGlue's attention shape (f32 operands in head-major
    # (B, N, H, hd) storage, the batch's own key mask) and of the NMS
    # at r = 3
    b, h, nq, nk = q.shape[0], q.shape[1], q.shape[2], k.shape[2]
    ms = cuda_ms(lambda: attention.masked_attention(q, k, v, kmask), 10)
    plain = cuda_ms(lambda: attention.attention_plain(
        q, k, v, kmask, operand_dtype=torch.bfloat16), 3)
    sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=kmask[:, None, None, :]), 3)
    # f32 q, k, v and the bool mask in, f32 out
    bound, by = lower_bound(b * h * 64 * 4 * (2 * nq + 2 * nk) + b * nk,
                            4 * b * h * nq * nk * 64, BF16_FLOPS)
    out["attention_times"] = {"shape": (b, h, nq, nk), "ms": ms,
                              "plain_ms": plain, "library_ms": sdpa,
                              "bound_ms": bound, "bound_by": by}
    log(f"  attention {(b, h, nq, nk)} f32 head-major views: kernel "
        f"{ms:.4f} ms, plain bf16 {plain:.4f}, SDPA (f32) {sdpa:.4f}, bound "
        f"{bound:.4f} ({by})")
    shape = tuple(heat.shape)
    rand = heat_map(shape, dev)
    hb, hh, hw = shape
    nms_ms = cuda_ms(lambda: nms.fused_nms_border(rand, 3, 4, hh, hw), 20)
    nms_plain = cuda_ms(lambda: nms.nms_border_plain(rand, 3, 4, hh, hw), 5)
    px = hb * hh * hw
    # f32 read + write; 5 pools x 2 separable passes x 2r compares
    nms_bound, nms_by = lower_bound(px * 8, px * 5 * 2 * 6, F32_FLOPS)
    out["nms_times"] = {"shape": shape, "radius": 3, "ms": nms_ms,
                        "plain_ms": nms_plain, "bound_ms": nms_bound,
                        "bound_by": nms_by}
    log(f"  nms {shape} r=3: kernel {nms_ms:.4f} ms, plain {nms_plain:.4f}, "
        f"bound {nms_bound:.4f} ({nms_by})")
    del q, k, v, kmask, heat, rand, matcher
    torch.cuda.empty_cache()
    return out


# -- phase 14: DISK and ALIKED -------------------------------------------------

def timed_match(reset_counts, read_counts, label: str, matcher, img0, img1,
                want_attention_per_chunk: int = 0,
                dual_softmax_a_forward: bool = False, **call) -> dict:
    """A matcher's match, cold then warm, with every launch count set to
    0 before each; the warm run's launches must be no NMS or sweep,
    `want_attention_per_chunk` attention launches a pair chunk, and, with
    `dual_softmax_a_forward`, one dual-softmax launch a LoFTR forward
    (`matcher.counters["forwards"]`), else none."""
    chunks = []
    run_matcher = matcher._run_matcher

    def capture(data):
        chunks.append(data["mask0"].shape)
        return run_matcher(data)

    matcher._run_matcher = capture
    times = {}
    try:
        for run in ("cold", "warm"):
            chunks.clear()
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            matcher.match(img0, img1, **call)
            torch.cuda.synchronize()
            times[run] = time.perf_counter() - t0
            counts = read_counts()
    finally:
        matcher._run_matcher = run_matcher
    err = np.linalg.norm(matcher.mkpts0 - matcher.mkpts1 - [DX, DY], axis=1)
    out = {"cold_s": times["cold"], "warm_s": times["warm"],
           "stages_s": dict(matcher.timer.times), "launches": counts,
           "putative": len(matcher.inlier_mask)
           if matcher.inlier_mask is not None else 0,
           "inliers": len(matcher.mkpts0),
           "precision": float((err < 1.5).mean()) if len(err) else 0.0}
    log(f"  {label}: cold {times['cold']:.3f} s, warm {times['warm']:.3f} "
        f"s, putative {out['putative']}, inliers {out['inliers']}, "
        f"precision {out['precision']:.4f}, pair chunks {len(chunks)}, "
        f"launches {counts}, stages {out['stages_s']}")
    forwards = matcher.counters["forwards"] if dual_softmax_a_forward else 0
    want = {"nms": 0, "attention": want_attention_per_chunk * len(chunks),
            "sweep": 0, "dual_softmax": forwards}
    if counts != want or (dual_softmax_a_forward and not forwards):
        raise AssertionError(f"{label}: launches {counts} != {want}")
    return out


def extractor_path(dev, reset_counts, read_counts, img0, img1, call: dict,
                   max_keypoints: int = 4096) -> dict:
    """Phase 14 (see the module doc). Returns what the JSON line
    reports."""
    from icepy4d_tpu_torch.matching import (LightGlueMatcher,
                                            NearestNeighborMatcher)

    run = partial(timed_match, reset_counts, read_counts, img0=img0,
                  img1=img1, **call)
    log("DISK and ALIKED extractors:")
    res = {}
    m = NearestNeighborMatcher({"extractor": "aliked",
                                "max_keypoints": max_keypoints}, device=dev)
    res["nn_aliked"] = run("NN over ALIKED (bundled weights)", m)
    # the floor tests/test_trained_aliked.py sets for this checkpoint
    if res["nn_aliked"]["precision"] < 0.5:
        raise AssertionError(f"NN over ALIKED: precision "
                             f"{res['nn_aliked']['precision']} < 0.5")
    m = NearestNeighborMatcher({"extractor": "disk", "seed": 0,
                                "max_keypoints": max_keypoints}, device=dev)
    res["nn_disk"] = run("NN over DISK (random weights, seed 0)", m)
    m = LightGlueMatcher({"extractor": "aliked", "seed": 0,
                          "max_keypoints": max_keypoints}, device=dev)
    res["lightglue_aliked"] = run(
        "LightGlue over ALIKED (input dim 128, random LightGlue weights)",
        m, want_attention_per_chunk=4 * m.matcher.n_layers)
    del m
    torch.cuda.empty_cache()
    return res


# -- phase 15: semi-dense and LoFTR -------------------------------------------

SEMIDENSE_CROP = (1504, 2008)  # h, w: 188 x 251 = 47188 8-px tokens
LOFTR_CROP = (240, 320)        # the card-against-CPU comparison's crop


def loftr_semidense_path(dev, reset_counts, read_counts, img0, img1,
                         n_tiles_max: int = 8) -> dict:
    """Phase 15 (see the module doc). Returns what the JSON line
    reports."""
    from icepy4d_tpu_torch.matching import (GeometricVerification,
                                            LoFTRMatcher, Quality,
                                            SemiDenseMatcher, TileSelection,
                                            Tiler)
    from icepy4d_tpu_torch.models.loftr import LoFTR
    from icepy4d_tpu_torch.ops import dual_softmax

    run = partial(timed_match, reset_counts, read_counts,
                  quality=Quality.HIGH, threshold=1.0,
                  geometric_verification=GeometricVerification.PYDEGENSAC)
    log("semi-dense and LoFTR:")
    res = {}
    # OC refinement runs on full-frame matches; 8-px tokens (grid_pool 1)
    # on the centre crop: the whole frame would be 376k tokens
    ch, cw = SEMIDENSE_CROP
    y0, x0 = (H_IMG - ch) // 2, (W_IMG - cw) // 2
    crop0 = np.ascontiguousarray(img0[y0:y0 + ch, x0:x0 + cw])
    crop1 = np.ascontiguousarray(img1[y0:y0 + ch, x0:x0 + cw])
    m = SemiDenseMatcher({"grid_pool": 1}, device=dev)
    res["semidense"] = run(f"semi-dense, {cw}x{ch} centre crop, 8-px "
                           f"tokens, OC refinement", m, crop0, crop1)
    res["semidense"]["refined_share"] = m.refined_share
    log(f"  semi-dense refined share {m.refined_share:.4f}")
    if res["semidense"]["precision"] < 0.9 or not res["semidense"]["inliers"]:
        raise AssertionError(f"semi-dense: {res['semidense']}")
    del m, crop0, crop1
    torch.cuda.empty_cache()

    # LoFTR on the finest n x n grid whose tiles fit MAX_COARSE_TOKENS
    for n in range(2, n_tiles_max + 1):
        tiler = Tiler(grid=[n, n], overlap=200)
        tiler.compute_limits_by_grid(np.empty((H_IMG, W_IMG)))
        th, tw = tiler.tile_size
        if (th // 8) * (tw // 8) <= LoFTR.MAX_COARSE_TOKENS:
            break
    # random weights' dual-softmax confidences lie far under the
    # published 0.2; mutual nearest neighbours above 1e-8 are kept
    m = LoFTRMatcher({"seed": 0, "confidence_threshold": 1e-8}, device=dev)
    res["loftr"] = run(f"LoFTR, {n}x{n} GRID tiles of {tw}x{th} "
                       f"({(th // 8) * (tw // 8)} coarse tokens), random "
                       f"weights", m, img0, img1,
                       dual_softmax_a_forward=True,
                       tile_selection=TileSelection.GRID, grid=[n, n],
                       overlap=200)
    res["loftr"].update(grid=n, tile=(th, tw))
    if not res["loftr"]["putative"]:
        raise AssertionError("LoFTR found no match")

    # the same weights on the card and on the card's CPU, f32 without
    # TF32, on a crop: coarse confidences and match sets; on the card
    # the kernel's best matches of its coarse features against the dense
    # confidences', and one launch for its forward
    state = {k: v.cpu() for k, v in m.matcher.net.state_dict().items()}
    h, w = LOFTR_CROP
    a = img0[:h, :w].astype(np.float32) / 255.0
    b = img1[:h, :w].astype(np.float32) / 255.0
    outs, confs = {}, {}
    reset_counts()
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = LoFTR(thr=1e-8, max_matches=1024, precision="highest",
                      device=device).load_state_dict(state)
        ta = torch.from_numpy(a).to(device)[None]
        tb = torch.from_numpy(b).to(device)[None]
        cells = torch.ones((1, (h // 8) * (w // 8)), dtype=torch.bool,
                           device=device)
        with torch.inference_mode(), model._precision():
            c0, c1, *_ = model.coarse_features(ta, tb, cells, cells)
            conf = model.coarse_confidence(c0, c1, cells, cells)
            if name == "card":
                best = hold_best_matches(dual_softmax.best_matches(
                    c0, c1, cells, cells, model.dsmax_temperature), conf,
                    cells, cells, f"LoFTR {w}x{h} crop",
                    model.coarse_confidence(c0.double(), c1.double(),
                                            cells, cells))
            confs[name] = conf[0].cpu()
            del conf
        outs[name] = {k: v[0].cpu() for k, v in
                      model.match_pair(a, b).items()}
    crop_launches = read_counts()["dual_softmax"]
    conf_err = (confs["card"] - confs["cpu"]).abs().max().item()
    conf_rel = conf_err / confs["cpu"].max().item()

    def table(o):
        v = o["valid"]
        return {tuple(k.tolist()): p for k, p in
                zip(o["keypoints0"][v], o["keypoints1"][v])}

    tc, tp = table(outs["card"]), table(outs["cpu"])
    common = tc.keys() & tp.keys()
    jaccard = len(common) / max(len(tc.keys() | tp.keys()), 1)
    kp_err = max((float((tc[k] - tp[k]).abs().max()) for k in common),
                 default=0.0)
    res["loftr_card_vs_cpu"] = {"crop": LOFTR_CROP, "conf_max_abs": conf_err,
                                "conf_rel": conf_rel, "matches_card": len(tc),
                                "matches_cpu": len(tp), "jaccard": jaccard,
                                "keypoints1_max_px": kp_err,
                                "best_matches": best,
                                "launches": crop_launches}
    log(f"  LoFTR card vs the card's CPU on a {w}x{h} crop: coarse "
        f"confidences max abs diff {conf_err:.3e} ({conf_rel:.3e} of the "
        f"largest), matches {len(tc)} / {len(tp)}, Jaccard {jaccard:.4f}, "
        f"fine keypoints max {kp_err:.3e} px, dual-softmax launches "
        f"{crop_launches}")
    # tolerances, 10x what the first H100 run read (confidences 5.0e-5
    # of the largest, fine keypoints 3.1e-5 px apart, the same 106
    # matches): the confidences within 5e-4 of the largest, the common
    # fine keypoints within 3e-4 px, the match sets Jaccard >= 0.99
    if not (conf_rel <= 5e-4 and jaccard >= 0.99 and kp_err <= 3e-4
            and len(tc) > 0 and crop_launches == 2):
        raise AssertionError(f"LoFTR card vs CPU: {res['loftr_card_vs_cpu']}")
    del m, outs, confs
    torch.cuda.empty_cache()
    return res


# -- phase 16: the season tools ------------------------------------------------

def epoch_seconds(stage_times: dict) -> float:
    """An epoch's time: the sum of its stage times (the "_s" keys)."""
    return sum(v for k, v in stage_times.items() if k.endswith("_s"))


def season_tools_path(reset_counts, read_counts, base_cfg: dict,
                      expected: list, first_epoch_cold_s: float) -> dict:
    """Phase 16 (see the module doc). Returns what the JSON line
    reports."""
    import copy

    from icepy4d_tpu_torch.pipeline import Pipeline

    def config(name):
        cfg = copy.deepcopy(base_cfg)
        cfg["paths"]["results_dir"] = str(
            Path(cfg["paths"]["image_dir"]).parent / name)
        cfg["proc"].update(do_tracking=True, save_checkpoints=False,
                           epoch_to_process=[0, 1])
        return cfg

    log("season tools:")
    pipe = Pipeline(config("res_warmup"))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    pipe.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_counts = read_counts()
    epochs, run_s, per_epoch = run_season(pipe, reset_counts, read_counts)
    epoch_s = [epoch_seconds(t) for t in pipe.stage_times.values()]
    out = {"warmup_s": warm_s, "warmup_launches": warm_counts,
           "run_s": run_s, "epoch_s": epoch_s,
           "first_epoch_without_warmup_s": first_epoch_cold_s,
           "launches": per_epoch,
           "status": [e.quality["status"] for e in epochs],
           "rmse_px": [e.quality["stats"].get("ba_rmse_px") for e in epochs]}
    log(f"  warmup {warm_s:.3f} s (launches {warm_counts}); then run(): "
        f"epochs {[round(t, 3) for t in epoch_s]} s, launches {per_epoch}; "
        f"the season path's first epoch without warmup took "
        f"{first_epoch_cold_s:.3f} s (phase 7, the process's first "
        f"Pipeline)")
    wat = list(Pipeline(config("res_watch")).watch(poll_interval=0,
                                                   stop_after=2))
    out["watch_status"] = [e.quality["status"] for e in wat]
    out["watch_rmse_px"] = [e.quality["stats"].get("ba_rmse_px")
                            for e in wat]
    log(f"  watch(poll_interval=0, stop_after=2): {len(wat)} epochs, "
        f"status {out['watch_status']}, BA rmse {out['watch_rmse_px']}")
    for e in epochs + wat:
        q = e.quality
        if q["status"] != "ok" or "recovered" in q["stats"] or not \
                q["stats"].get("ba_rmse_px", np.inf) <= SEASON_GATES["rmse_px"]:
            raise AssertionError(f"season tools epoch {e.date_str}: {q}")
    if len(epochs) != 2 or len(wat) != 2 or \
            [e.timestamp for e in wat] != [e.timestamp for e in epochs]:
        raise AssertionError("watch did not process the run's epochs")
    if per_epoch != expected or warm_counts["nms"] == 0:
        raise AssertionError(f"season tools launches {per_epoch} != "
                             f"{expected}, warmup {warm_counts}")
    return out


def exif_check(root) -> dict:
    """The native EXIF scanner, built from native/exif_scan.cpp on this
    machine, against the Python reader on JPEGs whose EXIF block the
    script writes byte by byte."""
    sys.path.insert(0, str(REPO / "tests"))
    from torch_port_inputs import exif_jpeg

    from icepy4d_tpu_torch.core.images import Image, read_exif_tags
    from icepy4d_tpu_torch.native import exif_scan_batch, native_available

    root = Path(root)
    img = np.zeros((32, 48, 3), np.uint8)
    stamps = ["2022:07:28 10:11:12", "2023:01:02 03:04:05"]
    paths = []
    for i, s in enumerate(stamps):
        paths.append(root / f"exif_{i}.jpg")
        exif_jpeg(paths[-1], img, s, focal_mm=24.0 + i)
    if not native_available():
        raise AssertionError("the native EXIF scanner did not build")
    dts, focals = exif_scan_batch(paths)
    ref = [Image(p).datetime for p in paths]
    ref_f = [read_exif_tags(p)["FocalLength"] for p in paths]
    out = {"native": [str(d) for d in dts], "python": [str(d) for d in ref],
           "focal_native": focals.tolist(), "focal_python": ref_f}
    log(f"  native EXIF scanner vs the Python reader: {out}")
    if dts != ref or not np.allclose(focals, ref_f):
        raise AssertionError(f"EXIF scanners disagree: {out}")
    return out


# -- phase 17: the 4D products ------------------------------------------------

PRODUCTS_DSM_STEP = 0.1        # m, the DEM of difference's grid
PRODUCTS_VOXEL = 0.25          # m
PRODUCTS_K = 32                # the border features' neighbours
# Scene (X, Z) corners (m) of the border-feature crop: the tongue's left
# end (X = -30) and the rock wall beside it, above the boulders; about
# 300 k points of a full-size dense cloud (the whole cloud's brute-force
# kNN would be 2e14 pairs).
PRODUCTS_CROP = ((-37.0, 1.0), (-25.0, 1.0), (-25.0, 14.0), (-37.0, 14.0))
PRODUCTS_KNN_SUBSET = 20000    # points of the crop held card against CPU
PRODUCTS_MIN_VOXEL_POINTS = 10  # a face's 0.25 m voxel holds ~140 points,
                                # a scattered outlier's 1-2
# OC on the season's band-limited texture peaks low: at TrackTargets'
# defaults (32 px template, 128 px search, SNR > 7) every target fails
# (SNR 2.9-4.1, also on a frame tracked into itself); no template from
# 16 to 256 px reaches 7 on all five. 96 / 160 px tracks all five.
PRODUCTS_TARGETS = {"template_width": 96, "search_width": 160,
                    "snr_threshold": 3.5}
# Gates of phase 17, about 3x off the first H100 readings (20% under
# them for planarity and verticality): DEMs of difference |mean dz| and
# |net| a m^2 0.81-0.85 m (the cell means carry the clouds' far outliers:
# each epoch's DSM lies 2.7-2.9 m behind the faces in the mean over
# cells, 0-2 cm in the median), median dz 1.0-1.1 cm, matching
# 83.4-84.4%; DSM 0.064 m from the true faces (median); orthophoto NCC
# 0.932; planarity 0.499, verticality 0.678 (an isotropic normal reads
# 0.5); Poisson vertices 0.089 m from the faces (median; the gate is
# one voxel); targets at SNR >= 4.17, within 0.061 px; stable tracks
# 0.019 m.
PRODUCT_GATES = {"dod_mean_dz_m": 2.5, "dod_net_m3_per_m2": 2.5,
                 "dod_matching_pct": 50.0, "dod_median_dz_m": 0.035,
                 "dsm_median_err_m": 0.2, "ortho_ncc": 0.8,
                 "planarity": 0.4, "verticality": 0.55,
                 "poisson_median_m": PRODUCTS_VOXEL,
                 "target_snr": PRODUCTS_TARGETS["snr_threshold"],
                 "target_px": 0.2, "stable_track_m": 0.06}


def seen_face(scene, X, Z, cams=(0, 1)):
    """Per scene column (X, Z) (tensors): the index of the one face whose
    points there every camera in `cams` sees (the dense cloud keeps
    points both views see), -1 where no face or several are seen."""
    n_seen = torch.zeros(X.shape, dtype=torch.int64, device=X.device)
    face = torch.full(X.shape, -1, dtype=torch.int64, device=X.device)
    for k, Yk in enumerate(scene.layers):
        vis = scene._mask(k, X, Z)
        for c in cams:
            C = scene.centers[c]
            for j in range(k + 1, len(scene.layers)):
                s = (scene.layers[j] - C[1]) / (Yk - C[1])
                vis = vis & ~scene._mask(j, C[0] + s * (X - C[0]),
                                         C[2] + s * (Z - C[2]))
        n_seen += vis
        face = torch.where(vis, k, face)
    return torch.where(n_seen == 1, face, -1)


def clean_face(scene, X, Z, margin: float = 1.0) -> np.ndarray:
    """`seen_face` of columns whose neighbours `margin` m away in x, z
    and the diagonals see the same face; -1 elsewhere."""
    face = seen_face(scene, X, Z)
    for dx in (-margin, 0.0, margin):
        for dz in (-margin, 0.0, margin):
            if dx or dz:
                face = torch.where(seen_face(scene, X + dx, Z + dz) == face,
                                   face, -1)
    return face.cpu().numpy()


def timed(label: str, fn, times: dict):
    """Run `fn` twice (cold, then warm), synchronising the card around
    each; log and record both times; return the warm run's result."""
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    times[label] = {"cold_s": secs[0], "warm_s": secs[1]}
    log(f"  {label}: warm {secs[1]:.3f} s (cold {secs[0]:.3f})")
    return out


def f32_bin_count(coords: np.ndarray, lo: np.ndarray, step, shape) -> int:
    """Finite points whose float32 cell index floor((c - lo) / step) lies
    in the grid: what a scatter binning must count."""
    c = np.asarray(coords, np.float32)
    idx = np.floor((c - np.asarray(lo, np.float32))
                   / np.asarray(step, np.float32))
    ok = np.isfinite(c).all(1) & (idx >= 0).all(1) & (idx < shape).all(1)
    return int(ok.sum())


def products_path(dev, reset_counts, read_counts, scene, epoches,
                  root) -> dict:
    """Phase 17: the 4D products on phase 7's full-size outputs (its
    three dense clouds, frames, target tables and Epoches). Products
    launch no kernel: the counts are set to 0 before and must still be 0
    after. Returns what the JSON line reports."""
    import csv

    import cv2
    from scipy.spatial import cKDTree

    from icepy4d_tpu_torch.core import Features
    from icepy4d_tpu_torch.io import (COLMAPDatabase,
                                      export_keypoints_for_calge,
                                      export_points3D_for_calge,
                                      export_solution_to_colmap_binary,
                                      export_to_colmap_database,
                                      read_bundler_out, read_colmap_model,
                                      write_bundler_out)
    from icepy4d_tpu_torch.post_processing import (
        DemOfDifference, detect_border, filter_pcd_by_polyline,
        geometric_features, poisson_reconstruct, voxelize)
    from icepy4d_tpu_torch.post_processing.analysis import _knn_indices
    from icepy4d_tpu_torch.utils import (Rototranslation, TrackTargets,
                                         binned_statistic, build_dsm,
                                         compute_displacements,
                                         generate_orthophoto,
                                         tracked_points_time_series,
                                         tracked_time_series_to_df)
    from torch_port_inputs import SEASON_ORIGIN

    root = Path(root)
    res = root / "res_lightglue"
    plys = sorted(res.rglob("dense_*.ply"))
    ids = sorted(epoches._epochs)
    e0 = epoches[ids[0]]
    cams = list(e0.cameras)
    pts0 = e0.point_cloud.points
    times, out, fails = {}, {}, []

    def gate(name, ok, value):
        out.setdefault("gates", {})[name] = value
        if not ok:
            fails.append(f"{name} = {value}")

    log(f"products on {len(plys)} dense clouds of "
        f"{[len(epoches[i].point_cloud) for i in ids]} points "
        f"({card_line()}):")
    torch.cuda.synchronize()
    reset_counts()

    # DEM of difference, the cameras looking along +Y: grids over (x, z)
    def dod(a, b):
        d = DemOfDifference(a, b, dsm_step=PRODUCTS_DSM_STEP, direction="y",
                            device=dev)
        d.compute_volume()
        return d

    dods = [timed(f"DEM of difference {a.stem} -> {b.stem}",
                  lambda a=a, b=b: dod(a, b), times)
            for a, b in zip(plys, plys[1:])]
    for d in dods:
        d.write_result_row(root / "volumes.csv")
    with open(root / "volumes.csv") as f:
        rows = list(csv.DictReader(f))
    out["dod"] = [dict(vars(d.report), median_dz=float(np.nanmedian(d.dz)))
                  for d in dods]
    for d, rd in zip(dods, out["dod"]):
        r = d.report
        log(f"    {d.names[0]} -> {d.names[1]}: {rd}")
        gate("dod_median_dz_m", abs(rd["median_dz"])
             <= PRODUCT_GATES["dod_median_dz_m"], rd["median_dz"])
        gate("dod_mean_dz_m", abs(r.mean_dz) <= PRODUCT_GATES["dod_mean_dz_m"],
             r.mean_dz)
        gate("dod_net_m3_per_m2",
             abs(r.net) / r.area <= PRODUCT_GATES["dod_net_m3_per_m2"],
             r.net / r.area)
        gate("dod_matching_pct",
             r.matching_percent >= PRODUCT_GATES["dod_matching_pct"],
             r.matching_percent)
    if len(rows) != 2 or [r["pcd0"] for r in rows] != \
            [d.names[0] for d in dods]:
        raise AssertionError(f"volume rows {rows}")

    # each epoch's DSM (of the DoDs) against the true depth of the face
    # its cells see, on cells 1 m from any face or occlusion edge
    def dsm_error(dsm):                # rows: world z, columns: world x
        Zc, Xc = torch.meshgrid(
            torch.as_tensor(dsm.yy - SEASON_ORIGIN[2], device=dev),
            torch.as_tensor(dsm.xx - SEASON_ORIGIN[0], device=dev),
            indexing="ij")
        face = clean_face(scene, Xc, Zc)
        cells = (face >= 0) & (dsm.count > 0)
        return dsm.z[cells] - (SEASON_ORIGIN[1]
                               + np.asarray(scene.layers)[face[cells]])

    err = timed("DSM against the true faces", lambda: dsm_error(
        dods[0].dsm0), times)
    out["dsm"] = {"cells": len(err), "median_err_m": float(np.median(
        np.abs(err))), "p90_err_m": float(np.percentile(np.abs(err), 90))}
    for i, m in enumerate((dods[0].dsm0, dods[0].dsm1, dods[1].dsm1)):
        e = dsm_error(m)
        out["dsm"][f"epoch{i}_signed_mean_median_m"] = (
            float(e.mean()), float(np.median(e)))
    log(f"    DSM vs truth: {out['dsm']}")
    gate("dsm_median_err_m",
         out["dsm"]["median_err_m"] <= PRODUCT_GATES["dsm_median_err_m"],
         out["dsm"]["median_err_m"])

    # orthophotos of both frames of epoch 0 on a z-up DSM: a local frame
    # x' = X, y' = Z, z' = -Y about the scene origin (faces' normal +z)
    R = np.array([[1.0, 0, 0], [0, 0, 1], [0, -1, 0]])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -R @ SEASON_ORIGIN
    loc = Rototranslation(T)

    def ortho():
        d = build_dsm(loc.transform(pts0), PRODUCTS_DSM_STEP, device=dev)
        views = []
        for c in cams[:2]:
            cam = e0.cameras[c]
            cam_l = cam.update_extrinsics(
                np.asarray(cam.extrinsics, np.float64) @ loc.T_inv)
            img = cv2.imread(str(e0.images[c].path), cv2.IMREAD_GRAYSCALE)
            views.append(generate_orthophoto(img, d, cam_l, device=dev))
        return d, views

    dsm_l, views = timed("orthophotos", ortho, times)
    Zl, Xl = torch.meshgrid(torch.as_tensor(dsm_l.yy, device=dev),
                            torch.as_tensor(dsm_l.xx, device=dev),
                            indexing="ij")
    face_l = clean_face(scene, Xl, Zl)
    sel = ((face_l == 0) | (face_l == 2)) & (dsm_l.count > 0) \
        & views[0][1] & views[1][1]
    a, b = views[0][0][..., 0][sel], views[1][0][..., 0][sel]
    ncc = float(np.corrcoef(a, b)[0, 1])
    out["ortho"] = {"cells": int(sel.sum()), "ncc": ncc}
    log(f"    orthophotos of {cams[:2]} on stable faces: {out['ortho']}")
    gate("ortho_ncc", ncc >= PRODUCT_GATES["ortho_ncc"], ncc)

    # voxels and binned statistics of epoch 0's cloud
    cols0 = e0.point_cloud.colors
    vox = timed("voxelize", lambda: voxelize(pts0, cols0, PRODUCTS_VOXEL,
                                             device=dev), times)
    finite = pts0[np.isfinite(pts0).all(1)]
    bb_max = np.ceil(finite.max(0)).astype(np.float32)
    shape = np.maximum(np.ceil((bb_max - vox.origin) / PRODUCTS_VOXEL), 1)
    want = f32_bin_count(pts0, vox.origin, PRODUCTS_VOXEL, shape)
    binned = timed("binned statistic", lambda: binned_statistic(
        pts0[:, [0, 2]], pts0[:, 1], 0.5, device=dev), times)
    bshape = np.asarray(binned["count"].shape)
    bmin = np.asarray([binned["edges"][0][0], binned["edges"][1][0]])
    bwant = f32_bin_count(pts0[:, [0, 2]], bmin, 0.5, bshape)
    filled = binned["count"] > 0
    out["voxels"] = {"voxels": len(vox.counts), "counted": int(
        vox.counts.sum()), "in_bounds": want, "binned_cells": int(
        filled.sum()), "binned_counted": int(binned["count"].sum()),
        "binned_in_bounds": bwant}
    log(f"    voxels and binned statistics: {out['voxels']}")
    if int(vox.counts.sum()) != want or int(binned["count"].sum()) != bwant \
            or not (np.nanmin(binned["mean"][filled]) >= np.nanmin(pts0[:, 1])
                    and np.nanmax(binned["mean"][filled])
                    <= np.nanmax(pts0[:, 1])):
        raise AssertionError(f"voxel / binned counts {out['voxels']}")

    # border features on a polyline crop
    poly = np.asarray(PRODUCTS_CROP) + SEASON_ORIGIN[[0, 2]]
    crop = pts0[filter_pcd_by_polyline(pts0, poly, dir="x-z")]
    feats = timed(f"geometric features of {len(crop)} points",
                  lambda: geometric_features(crop, k=PRODUCTS_K, device=dev),
                  times)
    border = timed("detect_border", lambda: detect_border(
        crop, k=PRODUCTS_K, device=dev), times)
    cf = clean_face(scene, torch.as_tensor(crop[:, 0] - SEASON_ORIGIN[0],
                                           dtype=torch.float64, device=dev),
                    torch.as_tensor(crop[:, 2] - SEASON_ORIGIN[2],
                                    dtype=torch.float64, device=dev))
    planar = cf >= 0
    out["border"] = {
        "crop_points": len(crop), "planar_points": int(planar.sum()),
        "faces": {int(k): int((cf == k).sum()) for k in np.unique(cf)},
        "median_planarity": float(np.median(feats["planarity"][planar])),
        "median_verticality": float(np.median(feats["verticality"][planar])),
        "median_linearity": float(np.median(feats["linearity"][planar])),
        "border_points": int(border.sum())}
    rng = np.random.default_rng(0)
    sub = crop[rng.choice(len(crop), min(PRODUCTS_KNN_SUBSET, len(crop)),
                          replace=False)]
    card_nbr = _knn_indices(torch.as_tensor(sub, device=dev),
                            PRODUCTS_K).cpu().numpy()
    cpu_nbr = _knn_indices(torch.as_tensor(sub), PRODUCTS_K).numpy()
    c64 = sub.astype(np.float64) - sub.astype(np.float64).mean(0)
    d, _ = cKDTree(c64).query(c64, PRODUCTS_K + 1)
    # rows the float32 expansion can order: the k-th and (k+1)-th squared
    # distances more than 8 float32 steps of the row's 2 |a|^2 apart
    tie = 8 * np.spacing(np.float32(2 * (c64 ** 2).sum(1)))
    clear = d[:, PRODUCTS_K] ** 2 - d[:, PRODUCTS_K - 1] ** 2 > tie
    same = np.array([set(x) == set(y) for x, y in zip(card_nbr, cpu_nbr)])
    out["border"]["knn_card_vs_cpu"] = {
        "rows": len(sub), "clear_rows": int(clear.sum()),
        "equal_clear": int(same[clear].sum()), "equal_all": int(same.sum()),
        "median_tie_m2": float(np.median(tie))}
    log(f"    border features: {out['border']}")
    gate("planarity", out["border"]["median_planarity"]
         >= PRODUCT_GATES["planarity"], out["border"]["median_planarity"])
    gate("verticality", out["border"]["median_verticality"]
         >= PRODUCT_GATES["verticality"], out["border"]["median_verticality"])
    if not same[clear].all():
        raise AssertionError(f"kNN card vs CPU: {out['border']}")

    # Poisson on the centres of the voxels that hold a face (the clouds'
    # scattered outliers fill voxels of 1-2 points), normals toward
    # camera 0
    C0 = np.asarray(e0.cameras[cams[0]].C, np.float64).ravel()
    centers = vox.centers[vox.counts >= PRODUCTS_MIN_VOXEL_POINTS]
    verts, faces, _ = timed("Poisson depth 8", lambda: poisson_reconstruct(
        centers, depth=8, viewpoint=C0, device=dev), times)
    vd = scene.surface_distance(verts)
    out["poisson"] = {"points": len(centers), "vertices": len(verts),
                      "faces": len(faces),
                      "median_surface_m": float(np.median(vd)),
                      "p90_surface_m": float(np.percentile(vd, 90))}
    log(f"    Poisson: {out['poisson']}")
    gate("poisson_median_m", out["poisson"]["median_surface_m"]
         <= PRODUCT_GATES["poisson_median_m"],
         out["poisson"]["median_surface_m"])

    # the targets from epoch 0's first frame into epochs 1 and 2
    master = e0.images[cams[0]]
    with open(root / "targets" / f"{Path(master.name).stem}.csv") as f:
        table = list(csv.DictReader(f))
    labels = [r["label"] for r in table]
    xy0 = np.array([[float(r["x"]), float(r["y"])] for r in table])
    slaves = [epoches[i].images[cams[0]] for i in ids[1:]]
    tracked = TrackTargets(master.path, slaves, xy0,
                           out_dir=root / "tracked_targets_default",
                           target_names=labels, device=dev).track()
    out["targets_default_config"] = {k: v["snr"].tolist()
                                     for k, v in tracked.items()}
    log(f"    targets at TrackTargets' defaults, SNR: "
        f"{out['targets_default_config']}")
    tracked = timed("target tracking", lambda: TrackTargets(
        master.path, slaves, xy0, out_dir=root / "tracked_targets",
        target_names=labels, device=dev, **PRODUCTS_TARGETS).track(), times)
    out["targets"] = {}
    for stem, r in tracked.items():
        px = np.linalg.norm(r["xy"] - np.round(xy0), axis=1)
        out["targets"][stem] = {"snr": r["snr"].tolist(),
                                "px": px.tolist(), "ok": r["ok"].tolist()}
        gate(f"target_snr_{stem}", bool(np.all(
            r["snr"] >= PRODUCT_GATES["target_snr"])), r["snr"].tolist())
        gate(f"target_px_{stem}", bool(r["ok"].all() and np.all(
            px <= PRODUCT_GATES["target_px"])), px.tolist())
    log(f"    targets: {out['targets']}")

    # the tracked points' time series
    series = timed("time series", lambda: tracked_points_time_series(
        epoches), times)
    disp = compute_displacements(series)
    n_rows = len(tracked_time_series_to_df(series, epoches))
    first = np.array([series[t][min(series[t])] for t in disp["track_id"]])
    fi = scene.face_index(first)
    stable = disp["displacement"].to_numpy()[(fi == 0) | (fi == 2)]
    tongue = disp["displacement"].to_numpy()[fi == 1]
    out["time_series"] = {
        "tracks": len(disp), "rows": n_rows, "stable": len(stable),
        "tongue": len(tongue),
        "stable_median_m": float(np.median(stable)) if len(stable) else None,
        "tongue_median_m": float(np.median(tongue)) if len(tongue) else None}
    log(f"    time series: {out['time_series']}")
    gate("stable_track_m", len(stable) > 0 and np.median(stable)
         <= PRODUCT_GATES["stable_track_m"],
         out["time_series"]["stable_median_m"])

    # exports of epoch 0, read back
    ex = root / "exports"
    c0, c1 = cams[:2]
    kp = {c: e0.features[c].kpts_to_numpy() for c in (c0, c1)}
    n = min(len(kp[c0]), len(kp[c1]))
    matches = {(c0, c1): np.stack([np.arange(n), np.arange(n)], -1)}
    pids = e0.points.track_ids_to_numpy()
    aligned = {}
    for c in (c0, c1):
        tid = e0.features[c].track_ids_to_numpy()
        row = {int(t): i for i, t in enumerate(tid)}
        aligned[c] = Features.from_numpy(kp[c][[row[int(t)] for t in pids]])

    def export():
        export_solution_to_colmap_binary(ex / "colmap", e0.images,
                                         e0.cameras, e0.points)
        export_to_colmap_database(ex / "colmap.db", e0.images, e0.cameras,
                                  e0.features, matches)
        write_bundler_out(ex / "bundler", "epoch0", e0.images, e0.cameras,
                          aligned, e0.points)
        export_keypoints_for_calge(ex / "calge_kp.txt", e0.features,
                                   e0.images)
        export_points3D_for_calge(ex / "calge_p3.txt", e0.points)

    timed("exports", export, times)
    xyz = e0.points.to_numpy()
    cam_m, img_m, pts_m = read_colmap_model(ex / "colmap")
    got = np.array([pts_m[int(t)].xyz for t in pids])
    ok_colmap = (len(cam_m) == 2 and np.array_equal(got, xyz.astype(
        np.float64)) and all(np.allclose(img_m[i + 1].qvec2rotmat(),
                                         e0.cameras[c].R, atol=1e-6)
                             for i, c in enumerate(cams)))
    db = COLMAPDatabase.connect(ex / "colmap.db")
    try:
        ok_db = (np.array_equal(db.read_keypoints(1)[:, :2], kp[c0])
                 and np.array_equal(db.read_matches(1, 2), matches[(c0, c1)]))
    finally:
        db.close()
    _, bxyz, bobs = read_bundler_out(ex / "bundler" / "epoch0.out")
    ok_bundler = (np.array_equal(bxyz.astype(np.float32), xyz)
                  and len(bobs) == len(xyz))
    # CALGE's fixed-width rows: a header, then per camera its image name,
    # one "id x y" row a keypoint and -99; "id X Y Z" rows and -99
    lines = (ex / "calge_kp.txt").read_text().splitlines()[1:]
    ends = [i for i, ln in enumerate(lines) if ln == "-99"]
    starts = [0] + [e + 1 for e in ends[:-1]]
    calge_kp = [np.array([ln.split()[1:] for ln in lines[a + 1:e]], float)
                for a, e in zip(starts, ends)]
    p3 = np.array([ln.split()[1:] for ln in
                   (ex / "calge_p3.txt").read_text().splitlines()
                   if ln != "-99"], float)
    # written with one and four decimals
    ok_calge = (len(calge_kp) == len(e0.features)
                and all(np.abs(a - e0.features[c].kpts_to_numpy()).max()
                        <= 0.05 + 1e-6 for a, c in zip(calge_kp, e0.features))
                and np.abs(p3 - xyz).max() <= 5e-5 + 1e-9)
    out["exports"] = {"colmap": bool(ok_colmap), "database": bool(ok_db),
                      "bundler": bool(ok_bundler), "calge": bool(ok_calge),
                      "points": len(xyz)}
    log(f"    exports read back: {out['exports']}")
    if not (ok_colmap and ok_db and ok_bundler and ok_calge):
        raise AssertionError(f"exports {out['exports']}")

    torch.cuda.synchronize()
    out["launches"] = read_counts()
    out["times"] = times
    log(f"  products launches {out['launches']}; stage times on {card_line()}"
        f": " + ", ".join(f"{k} {v['warm_s']:.3f}" for k, v in times.items()))
    if any(out["launches"].values()):
        raise AssertionError(f"products launched kernels: {out['launches']}")
    if fails:
        raise AssertionError("products gates failed: " + "; ".join(fails))
    return out


# -- phase 18: training ---------------------------------------------------------

TRAIN_LOSS_RTOL = 1e-4         # card against CPU, one step's loss
TRAIN_GRAD_TOL = 1e-3          # ... each gradient, of its largest magnitude
TRAIN_RECALL_DROP = 0.05       # trained LightGlue's recall below the loaded
# Phase 18's sizes: the published widths and the trainers' defaults, cut
# in steps and cached batches only (a CPU rehearsal shrinks them all)
TRAINING = {"sp_steps": 300, "sp_batch": 32, "sp_cached": 32,
            "ha_patches": 8, "lg_batches": 8, "lg_eval": 2, "lg_batch": 16,
            "lg_keypoints": 512, "lg_steps": 200,
            "ft_batches": 4, "ft_steps": 100, "al_steps": 100,
            "al_batch": 16, "al_batches": 64, "chunk": 50, "reps": 10}


def grads_of(params) -> dict:
    return {n: p.grad.detach().cpu() for n, p in params}


def compare_step(label: str, card: tuple, cpu: tuple) -> dict:
    """(loss, grads) of one train step on the card and on the CPU: the
    loss within TRAIN_LOSS_RTOL relative, each gradient tensor within
    TRAIN_GRAD_TOL of its largest magnitude."""
    (lc, gc), (lh, gh) = card, cpu
    rel = abs(lc - lh) / abs(lh)
    worst, worst_name = 0.0, None
    for name, ref in gh.items():
        scale = float(ref.abs().max())
        err = float((gc[name] - ref).abs().max()) / max(scale, 1e-30)
        if err > worst:
            worst, worst_name = err, name
    log(f"  {label}: loss card {lc:.7f} cpu {lh:.7f} (rel {rel:.2e}), "
        f"worst gradient {worst:.2e} of its max ({worst_name})")
    if not (rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_TOL):
        raise AssertionError(f"{label} card against CPU: loss rel {rel}, "
                             f"gradient {worst} ({worst_name})")
    return {"loss_card": lc, "loss_cpu": lh, "loss_rel": rel,
            "grad_rel_max": worst, "grad_worst": worst_name}


def step_ms(step, args, reps: int) -> float:
    """Warm host time of one train step (two warm-up steps, then `reps`
    steps ending in a synchronise)."""
    for _ in range(2):
        step(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def training_path(dev, reset_counts, read_counts, image_dir, results_dir,
                  root) -> dict:
    """Phase 18: the trainers at their published widths on the card,
    on phase 7's frames and epochs (sizes in TRAINING). Returns what the
    JSON line reports; `launches` holds the NMS and attention launches
    of (d), (e) and (g)."""
    from icepy4d_tpu_torch.device import full_f32_matmul
    from icepy4d_tpu_torch.models import ALIKED, LightGlue, SuperPoint
    from icepy4d_tpu_torch.models import convert
    from icepy4d_tpu_torch.models.superpoint import SuperPointNet
    from icepy4d_tpu_torch.training import _optim
    from icepy4d_tpu_torch.training import aliked_train as at
    from icepy4d_tpu_torch.training import lightglue_train as lt
    from icepy4d_tpu_torch.training import superpoint_train as st
    from icepy4d_tpu_torch.training.synthetic import (load_real_patch_pool,
                                                      make_pair_batch)

    z = TRAINING
    cpu = torch.device("cpu")
    out = {"card": card_line(), "sizes": dict(z), "times_s": {}}
    times = out["times_s"]
    t_phase = time.perf_counter()
    sp_tree = convert.load_params(convert.bundled_checkpoint(
        "superpoint_synthetic.npz"))
    lg_tree = convert.load_params(convert.bundled_checkpoint(
        "lightglue_synthetic.npz"))
    al_tree = convert.load_params(convert.bundled_checkpoint(
        "aliked_synthetic.npz"))
    t0 = time.perf_counter()
    pool = load_real_patch_pool(image_dir)
    times["pool_decode"] = time.perf_counter() - t0
    log(f"training path: pool of {len(pool)} frames "
        f"{pool[0].shape[1]}x{pool[0].shape[0]} decoded in "
        f"{times['pool_decode']:.1f} s")

    def superpoint(device, max_keypoints, state):
        return SuperPoint(max_keypoints=max_keypoints,
                          detection_threshold=0.0005, device=device
                          ).load_state_dict(state)

    # -- (a) one step on the card against the CPU, f32 without TF32 ----------
    rng = np.random.default_rng(18)
    sp_batch = make_pair_batch(rng, 2, 120, 160)
    al_batch = make_pair_batch(rng, 2, 240, 320) + (
        np.ones(2, np.float32),)
    recorded = {}

    def sp_step(device):
        net = SuperPointNet()
        net.load_state_dict(convert.superpoint_state_dict(sp_tree))
        net.to(device)
        m = st.make_train_step(net, _optim.superpoint_optimizer(
            net.parameters(), 1e-3))(
            *(torch.from_numpy(a).to(device) for a in sp_batch))
        return float(m["loss"]), grads_of(net.named_parameters())

    def al_step(device, peaks):
        model = ALIKED(device=device).load_state_dict(
            convert.aliked_params(al_tree))

        def detect(score, k, r):
            # the card's peaks anchor both runs (they are supervision,
            # not gradient paths); the CPU's own are compared below
            got = at._detect_peaks(score, k, r)
            recorded[device.type] = got
            return got if peaks is None else \
                tuple(t.to(score.device) for t in peaks)

        opt = _optim.aliked_optimizer(model.model.parameters(), 3e-4, 100)
        loss = at.make_train_step(model, opt, detect_fn=detect)(
            *(torch.from_numpy(a).to(device) for a in al_batch))
        return float(loss), grads_of(model.model.named_parameters())

    def lg_step(device, batch):
        model = LightGlue(device=device)
        model.load_state_dict(convert.lightglue_params(lg_tree))
        m = lt.make_train_step(model, _optim.Adam(
            model.parameters(), 1e-4, clip_norm=1.0))(
            {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        return float(m["loss"]), grads_of(model.named_parameters())

    step_check = {}
    with full_f32_matmul():
        step_check["superpoint"] = compare_step(
            "SuperPoint 120x160 b2", sp_step(dev), sp_step(cpu))
        card = al_step(dev, None)
        card_peaks = recorded[dev.type]
        step_check["aliked"] = compare_step(
            "ALIKED 240x320 b2", card, al_step(cpu, card_peaks))
    peaks_equal = float((card_peaks[0].cpu() == recorded["cpu"][0])
                        .all(-1).float().mean())
    step_check["aliked"]["own_peaks_equal"] = peaks_equal
    log(f"  ALIKED: share of the CPU's own peaks equal to the card's "
        f"{peaks_equal:.4f}")

    # -- (b) SuperPoint at its published width and defaults ---------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp_state, sp_hist = st.train_superpoint(
        steps=z["sp_steps"], batch=z["sp_batch"], h=120, w=160, lr=1e-3,
        seed=0, n_cached_batches=z["sp_cached"], scan_chunk=z["chunk"],
        device=dev)
    torch.cuda.synchronize()
    times["superpoint_train"] = time.perf_counter() - t0
    net = SuperPointNet()
    net.load_state_dict(sp_state)
    net.to(dev)
    batch = [torch.from_numpy(a).to(dev) for a in make_pair_batch(
        np.random.default_rng(1), z["sp_batch"], 120, 160)]
    sp_ms = step_ms(st.make_train_step(
        net, _optim.Adam(net.parameters(), 1e-3)), batch, z["reps"])
    del net
    means = [h["chunk_mean"] for h in sp_hist]
    out["superpoint"] = {"warm_ms_per_step": sp_ms, "chunk_means": means,
                         "run_s": times["superpoint_train"]}
    log(f"  SuperPoint: {z['sp_steps']} steps of {z['sp_batch']} at "
        f"120x160 in {times['superpoint_train']:.1f} s (data made on the "
        f"host included), warm {sp_ms:.2f} ms/step, chunk means "
        f"{[round(m, 4) for m in means]}")
    if not means[-1] < means[0]:
        raise AssertionError(f"SuperPoint loss did not fall: {means}")

    # -- (c) homographic adaptation on phase 7's frames -------------------------
    t0 = time.perf_counter()
    ha_imgs, ha_labels = st.homographic_adaptation(
        convert.superpoint_state_dict(sp_tree), pool,
        np.random.default_rng(19),
        n_patches=z["ha_patches"], n_warps=24, device=dev)
    times["homographic_adaptation"] = time.perf_counter() - t0
    n_labels = int((ha_labels < 64).sum())
    out["homographic_adaptation"] = {
        "pseudo_labels": n_labels, "run_s": times["homographic_adaptation"]}
    log(f"  homographic adaptation: {z['ha_patches']} patches x 24 warps, "
        f"{n_labels} pseudo-labels, {times['homographic_adaptation']:.2f} s")
    if ha_imgs.shape != (z["ha_patches"], 120, 160) or not n_labels:
        raise AssertionError(f"homographic adaptation {ha_imgs.shape}, "
                             f"{n_labels} labels")

    # -- (d) LightGlue, homography stage ---------------------------------------
    sp = superpoint(dev, z["lg_keypoints"],
                    convert.superpoint_state_dict(sp_tree))
    launches = {}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ds = lt.make_lightglue_dataset(
        np.random.default_rng(20), sp.extract, n_batches=z["lg_batches"],
        batch=z["lg_batch"], h=240, w=320, real_pool=pool)
    torch.cuda.synchronize()
    times["lightglue_dataset"] = time.perf_counter() - t0
    launches["dataset"] = read_counts()
    n_train = z["lg_batches"] - z["lg_eval"]
    train_ds = {k: v[:n_train] for k, v in ds.items()}
    eval_ds = {k: v[n_train:] for k, v in ds.items()}
    with full_f32_matmul():
        b2 = {k: v[0, :2] for k, v in ds.items()}
        step_check["lightglue"] = compare_step(
            f"LightGlue 9 layers, {z['lg_keypoints']} keypoints, b2",
            lg_step(dev, b2), lg_step(cpu, b2))
    out["card_vs_cpu"] = step_check

    lg = LightGlue(device=dev)
    lg.load_state_dict(convert.lightglue_params(lg_tree))
    reset_counts()
    before = lt.evaluate_matching(lg, None, eval_ds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg_state, lg_hist = lt.train_lightglue(
        lg, train_ds, steps=z["lg_steps"], lr=2e-4,
        params=convert.lightglue_params(lg_tree), scan_chunk=z["chunk"],
        warmup=20, log=lambda s: None)
    torch.cuda.synchronize()
    times["lightglue_train"] = time.perf_counter() - t0
    after = lt.evaluate_matching(lg, None, eval_ds)
    launches["evaluate"] = read_counts()
    lg_time = LightGlue(device=dev)
    lg_time.load_state_dict(lg_state)
    lg_ms = step_ms(lt.make_train_step(lg_time, _optim.Adam(
        lg_time.parameters(), 1e-4, clip_norm=1.0)), ({
            k: torch.from_numpy(v[0]).to(dev)
            for k, v in train_ds.items()},), z["reps"])
    del lg_time
    out["lightglue"] = {
        "run_s": times["lightglue_train"], "warm_ms_per_step": lg_ms,
        "dataset_s": times["lightglue_dataset"],
        "chunk_means": [h["chunk_mean"] for h in lg_hist],
        "recall_gt": [h["recall_gt"] for h in lg_hist],
        "eval_before": before, "eval_after": after}
    log(f"  LightGlue: dataset of {z['lg_batches']} x {z['lg_batch']} "
        f"pairs in {times['lightglue_dataset']:.1f} s (launches "
        f"{launches['dataset']}), {z['lg_steps']} steps in "
        f"{times['lightglue_train']:.1f} s, warm {lg_ms:.1f} ms/step, chunk "
        f"means {[round(h['chunk_mean'], 4) for h in lg_hist]}; held out: "
        f"before {before}, after {after}; evaluation launches "
        f"{launches['evaluate']}")
    n_chunks = -(-z["lg_batches"] * z["lg_batch"] // 64)
    if launches["dataset"] != {"nms": 2 * n_chunks, "attention": 0,
                               "sweep": 0, "dual_softmax": 0}:
        raise AssertionError(f"dataset launches {launches['dataset']}")
    if launches["evaluate"] != {"nms": 0, "sweep": 0, "dual_softmax": 0,
                                "attention": 2 * 36 * z["lg_eval"]}:
        raise AssertionError(f"evaluation launches {launches['evaluate']}")
    if after["recall"] < before["recall"] - TRAIN_RECALL_DROP:
        raise AssertionError(f"LightGlue recall {before['recall']} -> "
                             f"{after['recall']}")

    # -- (e) the fine-tune on phase 7's verified correspondences ----------------
    reset_counts()
    t0 = time.perf_counter()
    pairs = lt.collect_epoch_pairs(results_dir, image_scale=0.25)
    corr = lt.make_correspondence_dataset(
        np.random.default_rng(21), sp.describe_at, sp.extract, pairs,
        n_batches=z["ft_batches"], batch=z["lg_batch"],
        n_kpts=z["lg_keypoints"])
    homog = lt.homography_to_explicit(train_ds, device=dev)
    mixed = {k: np.concatenate([corr[k], homog[k]]) for k in corr}
    torch.cuda.synchronize()
    times["finetune_dataset"] = time.perf_counter() - t0
    launches["finetune"] = read_counts()
    t0 = time.perf_counter()
    ft_state, ft_hist = lt.train_lightglue(
        lg, mixed, steps=z["ft_steps"], lr=5e-5, params=lg_state,
        scan_chunk=z["chunk"], log=lambda s: None)
    torch.cuda.synchronize()
    times["finetune_train"] = time.perf_counter() - t0
    n_corr = [len(p["corr0"]) for p in pairs]
    out["finetune"] = {
        "pairs": len(pairs), "correspondences": n_corr,
        "frame": list(pairs[0]["img0"].shape) if pairs else None,
        "dataset_s": times["finetune_dataset"],
        "run_s": times["finetune_train"],
        "chunk_means": [h["chunk_mean"] for h in ft_hist],
        "recall_gt": [h["recall_gt"] for h in ft_hist]}
    log(f"  fine-tune: {len(pairs)} epoch pairs ({n_corr} verified "
        f"correspondences, frames {out['finetune']['frame']}), "
        f"{z['ft_batches']} real + {n_train} homography batches in "
        f"{times['finetune_dataset']:.1f} s (launches "
        f"{launches['finetune']}), {z['ft_steps']} steps in "
        f"{times['finetune_train']:.1f} s, chunk means "
        f"{[round(h['chunk_mean'], 4) for h in ft_hist]}")
    if len(pairs) != 3 or launches["finetune"] != {
            "nms": 2 * len(pairs), "attention": 0, "sweep": 0,
            "dual_softmax": 0}:
        raise AssertionError(f"fine-tune pairs {len(pairs)}, launches "
                             f"{launches['finetune']}")
    if not all(np.isfinite(h["chunk_mean"]) for h in ft_hist):
        raise AssertionError(f"fine-tune history {ft_hist}")

    # -- (f) ALIKED at its defaults ---------------------------------------------
    al = ALIKED(device=dev).load_state_dict(convert.aliked_params(al_tree))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    al_logs = []
    al_state = at.train_aliked(
        al, None, steps=z["al_steps"], batch=z["al_batch"], h=240, w=320,
        seed=0, n_batches=z["al_batches"], real_pool=pool,
        scan_chunk=z["chunk"], log=al_logs.append)
    torch.cuda.synchronize()
    times["aliked_train"] = time.perf_counter() - t0
    al_time = ALIKED(device=dev).load_state_dict(al_state)
    al_args = [torch.from_numpy(a).to(dev) for a in make_pair_batch(
        np.random.default_rng(2), z["al_batch"], 240, 320)] + [
        torch.ones(z["al_batch"], device=dev)]
    al_ms = step_ms(at.make_train_step(al_time, _optim.aliked_optimizer(
        al_time.model.parameters(), 3e-4, z["al_steps"])), al_args,
        z["reps"])
    del al_time
    out["aliked"] = {"run_s": times["aliked_train"],
                     "warm_ms_per_step": al_ms, "log": al_logs}
    log(f"  ALIKED: {z['al_steps']} steps of {z['al_batch']} at 240x320 in "
        f"{times['aliked_train']:.1f} s ({z['al_batches']} cached batches "
        f"made on the host included), warm {al_ms:.1f} ms/step, {al_logs}")
    if not all(np.isfinite(float(s.split()[-1])) for s in al_logs):
        raise AssertionError(f"ALIKED losses {al_logs}")

    # -- (g) checkpoints written and read back ------------------------------------
    ckpt = Path(root) / "trained"
    ckpt.mkdir(exist_ok=True)
    saved = {}
    for name, state, to_tree, to_port in (
            ("superpoint", sp_state, convert.superpoint_tree_from_state_dict,
             convert.superpoint_state_dict),
            ("lightglue", ft_state, convert.lightglue_tree_from_state_dict,
             convert.lightglue_params),
            ("aliked", al_state, convert.aliked_tree_from_state_dict,
             convert.aliked_params)):
        path = ckpt / f"{name}.npz"
        convert.save_params(path, to_tree(state))
        back = to_port(convert.load_params(path))
        equal = list(back) == list(state) and all(
            torch.equal(back[k], state[k].cpu()) for k in state)
        saved[name] = {"bytes": path.stat().st_size, "bitwise": equal}
        if not equal:
            raise AssertionError(f"{name} checkpoint does not read back")
    imgs = torch.from_numpy(np.stack([p[:240, :320] for p in pool[:2]]))
    reset_counts()
    a = superpoint(dev, 512, sp_state).extract(imgs)
    b = superpoint(dev, 512, convert.superpoint_state_dict(
        convert.load_params(ckpt / "superpoint.npz"))).extract(imgs)
    same = all(torch.equal(a[k], b[k]) for k in a)
    saved["superpoint_extract_bitwise"] = same
    launches["checkpoint"] = read_counts()
    out["checkpoints"] = saved
    log(f"  checkpoints: {saved}, launches {launches['checkpoint']}")
    if not same or launches["checkpoint"]["nms"] != 2:
        raise AssertionError("the reloaded SuperPoint extracts otherwise")

    out["launches"] = {k: sum(c[k] for c in launches.values())
                       for k in ("nms", "attention")}
    out["launches_by_step"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  training path: {out['phase_s']:.1f} s, launches "
        f"{out['launches']} on {out['card']}")
    return out


# -- phase 20: ring attention, the sequence- and pipeline-parallel matchers ----

SHARDED_KEYPOINTS = 16384      # phase 20's full-frame token set a frame
SHARDED_SLOTS = 4              # sequence shards, all on the card
PP_LIGHTGLUE_STAGES = 3        # 9 layers / 3
PP_LOFTR_STAGES = 4            # 4 coarse pairs / 4
# Gates of phase 20. The ring and the sharded forwards compute in f32
# what their dense counterparts compute, in other orders. The first H100
# run (NVIDIA H100 80GB HBM3, 700 W) read: ring attention 3.4e-6 and
# 4.6e-6 of the largest output off dense_attention (gate 1.5e-5, ~3x);
# the sequence-parallel LightGlue's and SuperGlue's match decisions all
# equal to the dense forwards' over dense_attention (gate 0.99, the JAX
# package's bar), mscores within 0.52 and 0.04 of the rtol 1e-3 / atol
# 1e-5 bar (kept), LightGlue's 0.9962 equal to the dense forward's over
# the attention kernel (gate 0.988, ~3x the disagreement; phase 5's
# yardstick is 0.98) and 0.947 of its mutual matches within 1.5 px of
# the shift (gate 0.9, phase 4's); the pipeline-parallel LightGlue's
# matches and log assignment bit for bit the dense forward's (gates
# 0.999 and 1e-3 kept); the staged LoFTR 1.2e-5 off (gate 4e-5, ~3x).
SHARDED_GATES = {"ring_rel": 1.5e-5, "sp_agree": 0.99,
                 "sp_kernel_agree": 0.988, "mscore_rtol": 1e-3,
                 "mscore_atol": 1e-5, "precision": 0.9, "pp_agree": 0.999,
                 "pp_logassign": 1e-3, "loftr": 4e-5}


def slot_agreement(a: torch.Tensor, b: torch.Tensor,
                   valid: torch.Tensor) -> float:
    """Share of the valid slots where the two match decisions agree."""
    return ((a == b) & valid).sum().item() / max(valid.sum().item(), 1)


def hold_matches(label: str, got: dict, ref: dict, data: dict, bar: float,
                 scores: bool = True) -> dict:
    """matches0 and matches1 agreement over the valid slots (>= bar) and,
    with `scores`, mscores0 within the gates' rtol / atol where both
    match ("mscores_gate": the largest |a - b| / (atol + rtol |b|), <= 1)."""
    g = SHARDED_GATES
    agree = {k: slot_agreement(got[f"matches{s}"], ref[f"matches{s}"],
                               data[f"mask{s}"])
             for s, k in ((0, "matches0"), (1, "matches1"))}
    both = (got["matches0"] > -1) & (got["matches0"] == ref["matches0"])
    a, b = got["mscores0"][both], ref["mscores0"][both]
    diff = (a - b).abs()
    rel = (diff / b.abs().clamp_min(1e-12)).max().item() if a.numel() \
        else 0.0
    ratio = (diff / (g["mscore_atol"] + g["mscore_rtol"] * b.abs())
             ).max().item() if a.numel() else 0.0
    out = dict(agree, mscores_max_rel=rel, mscores_gate=ratio,
               both_matched=int(both.sum()))
    log(f"  {label}: agreement matches0 {agree['matches0']:.5f}, matches1 "
        f"{agree['matches1']:.5f}; {out['both_matched']} matched in both, "
        f"mscores within {rel:.3e} relative ({ratio:.3f} of the gate)")
    if min(agree.values()) < bar or not out["both_matched"] \
            or (scores and ratio > 1.0):
        raise AssertionError(f"{label}: {out}")
    return out


def timed_forward(fn, data) -> tuple:
    """fn(data) cold, then warm: (warm output, cold s, warm s, the warm
    run's peak of torch.cuda.max_memory_allocated, what was allocated
    before it), in bytes."""
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn(data)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, times[0], times[1], torch.cuda.max_memory_allocated(), base


def forward_record(label: str, timed: tuple) -> dict:
    _, cold, warm, peak, base = timed
    log(f"  {label}: cold {cold:.3f} s, warm {warm:.3f} s, peak "
        f"max_memory_allocated {peak / 2**30:.2f} GiB ({base / 2**30:.2f} "
        f"GiB held before)")
    return {"cold_s": cold, "warm_s": warm, "peak_gib": peak / 2**30,
            "base_gib": base / 2**30}


def pad_tokens(data: dict, multiple: int) -> dict:
    """The token dims of a matcher's data padded to a multiple, the
    padding masked."""
    n = data["mask0"].shape[1]
    pad = (-n) % multiple
    if not pad:
        return data
    out = {}
    for k, v in data.items():
        if k.startswith("size"):
            out[k] = v
        else:
            widths = [0, 0] * (v.ndim - 2) + [0, pad]
            out[k] = torch.nn.functional.pad(v, widths)
    return out


def sharded_path(dev, reset_counts, read_counts, img0, img1, tile_pairs: dict,
                 coarse: tuple, n_tokens: int = SHARDED_KEYPOINTS) -> dict:
    """Phase 20 (see the module doc). `tile_pairs`: phase 4's first pair
    chunk cut to 4 pairs; `coarse`: (the coarse LoFTR layers, c0, c1,
    mask0, mask1) of phase 15's first pair chunks, at least
    PP_LOFTR_STAGES pairs in all. Returns what the JSON
    line reports; "launches" are the kernels' launches of the forwards
    it drives (the input extraction, the dense LightGlue over the kernel
    and the pipeline-parallel LightGlue)."""
    from icepy4d_tpu_torch.matching import (GeometricVerification,
                                            LightGlueMatcher, Quality,
                                            SuperGlueMatcher, TileSelection)
    from icepy4d_tpu_torch.models.loftr import LoFTR, lft_apply
    from icepy4d_tpu_torch.ops.attention import dense_attention
    from icepy4d_tpu_torch.parallel import (
        make_mesh, make_pipeline_parallel_lightglue,
        make_pipeline_parallel_loftr_coarse, make_ring_attention,
        make_sequence_parallel_lightglue, make_sequence_parallel_superglue)

    g = SHARDED_GATES
    t_phase = time.perf_counter()
    card = card_line()
    seq = make_mesh(SHARDED_SLOTS, dp=1, tp=SHARDED_SLOTS,
                    axis_names=("data", "seq"))
    out = {"seq_mesh": seq.shape, "card": card}
    launches = dict.fromkeys(read_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    log(f"ring attention and the sharded matchers ({SHARDED_SLOTS} "
        f"sequence slots on {sorted(set(map(str, seq.slots('seq'))))}), on "
        f"{card}:")

    # -- (a) ring attention against dense_attention, f32, no TF32
    q, k, v, mask = attention_inputs(1, 4, n_tokens, n_tokens, dev, seed=3)
    blk = n_tokens // SHARDED_SLOTS
    mask[:, blk:2 * blk] = False        # one ring block wholly masked
    ring = make_ring_attention(seq)
    ring_err = {}
    for name, m in (("padded", mask), ("all_masked", torch.zeros_like(mask))):
        reset_counts()
        got = ring(q, k, v, m)
        torch.cuda.synchronize()
        if read_counts()["attention"]:
            raise AssertionError("ring attention launched the kernel")
        ref = dense_attention(q, k, v, m)
        ring_err[name] = ((got - ref).abs().max()
                          / ref.abs().max()).item()
        del got, ref
    ring_ms = cuda_ms(lambda: ring(q, k, v, mask), 3)
    dense_ms = cuda_ms(lambda: dense_attention(q, k, v, mask), 3)
    out["ring"] = {"shape": (1, 4, n_tokens, 64), "rel_err": ring_err,
                   "ms": ring_ms, "dense_attention_ms": dense_ms}
    log(f"  (a) ring attention (1, 4, {n_tokens}, 64) f32 against "
        f"dense_attention: {ring_err['padded']:.3e} of the largest output "
        f"with a 0.9 padding mask and a masked block, "
        f"{ring_err['all_masked']:.3e} with every key masked (uniform "
        f"averages); no kernel launch; {ring_ms:.3f} ms against dense "
        f"{dense_ms:.3f} ms")
    if max(ring_err.values()) > g["ring_rel"]:
        raise AssertionError(f"ring attention error {ring_err}")
    del q, k, v, mask
    torch.cuda.empty_cache()

    # -- (b) sequence-parallel LightGlue on both full frames
    matcher = LightGlueMatcher({"max_keypoints": n_tokens,
                                "activation_dtype": "float32"})
    reset_counts()
    matcher.match(img0, img1, quality=Quality.HIGH,
                  tile_selection=TileSelection.NONE,
                  geometric_verification=GeometricVerification.PYDEGENSAC,
                  threshold=1.0)
    torch.cuda.synchronize()
    add(read_counts())
    f0, f1 = matcher._full_feats
    lg = matcher.matcher
    size = torch.tensor([[W_IMG, H_IMG]], dtype=torch.float32, device=dev)
    data = pad_tokens({
        "kpts0": f0["keypoints"], "desc0": f0["descriptors"],
        "scores0": f0["scores"], "mask0": f0["mask"], "size0": size,
        "kpts1": f1["keypoints"], "desc1": f1["descriptors"],
        "scores1": f1["scores"], "mask1": f1["mask"], "size1": size},
        SHARDED_SLOTS)
    n = data["mask0"].shape[1]
    log(f"  (b) sequence-parallel LightGlue ({lg.n_layers} layers, f32 "
        f"trunk, bundled weights) on both {W_IMG}x{H_IMG} frames untiled: "
        f"{n} tokens a frame, {int(data['mask0'].sum())} / "
        f"{int(data['mask1'].sum())} valid")
    sp_lg = make_sequence_parallel_lightglue(seq, lg)
    runs = {"sharded": timed_forward(sp_lg, data),
            "dense_attention": timed_forward(
                partial(lg.match, attn=dense_attention), data)}
    reset_counts()
    runs["dense_kernel"] = timed_forward(lg.match, data)
    kernel_counts = read_counts()
    if kernel_counts["attention"] != 2 * 4 * lg.n_layers:
        raise AssertionError(f"dense LightGlue launches {kernel_counts}")
    add({"attention": 4 * lg.n_layers})
    res = {name: forward_record(f"LightGlue {name}", r)
           for name, r in runs.items()}
    sp = runs["sharded"][0]
    res["vs_dense_attention"] = hold_matches(
        "sharded vs dense (dense_attention)", sp, runs["dense_attention"][0],
        data, g["sp_agree"])
    # the kernel rounds q, k, v and the probabilities to bf16: the match
    # decisions are held to phase 5's yardstick, the scores not at all
    res["vs_kernel"] = hold_matches(
        "sharded vs dense (the attention kernel)", sp,
        runs["dense_kernel"][0], data, g["sp_kernel_agree"], scores=False)
    m0 = sp["matches0"][0]
    hit = m0 > -1
    err = (data["kpts0"][0][hit] - data["kpts1"][0][m0[hit].long()]
           - torch.tensor([DX, DY], device=dev)).norm(dim=1)
    res["mutual_matches"] = int(hit.sum())
    res["precision"] = (err < 1.5).float().mean().item() if err.numel() \
        else 0.0
    log(f"  sharded LightGlue: {res['mutual_matches']} mutual matches, "
        f"{res['precision']:.4f} within 1.5 px of the ({DX}, {DY}) shift")
    if res["precision"] < g["precision"]:
        raise AssertionError(f"sharded LightGlue precision {res['precision']}")
    out["lightglue_sp"] = res
    del runs, sp, matcher
    torch.cuda.empty_cache()

    # -- (c) sequence-parallel SuperGlue on the same tokens and slots
    sg = SuperGlueMatcher({"seed": 0, "match_threshold": 0.0}).matcher
    runs = {"sharded": timed_forward(
                make_sequence_parallel_superglue(seq, sg), data),
            "dense_attention": timed_forward(
                partial(sg.match, attn=dense_attention), data)}
    res = {name: forward_record(
        f"SuperGlue ({len(sg.gnn)} layers, {sg.sinkhorn_iterations} "
        f"Sinkhorn iterations, random weights) {name}", r)
        for name, r in runs.items()}
    res["vs_dense_attention"] = hold_matches(
        "sharded vs dense (dense_attention)", runs["sharded"][0],
        runs["dense_attention"][0], data, g["sp_agree"])
    out["superglue_sp"] = res
    del runs, sg, data, f0, f1
    torch.cuda.empty_cache()

    # -- (d) pipeline-parallel LightGlue over phase 4's tile pairs
    pp_mesh = make_mesh(PP_LIGHTGLUE_STAGES, dp=PP_LIGHTGLUE_STAGES, tp=1,
                        axis_names=("pp", "data"))
    n_micro = tile_pairs["mask0"].shape[0]
    pp = make_pipeline_parallel_lightglue(pp_mesh, lg, n_micro=n_micro)
    reset_counts()
    pp_run = timed_forward(pp, tile_pairs)
    pp_counts = read_counts()
    want = 2 * n_micro * 4 * lg.n_layers          # cold and warm
    dense_run = timed_forward(lg.match, tile_pairs)
    res = {"stages": PP_LIGHTGLUE_STAGES, "n_micro": n_micro,
           "batch": tuple(tile_pairs["mask0"].shape),
           "launches": pp_counts["attention"] // 2,
           "pipeline": forward_record(
               f"(d) pipeline-parallel LightGlue, {PP_LIGHTGLUE_STAGES} "
               f"stages, {n_micro} microbatches of "
               f"{tuple(tile_pairs['mask0'].shape[1:])} tile pairs", pp_run),
           "dense": forward_record("LightGlue dense, the same batch",
                                   dense_run)}
    got, ref = pp_run[0], dense_run[0]
    res["agreement"] = slot_agreement(got["matches0"], ref["matches0"],
                                      tile_pairs["mask0"])
    la, la_ref = got["log_assignment"], ref["log_assignment"]
    valid = la_ref > -1e8
    res["log_assignment_max_abs"] = (la - la_ref)[valid].abs().max().item()
    res["masked_equal"] = bool(torch.equal(la < -1e8, ~valid))
    log(f"  pipeline vs dense: matches0 agreement {res['agreement']:.5f}, "
        f"log assignment within {res['log_assignment_max_abs']:.3e}, "
        f"attention launches {res['launches']} a forward (want "
        f"{want // 2})")
    if pp_counts["attention"] != want or res["agreement"] < g["pp_agree"] \
            or res["log_assignment_max_abs"] > g["pp_logassign"] \
            or not res["masked_equal"]:
        raise AssertionError(f"pipeline-parallel LightGlue: {res}")
    add({"attention": res["launches"]})
    out["lightglue_pp"] = res
    del pp_run, dense_run, got, ref, la, la_ref, lg
    torch.cuda.empty_cache()

    # -- (e) pipeline-parallel LoFTR coarse transformer on phase 15's tokens
    layers = coarse[0][0]
    c0, c1, mask0, mask1 = (torch.cat([c[i] for c in coarse])
                            for i in range(1, 5))
    b = c0.shape[0] - c0.shape[0] % PP_LOFTR_STAGES
    if not b:
        raise AssertionError(f"phase 15 gave {c0.shape[0]} tile pairs")
    c0, c1, mask0, mask1 = (t[:b] for t in (c0, c1, mask0, mask1))
    model = LoFTR(device=dev)
    model.net.coarse.load_state_dict(layers.state_dict())
    pp_mesh = make_mesh(PP_LOFTR_STAGES, dp=PP_LOFTR_STAGES, tp=1,
                        axis_names=("pp", "data"))
    pp_coarse = make_pipeline_parallel_loftr_coarse(pp_mesh, model)
    reset_counts()
    pp_run = timed_forward(lambda x: pp_coarse(*x), (c0, c1, mask0, mask1))
    if any(read_counts().values()):
        raise AssertionError("the LoFTR stages launched a kernel")

    def batched(x):
        with torch.inference_mode():
            return lft_apply(model.net.coarse, *x, model.nhead)

    dense_run = timed_forward(batched, (c0, c1, mask0, mask1))
    err = max((a - r).abs().max().item()
              for a, r in zip(pp_run[0], dense_run[0]))
    res = {"stages": PP_LOFTR_STAGES, "batch": tuple(c0.shape),
           "max_abs": err,
           "pipeline": forward_record(
               f"(e) pipeline-parallel LoFTR coarse transformer, "
               f"{PP_LOFTR_STAGES} stages, {b} tile pairs of "
               f"{c0.shape[1]} coarse tokens", pp_run),
           "batched": forward_record("batched lft_apply", dense_run)}
    log(f"  staged vs batched lft_apply: {err:.3e}")
    if err > g["loftr"]:
        raise AssertionError(f"pipeline-parallel LoFTR: {res}")
    out["loftr_pp"] = res
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 20: {out['phase_s']:.1f} s, launches {launches}")
    return out


# -- phase 21: the command lines ---------------------------------------------

CLI_EPOCHS = 2                 # epochs of phase 7's season the commands run
# Gates of phase 21 (d), about 3x off the first H100 reading (20% under
# it for the verified matches): the single-epoch walkthrough on phase
# 7's epoch-0 frames read BA rmse 0.084 px, 6535 verified matches and
# centres 0.077 m from the surveyed ones (its world is the season's
# scaled 65x: the walkthrough's centres are 260 m apart, the season's
# 4 m, so its targets lie 6.5 km off); the matcher benchmark's NN and
# LightGlue kept 0.959 and 0.928 of their inliers within 1.5 px of the
# shift (gate: 3x the share off it).
WALKTHROUGH_GATES = {"rmse_px": 0.25, "verified": 5200, "centre_m": 0.25,
                     "bench_precision": 0.78}


def season_from_checkpoints(res: Path) -> list:
    from icepy4d_tpu_torch.core import Epoch

    return [Epoch.read_pickle(p) for p in sorted((res / "epochs").rglob(
        "*.pickle"))]


def check_cli_season(label: str, scene, cams, epochs, res: Path) -> list:
    """Phase 7's gates on a season the command wrote: every epoch ok
    without recovery, BA RMSE, relative rotation, distance to the faces,
    tie points, the dense cloud; CLI_EPOCHS checkpoints, dense PLYs and
    sink rows."""
    import csv
    from types import SimpleNamespace

    stats = season_stats(scene, SimpleNamespace(cams=cams), epochs)
    for st, e in zip(stats, epochs):
        pts = e.point_cloud.points
        d = scene.surface_distance(pts[::max(len(pts) // 200000, 1)])
        st["dense_points"] = len(pts)
        st["dense_surface_m"] = float(np.median(d))
        log(f"  {label}: {st['status']} {st['flags']}: putative "
            f"{st['n_putative']}, verified {st['n_matches']}, BA rmse "
            f"{st.get('ba_rmse_px', float('nan')):.4f} px, points "
            f"{st['n_points']}, rotation error "
            f"{st['rel_rotation_err_deg']:.5f} deg, surface "
            f"{st['median_surface_dist_m']:.4f} m, dense {len(pts)} points "
            f"at {st['dense_surface_m']:.4f} m")
        check_epoch(st, SEASON_GATES)
        if st["n_points"] < SEASON_GATES["points"] or \
                st["dense_points"] < SEASON_GATES["dense_points"] or not \
                st["dense_surface_m"] <= SEASON_GATES["dense_surface_m"]:
            raise AssertionError(f"{label} epoch below {SEASON_GATES}: {st}")
    rows = {}
    for name in ("residuals_image.csv", "estimated_cameras.csv"):
        with open(res / name) as f:
            rows[name] = len(list(csv.reader(f)))
    n_ply = len(list((res / "epochs").rglob("dense_*.ply")))
    if len(epochs) != CLI_EPOCHS or n_ply != CLI_EPOCHS or any(
            n != CLI_EPOCHS + 1 for n in rows.values()):
        raise AssertionError(f"{label}: {len(epochs)} checkpoints, {n_ply} "
                             f"dense PLYs, sink rows {rows}")
    return stats


def product_commands(dev, root: Path, plys: list) -> dict:
    """Phase 21 (c): the product commands in-process on two of phase 17's
    clouds, cut to PRODUCTS_CROP and turned z-up (x' = X, y' = Z,
    z' = -Y, phase 17's orthophoto frame), each held against the library
    call it wraps on the same input. Means of float32 sums that the card
    scatters with atomics, in no fixed order, are held within 8 float32
    steps of their largest magnitude (DSM elevations; voxel colours
    within 1e-5, as the CPU tests hold them), volumes within that step
    times the cells' area; counts, masks, indices, areas and everything
    else exactly."""
    import csv
    import shutil

    from icepy4d_tpu_torch.cli import (build_dem, extract_section,
                                       pcd_rototranslation, track_targets,
                                       update_dem, volume_variations,
                                       voxelization)
    from icepy4d_tpu_torch.io import read_ply, write_ply
    from icepy4d_tpu_torch.post_processing import (detect_border,
                                                   filter_pcd_by_polyline)
    from icepy4d_tpu_torch.post_processing import (
        volume_variations as lib_volume_variations)
    from icepy4d_tpu_torch.post_processing import voxelize
    from icepy4d_tpu_torch.utils import (Rototranslation, TrackTargets,
                                         belvedere_loc2utm,
                                         belvedere_utm2loc, build_dsm,
                                         dem_of_difference)
    from icepy4d_tpu_torch.utils.dsm_orthophoto import DSM
    from torch_port_inputs import SEASON_ORIGIN

    d = root / "cli_products"
    ins = d / "in"
    ins.mkdir(parents=True)
    R = np.array([[1.0, 0, 0], [0, 0, 1], [0, -1, 0]])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -R @ SEASON_ORIGIN
    loc = Rototranslation(T)
    poly = np.asarray(PRODUCTS_CROP) + SEASON_ORIGIN[[0, 2]]
    clouds = []
    for i, p in enumerate(plys[:2]):
        pts, rgb = read_ply(p)
        keep = filter_pcd_by_polyline(pts, poly, dir="x-z")
        pts = loc.transform(pts[keep]).astype(np.float32)
        rgb = rgb[keep]
        write_ply(ins / f"crop_2022_07_{28 + i}.ply", pts, rgb)
        pts, rgb = read_ply(ins / f"crop_2022_07_{28 + i}.ply")
        clouds.append((pts, rgb))
    pattern = str(ins / "crop_*.ply")
    out, times = {"points": [len(c[0]) for c in clouds]}, {}

    def run(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - t0
        return r

    def close(a, b, what, atol):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.shape != b.shape or not np.allclose(a, b, rtol=0.0, atol=atol,
                                                 equal_nan=True):
            raise AssertionError(f"{what}: the command's {a.shape} differs "
                                 f"from the library's {b.shape} by more "
                                 f"than {atol}")

    def equal(a, b, what):
        if not np.array_equal(np.asarray(a), np.asarray(b), equal_nan=(
                np.asarray(a).dtype.kind == "f")):
            raise AssertionError(f"{what}: the command differs from the "
                                 "library")

    # build_dem: the DSM of the first crop
    step = PRODUCTS_DSM_STEP
    dsm = run("build_dem", lambda: build_dem.main(
        [str(ins / "crop_2022_07_28.ply"), "--step", str(step), "--out",
         str(d / "dem0.npz"), "--geotiff", str(d / "dem0.tif")]))
    ref = build_dsm(clouds[0][0], dsm_step=step, fill_iters=10, device=dev)
    z = np.load(d / "dem0.npz")
    for k in ("mask", "xx", "yy"):
        equal(z[k], getattr(ref, k), f"build_dem {k}")
    z_tol = 8 * float(np.spacing(np.float32(np.nanmax(np.abs(ref.z)))))
    close(z["z"], ref.z, "build_dem z", z_tol)
    equal(dsm.count, ref.count, "build_dem count")
    out["build_dem"] = {"cells": int(ref.mask.sum()), "shape": list(
        ref.z.shape)}

    # update_dem: the second crop's DSM on the first's grid, merged
    p0 = clouds[0][0][np.isfinite(clouds[0][0]).all(1)]   # build_dsm's
    lims = [(float(np.floor(p0[:, i].min())), float(np.ceil(p0[:, i].max())))
            for i in (0, 1)]
    upd = build_dsm(clouds[1][0], dsm_step=step, fill_iters=10, device=dev,
                    xlim=lims[0], ylim=lims[1])
    np.savez_compressed(d / "dem1.npz", z=upd.z, mask=upd.mask, xx=upd.xx,
                        yy=upd.yy, res=upd.res)
    merged = run("update_dem", lambda: update_dem.main(
        [str(d / "dem0.npz"), str(d / "dem1.npz"), "--out",
         str(d / "merged.npz")]))
    base = DSM(z=z["z"], mask=z["mask"], xx=z["xx"], yy=z["yy"],
               res=float(z["res"]))
    _, rep = dem_of_difference(base, DSM(z=upd.z, mask=upd.mask, xx=upd.xx,
                                         yy=upd.yy, res=upd.res))
    equal(merged.z, np.where(upd.mask, upd.z, base.z), "update_dem z")
    equal(merged.mask, base.mask | upd.mask, "update_dem mask")
    out["update_dem"] = {"net_m3": rep.net, "area_m2": rep.area}

    # volume_variations over the two crops a day apart
    df = run("volume_variations", lambda: volume_variations.main(
        [pattern, "--out", str(d / "vol"), "--tstep", "1", "--grid-step",
         str(step), "--dir", "z", "--no-plots"]))
    lib = lib_volume_variations(sorted(ins.glob("crop_*.ply")), t_step=1,
                                grid_step=step, direction="z", out_dir=None,
                                base_name="crop", make_plots=False,
                                device=dev)
    equal(df[["pcd0", "pcd1"]].to_numpy(), lib[["pcd0", "pcd1"]].to_numpy(),
          "volume_variations pairs")
    equal(df[["surface", "matchingPercent"]].to_numpy(),
          lib[["surface", "matchingPercent"]].to_numpy(),
          "volume_variations surface")
    v_tol = 2 * z_tol * float(df["surface"].max())   # both DSMs' steps
    for col in ("volume", "addedVolume", "removedVolume"):
        close(df[col], lib[col], f"volume_variations {col}", v_tol)
    out["volume_variations"] = df[["pcd0", "pcd1", "volume",
                                   "matchingPercent"]].to_dict("records")

    # voxelization with the cube mesh
    grids = run("voxelization", lambda: voxelization.main(
        [pattern, "--voxel-size", str(PRODUCTS_VOXEL), "--out",
         str(d / "vox"), "--mesh"]))
    for (pts, rgb), grid in zip(clouds, grids.values()):
        g = voxelize(pts, rgb, voxel_size=PRODUCTS_VOXEL, device=dev)
        for k in ("indices", "counts", "centers", "origin"):
            equal(getattr(grid, k), getattr(g, k), f"voxelization {k}")
        close(grid.colors, g.colors, "voxelization colours", 1e-5)
    out["voxelization"] = [len(g.centers) for g in grids.values()]

    # extract_section: the border of each crop
    masks = run("extract_section", lambda: extract_section.main(
        [pattern, "--out", str(d / "border"), "--k", str(PRODUCTS_K)]))
    for (pts, _), mask in zip(clouds, masks.values()):
        equal(mask, detect_border(pts, k=PRODUCTS_K, device=dev),
              "extract_section border")
    out["extract_section"] = [int(m.sum()) for m in masks.values()]

    # pcd_rototranslation both ways
    for mode, fn in (("loc2utm", belvedere_loc2utm),
                     ("utm2loc", belvedere_utm2loc)):
        tdir = d / mode
        tdir.mkdir()
        src = tdir / "crop_2022_07_28.ply"
        shutil.copy(ins / "crop_2022_07_28.ply", src)
        run(f"pcd_rototranslation {mode}", lambda tdir=tdir, mode=mode:
            pcd_rototranslation.main([str(tdir / "*.ply"), "--mode", mode]))
        (moved,) = [p for p in tdir.glob("*.ply") if p != src]
        equal(read_ply(moved)[0], fn(clouds[0][0]).astype(np.float32),
              f"pcd_rototranslation {mode}")

    # track_targets: epoch 0's first frame into epochs 1 and 2
    img = root / "img" / "cam1"
    master = sorted(img.glob("*.png"))[0]
    with open(root / "targets" / f"{master.stem}.csv") as f:
        table = list(csv.DictReader(f))
    xy0 = np.array([[float(r["x"]), float(r["y"])] for r in table])
    slaves = sorted(img.glob("*.png"))[1:]
    got = run("track_targets", lambda: track_targets.main(
        ["--master", str(master), "--images", str(img / "IMG_100[1-9].png"),
         "--targets", str(root / "targets" / f"{master.stem}.csv"),
         "--out", str(d / "targets"),
         "--template", str(PRODUCTS_TARGETS["template_width"]),
         "--search", str(PRODUCTS_TARGETS["search_width"]),
         "--snr", str(PRODUCTS_TARGETS["snr_threshold"])]))
    want = TrackTargets(master, slaves, xy0,
                        out_dir=d / "targets_lib",
                        target_names=[r["label"] for r in table],
                        device=dev, **PRODUCTS_TARGETS).track()
    if sorted(got) != sorted(want):
        raise AssertionError(f"track_targets images {sorted(got)}")
    for stem in want:
        equal(got[stem]["ok"], want[stem]["ok"], "track_targets ok")
        if not np.allclose(got[stem]["xy"], want[stem]["xy"], atol=1e-3,
                           equal_nan=True):
            raise AssertionError("track_targets positions")
    out["track_targets"] = {k: int(v["ok"].sum()) for k, v in got.items()}
    out["times_s"] = times
    shown = {k: v for k, v in out.items() if k != "times_s"}
    log(f"  product commands on crops of {out['points']} points, equal to "
        f"the library: {json.dumps(shown)}")
    log(f"  times on {card_line()}: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in times.items()))
    return out


def commands_path(dev, reset_counts, read_counts, scene, base_cfg: dict,
                  season: dict, root, img0, img1) -> dict:
    """Phase 21: the command lines a user starts the port with, on phase
    7's frames and clouds and phase 4's pair. (a) `python -m
    icepy4d_tpu_torch run_pipeline cfg.yaml` as a subprocess over
    CLI_EPOCHS epochs of phase 7's config: its checkpoints and sinks meet
    phase 7's gates; (b) `run_pipeline.main` in-process on the same
    config with the counts set to 0 before: its NMS, attention and sweep
    launches are phase 7's for those epochs, exactly; (c) the product
    commands on phase 17's clouds (`product_commands`); (d) the
    single-epoch walkthrough on phase 7's epoch-0 frames in the asset
    layout and the matcher benchmark on phase 4's pair (a SEMIDENSE_CROP
    centre crop: whole-frame tiles exceed LoFTR's coarse-token cap),
    held to WALKTHROUGH_GATES.
    plot_sections and dynamic_visualization draw with matplotlib, which
    this script does not need (as phase 17): they run in the CPU tests
    only."""
    import copy

    import cv2
    import yaml

    from icepy4d_tpu_torch.cli import run_pipeline
    from icepy4d_tpu_torch.examples import (matching_benchmark,
                                            single_epoch_stereo)

    root = Path(root)
    t_phase = time.perf_counter()
    cams = ["cam1", "cam2"]
    out = {"card": card_line()}

    def config(name: str) -> Path:
        cfg = copy.deepcopy(base_cfg)
        cfg["paths"]["results_dir"] = name       # relative to the file
        cfg["proc"].update(do_tracking=True, do_dense=True,
                           epoch_to_process=[0, CLI_EPOCHS - 1])
        path = root / f"{name}.yaml"
        path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
        return path

    # (a) the season command as a user starts it
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "icepy4d_tpu_torch", "run_pipeline",
         str(config("res_cli"))], cwd=REPO, capture_output=True, text=True,
        timeout=900)
    out["subprocess_s"] = time.perf_counter() - t0
    if proc.returncode != 0 or proc.stdout.strip().splitlines()[-1:] != [
            f"processed {CLI_EPOCHS} epochs"]:
        raise AssertionError(f"run_pipeline exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-4000:]}")
    log(f"command line: python -m icepy4d_tpu_torch run_pipeline on "
        f"{CLI_EPOCHS} epochs: exit 0 in {out['subprocess_s']:.1f} s "
        f"(a new process: imports, weights and the cold epoch) on "
        f"{out['card']}")
    res = root / "res_cli"
    out["subprocess_epochs"] = check_cli_season(
        "subprocess", scene, cams, season_from_checkpoints(res), res)

    # (b) in-process, launches counted
    want = {k: sum(c[k] for c in season["launches"][:CLI_EPOCHS])
            for k in season["launches"][0]}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    epochs = list(run_pipeline.main([str(config("res_cli_inproc"))]))
    torch.cuda.synchronize()
    out["inprocess_s"] = time.perf_counter() - t0
    out["launches"] = read_counts()
    log(f"  in-process run_pipeline.main: {out['inprocess_s']:.1f} s, "
        f"launches {out['launches']} (phase 7's epochs 0-{CLI_EPOCHS - 1}: "
        f"{want})")
    if out["launches"] != want:
        raise AssertionError(f"run_pipeline launches {out['launches']} != "
                             f"{want}")
    out["inprocess_epochs"] = check_cli_season(
        "in-process", scene, cams, epochs, root / "res_cli_inproc")

    # (c) the product commands
    plys = sorted((root / "res_lightglue").rglob("dense_*.ply"))
    out["products"] = product_commands(dev, root, plys)

    # (d) the walkthroughs
    assets = root / "assets"
    frames = [cv2.imread(str(sorted((root / "img" / c).glob("*.png"))[0]),
                         cv2.IMREAD_GRAYSCALE) for c in cams]
    scene.write_assets(assets, single_epoch_stereo.CENTERS,
                       single_epoch_stereo.TARGETS, frames=frames)
    del frames
    verified = []
    from icepy4d_tpu_torch.matching import NearestNeighborMatcher
    run_match = NearestNeighborMatcher.match

    def record(self, *a, **kw):
        r = run_match(self, *a, **kw)
        verified.append(len(self.mkpts0))
        return r

    NearestNeighborMatcher.match = record
    try:
        t0 = time.perf_counter()
        ba = single_epoch_stereo.main(["--assets", str(assets), "--out",
                                       str(root / "single_epoch")])
        torch.cuda.synchronize()
    finally:
        NearestNeighborMatcher.match = run_match
    centre_err = {c: float(np.linalg.norm(np.asarray(ba.cameras[c].C).ravel()
                                          - xyz)) for c, xyz in zip(
        cams, single_epoch_stereo.CENTERS)}
    out["single_epoch_stereo"] = {
        "s": time.perf_counter() - t0, "verified": verified[0],
        "points": len(ba.points), "ba_ok": ba.ok,
        "rmse_px": ba.reprojection_rmse_px, "centre_err_m": centre_err}
    log(f"  single_epoch_stereo on phase 7's epoch-0 frames: "
        f"{out['single_epoch_stereo']}")
    if not (ba.ok and ba.reprojection_rmse_px <= WALKTHROUGH_GATES["rmse_px"]
            and verified[0] >= WALKTHROUGH_GATES["verified"]
            and max(centre_err.values()) <= WALKTHROUGH_GATES["centre_m"]):
        raise AssertionError(f"single_epoch_stereo: "
                             f"{out['single_epoch_stereo']}")

    h, w = SEMIDENSE_CROP
    y0, x0 = (H_IMG - h) // 2, (W_IMG - w) // 2
    bench = root / "bench_assets"
    for cam, im in zip(cams, (img0, img1)):
        (bench / "img" / cam).mkdir(parents=True)
        cv2.imwrite(str(bench / "img" / cam / "IMG_0.png"),
                    im[y0:y0 + h, x0:x0 + w])
    mdir = root / "bench_matches"
    out["matching_benchmark"] = matching_benchmark.main(
        ["--assets", str(bench), "--out", str(mdir)])
    precision = {}
    for name in ("NearestNeighbor", "LightGlue"):
        mk0, mk1 = (np.loadtxt(mdir / name / f"keypoints_{i}.txt",
                               delimiter=",", ndmin=2) for i in (0, 1))
        err = np.linalg.norm(mk0 - mk1 - [DX, DY], axis=1)
        precision[name] = float((err < 1.5).mean()) if len(err) else 0.0
    out["matching_benchmark_precision"] = precision
    log(f"  matching_benchmark on phase 4's {w}x{h} centre crop: "
        f"{out['matching_benchmark']}; ground-truth precision {precision}")
    if not all(p >= WALKTHROUGH_GATES["bench_precision"]
               for p in precision.values()):
        raise AssertionError(f"matching_benchmark precision {precision}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  command-line path: {out['phase_s']:.1f} s on {out['card']}")
    return out


def main() -> None:
    # -- 1. card ------------------------------------------------------------
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    sys.path.insert(0, str(REPO))
    from icepy4d_tpu_torch.matching import (GeometricVerification,
                                            LightGlueMatcher, Quality,
                                            TileSelection)
    from icepy4d_tpu_torch.io import read_ply, write_ply
    from icepy4d_tpu_torch.models import LightGlue
    from icepy4d_tpu_torch.models import superpoint as sp_module
    from icepy4d_tpu_torch.ops import (_build, attention, dense, dual_softmax,
                                       nms, sweep)
    from icepy4d_tpu_torch.sfm import PlaneSweepStereo
    from icepy4d_tpu_torch.sfm import dense as sfm_dense

    kernels_used = {"nms": nms.KERNEL, "attention": attention.KERNEL,
                    "sweep": sweep.KERNEL, "dual_softmax": dual_softmax.KERNEL}

    def reset_counts():
        for k in kernels_used.values():
            k.launches = 0

    def read_counts():
        return {name: k.launches for name, k in kernels_used.items()}

    # Matmuls in full f32 (PyTorch's default): phase 5's f32 trunk is
    # compared in f32. No comparison here runs a convolution, so cuDNN
    # keeps its TF32 default for the SuperPoint trunk, as a caller of the
    # matcher gets it.
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all([k.source for k in kernels_used.values()])
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for src, text in _build.build_logs.items():
        entry = ""               # of nms.cu's radii, the main path's only
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif ("registers" in line or "spill" in line) and \
                    (src != "nms.cu" or "ILi4E" in entry):
                log(f"  {src}: {line.strip()}")

    # -- 3. kernel vs plain --------------------------------------------------
    log("kernel vs plain:")
    check_nms(nms, heat_map((2, 301, 517), dev), 4, (5, 3), "ties")
    check_nms(nms, heat_map((1, 67, 45), dev), 2, (5, 3), "ties")
    cases = nms_cases(nms)
    for shape, r, pad, kind in cases:
        check_nms(nms, nms_map(shape, dev, kind), r, pad, kind)
    log(f"  nms: bitwise equal at {len(cases) + 2} shapes (tile "
        f"{nms.tile_shape(4)} at r=4, radii 1-4, word seams, unaligned "
        f"widths, h0 < H, negative / all-equal / all-zero maps)")
    nms_shape = (2, 2400, 3400)          # one extraction chunk of the main path
    nms_err = check_nms(nms, heat_map(nms_shape, dev), 4, (5, 3), "ties")
    log(f"  nms {nms_shape}: bitwise equal")
    check_attention(attention, dev, 3, 4, 77, 130)
    check_attention(attention, dev, 2, 4, 200, 33)
    # key and query tails around the kernel's 128-wide tiles, padding
    # masks, a run of fully masked tiles, strided head views
    for nk in (1, 63, 64, 65, 127, 128, 129, 4 * 128 + 5):
        check_attention(attention, dev, 3, 2, 129, nk)
    for nq in (1, 127, 129, 200):
        check_attention(attention, dev, 3, 2, nq, 300, mode="prefix")
    for mode in ("prefix", "middle"):
        for head_views in (False, True):
            check_attention(attention, dev, 3, 4, 256, 1024, mode=mode,
                            head_views=head_views)
    att_shape = (16, 4, 4096, 4096)      # the main path's tile-pair batch
    att_err = check_attention(attention, dev, *att_shape)
    # the adaptive LightGlue's packed capacities over the same batch
    caps = (64, 128, 256, 512, 1024, 2048)
    for nq in caps:
        for nk in caps:
            check_attention(attention, dev, att_shape[0], 4, nq, nk,
                            mode="prefix", head_views=True, yardstick=True)
    check_sweep(dense, *sweep_inputs(dev, 67, 45, 2.3), -6.0, 6.0, 25, 5,
                "small")
    check_sweep(dense, *sweep_inputs(dev, 161, 203, 5.3), -12.0, 12.0, 49,
                7, "symmetric")
    check_sweep(dense, *sweep_inputs(dev, 161, 203, -9.6), -20.0, -4.0, 49,
                7, "negative")
    # heights and widths off the kernel's 16 x (128 - (window - 1)) tile,
    # a height below one tile, and every window it is built for
    for hw in ((9, 300), (17, 123), (33, 121), (15, 7)):
        check_sweep(dense, *sweep_inputs(dev, *hw, 3.2), -9.7, 3.1, 33, 7,
                    "off-tile")
    for window in sweep.WINDOWS:
        check_sweep(dense, *sweep_inputs(dev, 50, 261, 4.4), -9.0, 9.0, 19,
                    window, "window")
    # tails around the kernel's 128-row blocks and 128-column tiles,
    # one row or column, unequal lengths, masks, a tile pair with every
    # column masked and one with every row
    for shape in ((1, 1000, 1337), (3, 517, 300), (3, 129, 1), (2, 1, 255)):
        check_dual_softmax(dual_softmax, dev, *shape, p_keep=0.85,
                           dead=True, seed=shape[1])
    ds_err = check_dual_softmax(dual_softmax, dev, *DSMAX_SHAPE, seed=3)

    # -- 4. matcher path -------------------------------------------------------
    img0, img1 = shifted_pair()
    matcher = LightGlueMatcher({"max_keypoints": 4096})
    captured = []
    run_matcher = matcher._run_matcher

    def capture(data):
        captured.append(data)
        return run_matcher(data)

    matcher._run_matcher = capture
    heats = []                   # the warm run's first SuperPoint heat map
    run_nms = sp_module.fused_nms_border

    def capture_heat(heat, *a):
        if not heats:
            heats.append(heat)
        return run_nms(heat, *a)

    sp_module.fused_nms_border = capture_heat
    from icepy4d_tpu_torch.matching import matchers as matchers_module
    putatives = []               # the warm run's verification inputs
    run_gv = matchers_module.geometric_verification

    def capture_gv(mk0, mk1, **kw):
        putatives[:] = [mk0.copy(), mk1.copy(), np.asarray(kw["scores"])]
        return run_gv(mk0, mk1, **kw)

    matchers_module.geometric_verification = capture_gv
    call = dict(quality=Quality.HIGH, tile_selection=TileSelection.EXHAUSTIVE,
                grid=[2, 2], overlap=200,
                geometric_verification=GeometricVerification.PYDEGENSAC,
                threshold=1.0)
    times = {}
    for run in ("cold", "warm"):
        captured.clear()
        heats.clear()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        matcher.match(img0, img1, **call)
        torch.cuda.synchronize()
        times[run] = time.perf_counter() - t0
        launches = read_counts()
    sp_module.fused_nms_border = run_nms
    matchers_module.geometric_verification = run_gv
    stages = dict(matcher.timer.times)
    n_put = len(matcher.inlier_mask)
    n_inl = len(matcher.mkpts0)
    err = np.linalg.norm(matcher.mkpts0 - matcher.mkpts1 - [DX, DY], axis=1)
    precision = float((err < 1.5).mean()) if n_inl else 0.0
    n_layers = matcher.matcher.n_layers
    log(f"matcher path: {W_IMG}x{H_IMG} pair, cold {times['cold']:.3f} s, "
        f"warm {times['warm']:.3f} s, stages {stages}")
    log(f"  putative {n_put}, inliers {n_inl}, ground-truth precision "
        f"{precision:.4f}, pair chunks {len(captured)}, launches {launches}")
    if not (n_put > 0 and n_inl > 0):
        raise AssertionError("no putative matches or no inliers")
    if precision < 0.9:
        raise AssertionError(f"inlier precision {precision} < 0.9")
    # one launch per extraction chunk: two images of 2 x 2 tiles each
    sp_heat = heats[0]
    if tuple(sp_heat.shape[1:]) != nms_shape[1:]:
        raise AssertionError(f"SuperPoint heat map {tuple(sp_heat.shape)}")
    n_chunks = 2 * (4 // matcher._extract_chunk(4, *nms_shape[1:]))
    if launches["nms"] != n_chunks or sp_heat.shape[0] * n_chunks != 8:
        raise AssertionError(f"NMS kernel launched {launches['nms']} times "
                             f"for {n_chunks} extraction chunks")
    check_nms(nms, sp_heat, 4, (0, 0), "SuperPoint heat map")
    log(f"  nms on the run's SuperPoint heat map {tuple(sp_heat.shape)}: "
        f"bitwise equal")
    if launches["attention"] != 4 * n_layers * len(captured):
        raise AssertionError(f"attention kernel launched "
                             f"{launches['attention']} times")
    # the FLOPs the warm match executes in SuperPoint's convolutions (8
    # tiles of the heat map's padded shape) and LightGlue's matmuls (its
    # pair chunks' padded keypoint sets): the yardstick of a share of
    # the card's peak
    from icepy4d_tpu_torch.models import SuperPoint
    match_flops = {
        "superpoint": SuperPoint(max_keypoints=1).extract_flops(
            *nms_shape[1:], batch=8),
        "lightglue": sum(matcher.matcher.match_flops(
            d["mask0"].shape[0], d["mask0"].shape[1], d["mask1"].shape[1])
            for d in captured)}
    log(f"  executed FLOPs of the match: {match_flops} = "
        f"{sum(match_flops.values()) / times['warm'] / 1e12:.2f} TFLOP/s "
        f"over the warm match on {card}")
    # the seeded forward of a tracked epoch: both cameras' 2 x 2 tiles as
    # 8 tile-diagonal pairs, in the matcher's pair chunks
    k = matcher._max_keypoints
    seed_chunk = matcher._auto_chunk(8, (k + 1) ** 2 * 4 * 4, budget=6 << 30)
    seeded_attention = 4 * n_layers * (8 // seed_chunk)

    # -- 5. LightGlue with the kernel vs with the plain bf16 attention --------
    # The matcher's bf16 trunk rounds every activation to bf16, so any
    # change in the last bit of an attention output (the kernel's f32
    # sums run in another order than cuBLAS's) flips ~5% of this batch's
    # match decisions, as it does between two plain versions that differ
    # only in operand rounding (the yardstick). The f32 trunk keeps the
    # kernel's bf16 contract but does not amplify its last bits: the
    # >= 0.98 gate is held there, and the bf16 trunk is held to the
    # yardstick.
    data = captured[0]
    valid = data["mask0"]
    plain_bf16 = partial(attention.attention_plain,
                         operand_dtype=torch.bfloat16)
    plain_f32 = partial(attention.attention_plain,
                        operand_dtype=torch.float32)

    def agreement(a, b) -> float:
        return ((a == b) & valid).sum().item() / valid.sum().item()

    lg = matcher.matcher
    lg32 = LightGlue(n_layers=lg.n_layers, activation_dtype="float32",
                     filter_threshold=lg.filter_threshold)
    lg32.load_state_dict(lg.state_dict())
    agree = {}
    for name, model in (("bf16", lg), ("f32", lg32)):
        plain = model.match(data, attn=plain_bf16)["matches0"]
        agree[name] = agreement(model.match(data)["matches0"], plain)
        if name == "bf16":
            yardstick = agreement(
                model.match(data, attn=plain_f32)["matches0"], plain)
    log(f"lightglue B={valid.shape[0]}x{valid.shape[1]}: match agreement, "
        f"kernel vs plain bf16 attention: f32 trunk {agree['f32']:.5f}, "
        f"bf16 trunk {agree['bf16']:.5f} (yardstick, plain f32 vs plain "
        f"bf16 operands in the bf16 trunk: {yardstick:.5f})")
    if agree["f32"] < 0.98:
        raise AssertionError(f"f32-trunk match agreement {agree['f32']}")
    if agree["bf16"] < yardstick - 0.01:
        raise AssertionError(f"bf16-trunk match agreement {agree['bf16']} "
                             f"below the yardstick {yardstick}")

    # the seeded forward of an n-camera tracked epoch: three cameras'
    # 2 x 2 tiles as 12 tile-diagonal pairs
    seed_chunk3 = matcher._auto_chunk(12, (k + 1) ** 2 * 4 * 4,
                                      budget=6 << 30)
    seeded_attention3 = 4 * n_layers * (12 // seed_chunk3)
    # phase 20's pipeline batch: 4 of the first chunk's tile pairs
    tile_pairs = {name: t[:4] for name, t in data.items()}
    del data, captured, lg32, matcher, heats
    torch.cuda.empty_cache()

    # -- 10. adaptive matcher ---------------------------------------------------
    adaptive = adaptive_path(dev, reset_counts, read_counts, img0, img1,
                             call, n_chunks, times["warm"])
    adaptive["attention_times"] = [
        attention_times(attention, dev, (16, 4, n, n)) for n in (512, 2048)]

    # -- 13. SuperGlue, 14. DISK and ALIKED, 15. semi-dense and LoFTR --------
    superglue = superglue_path(dev, reset_counts, read_counts, img0, img1,
                               call, n_chunks)
    extractors = extractor_path(dev, reset_counts, read_counts, img0, img1,
                                call)
    from icepy4d_tpu_torch.models import loftr as loftr_module
    coarse = []                  # the first coarse transformer calls' inputs
    run_lft = loftr_module.lft_apply

    def capture_coarse(layers, f0, f1, mask0, mask1, nhead):
        # the match's pair chunks (2 tile pairs each on the card), until
        # phase 20's stages have a microbatch each
        if f0.shape[-1] == 256 and (not coarse or (
                f0.shape[1:] == coarse[0][1].shape[1:]
                and sum(len(c[1]) for c in coarse) < PP_LOFTR_STAGES)):
            coarse.append((layers, f0, f1, mask0, mask1))
        return run_lft(layers, f0, f1, mask0, mask1, nhead)

    loftr_module.lft_apply = capture_coarse
    try:
        loftr = loftr_semidense_path(dev, reset_counts, read_counts, img0,
                                     img1)
    finally:
        loftr_module.lft_apply = run_lft

    # -- 20. ring attention, the sequence- and pipeline-parallel matchers ---
    sharded = sharded_path(dev, reset_counts, read_counts, img0, img1,
                           tile_pairs, coarse)
    del tile_pairs, coarse
    torch.cuda.empty_cache()
    # the kernels' launches on the main paths: phases 4, 13, 14 and 20
    path_launches = {
        name: launches[name] + superglue["launches"][name]
        + sum(r["launches"][name] for r in extractors.values())
        + sharded["launches"][name]
        for name in ("nms", "attention")}

    # -- 6. dense path ---------------------------------------------------------
    cams, imgs = plane_pair()
    pss = PlaneSweepStereo(cams, imgs, depth_min=0.7 * PLANE_Z,
                           depth_max=1.5 * PLANE_Z, n_planes=128, window=7,
                           downscale=1, cost_threshold=0.4,
                           uniqueness_threshold=0.99, lr_check=True,
                           lr_tau=2.0)
    sweeps = []                  # (I0r, I1r, lo, hi) of the last run
    run_sweep = sfm_dense.disparity_sweep

    def capture_sweep(I0r, I1r, lo, hi, **kw):
        sweeps.append((I0r, I1r, lo, hi))
        return run_sweep(I0r, I1r, lo, hi, **kw)

    sfm_dense.disparity_sweep = capture_sweep
    dense_times = {}
    for run in ("cold", "warm"):
        sweeps.clear()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = pss.run()
        torch.cuda.synchronize()
        dense_times[run] = time.perf_counter() - t0
        dense_launches = read_counts()
    sfm_dense.disparity_sweep = run_sweep
    dense_stages = dict(pss.timer.times)
    h, w = res["depth"].shape
    inner = (slice(h // 10, h - h // 10), slice(w // 6, w - w // 10))
    valid_inner = float(res["valid"][inner].mean())
    depth_err = float(np.median(np.abs(res["depth"][res["valid"]] - PLANE_Z))
                      / PLANE_Z)
    pts, colors = pss.to_point_cloud()
    z_err = float(np.median(np.abs(pts[:, 2] - PLANE_Z)))
    with tempfile.TemporaryDirectory() as tmp:
        write_ply(Path(tmp) / "dense.ply", pts, colors)
        back, _ = read_ply(Path(tmp) / "dense.ply")
    log(f"dense path: {W_IMG}x{H_IMG} pair, cold {dense_times['cold']:.3f} "
        f"s, warm {dense_times['warm']:.3f} s, stages {dense_stages}")
    log(f"  valid {float(res['valid'].mean()):.4f} (inner {valid_inner:.4f}), "
        f"median |depth - Z| / Z {depth_err:.3e}, cloud {len(pts)} points, "
        f"median |Z - {PLANE_Z:g}| {z_err:.4f} m, launches {dense_launches}")
    if dense_launches["sweep"] != 2:
        raise AssertionError(f"sweep kernel launched "
                             f"{dense_launches['sweep']} times in a run")
    if not valid_inner >= 0.5:
        raise AssertionError(f"inner valid share {valid_inner} < 0.5")
    if not depth_err < 5e-3:
        raise AssertionError(f"median relative depth error {depth_err}")
    if not (len(pts) and z_err < 1.0):
        raise AssertionError(f"point cloud median |Z - Z0| {z_err}")
    if not np.array_equal(back, pts.astype(np.float32)):
        raise AssertionError("PLY read back differs from the cloud")
    sweep_shape = tuple(sweeps[0][0].shape)
    sweep_err = 0.0
    for (I0r, I1r, lo, hi), label in zip(sweeps, ("forward", "reverse")):
        sweep_err = max(sweep_err, check_sweep(
            dense, I0r, I1r, lo, hi, 128, 7, label))
    I0r, I1r, lo, hi = sweeps[0]
    del pss, res, pts, colors, back, cams, imgs
    torch.cuda.empty_cache()

    # -- 7. season path, 8. SIFT season (the same frames) ---------------------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        scene, season_cfg = season_config(dev, tmp, n_epochs=3)
        log(f"season frames written in {time.perf_counter() - t0:.1f} s")
        first = dict(launches, sweep=2)
        tracked = dict(first, attention=first["attention"] + seeded_attention)
        season, season_epoches = season_path(
            dev, reset_counts, read_counts, scene, season_cfg,
            [first, tracked, tracked])
        season_ref = season_summary(list(season_epoches),
                                    list(season_epoches[0].features))
        torch.cuda.empty_cache()
        sift_season = sift_season_path(dev, reset_counts, read_counts, scene,
                                       season_cfg)
        torch.cuda.empty_cache()
        # -- 12 (in part). space resection and do_viz in a stereo season
        log("PnP, MAGSAC, space resection and the match writer:")
        pnp = {"space_resection": pnp_check(dev),
               "magsac": magsac_check(dev, putatives),
               "season": resection_season_path(season_cfg, n_epochs=2)}
        # -- 16. the season tools on the same frames
        untracked = dict(launches, sweep=0)
        tools = season_tools_path(
            reset_counts, read_counts, season_cfg,
            [untracked, dict(untracked, attention=untracked["attention"]
                             + seeded_attention)],
            epoch_seconds(season["stage_times_s"]["0"]))
        tools["exif"] = exif_check(tmp)
        torch.cuda.empty_cache()
        # -- 19. the batched, multi-process and staged seasons
        batched = batched_path(
            dev, reset_counts, read_counts, scene, season_cfg, season_ref,
            [epoch_seconds(season["stage_times_s"][k]) for k in ("1", "2")],
            img0, img1, call)
        torch.cuda.empty_cache()
        # -- 17. the 4D products on phase 7's clouds, frames and epochs
        products = products_path(dev, reset_counts, read_counts, scene,
                                 season_epoches, tmp)
        del season_epoches
        torch.cuda.empty_cache()
        # -- 21. the command lines on phase 7's frames and clouds, phase
        # 4's pair
        commands = commands_path(dev, reset_counts, read_counts, scene,
                                 season_cfg, season, tmp, img0, img1)
        del scene
        torch.cuda.empty_cache()
        # -- 18. training on phase 7's frames and epochs
        training = training_path(dev, reset_counts, read_counts,
                                 season_cfg["paths"]["image_dir"],
                                 Path(tmp) / "res_lightglue", tmp)
    torch.cuda.empty_cache()

    # -- 11. n-camera season -----------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        scene3, cfg3 = multicam_config(dev, tmp, n_epochs=3)
        log(f"n-camera season frames written in {time.perf_counter() - t0:.1f}"
            " s")
        # an epoch matches the master against both slaves (phase 4's
        # launches each: a match extracts both frames, so the master once
        # per slave); a tracked epoch first extracts all three frames for
        # the seeded forward (the feature cache holds one pair) and runs
        # that forward over 12 tile pairs
        per_image = launches["nms"] // 2
        first3 = {"nms": 2 * launches["nms"],
                  "attention": 2 * launches["attention"], "sweep": 0,
                  "dual_softmax": 0}
        tracked3 = dict(first3, nms=first3["nms"] + 3 * per_image,
                        attention=first3["attention"] + seeded_attention3)
        multicam = multicam_path(dev, reset_counts, read_counts, scene3,
                                 cfg3, [first3, tracked3, tracked3])
        del scene3
    torch.cuda.empty_cache()

    # -- 9. times --------------------------------------------------------------
    heat = heat_map(nms_shape, dev)
    b, hh, ww = nms_shape
    args = (4, 4, hh, ww)
    nms_ms = cuda_ms(lambda: nms.fused_nms_border(heat, *args), 20)
    nms_plain_ms = cuda_ms(lambda: nms.nms_border_plain(heat, *args), 5)
    nms_sp_ms = cuda_ms(lambda: nms.fused_nms_border(sp_heat, *args), 20)
    log(f"nms {nms_shape} r=4: {nms_ms:.4f} ms on random scores, "
        f"{nms_sp_ms:.4f} ms on the matcher path's SuperPoint heat map")
    px = b * hh * ww
    # f32 read + write; 5 pools x 2 separable passes x 2r compares
    nms_bound, nms_by = lower_bound(px * 8, px * 5 * 2 * 8, F32_FLOPS)

    q, k, v, mask = attention_inputs(*att_shape, dev, seed=1)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    att_ms = cuda_ms(lambda: attention.masked_attention(qb, kb, vb, mask), 10)
    att_plain_ms = cuda_ms(lambda: attention.attention_plain(
        qb, kb, vb, mask, operand_dtype=torch.bfloat16), 3)
    sdpa_mask = mask[:, None, None, :]
    sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=sdpa_mask), 10)
    B, H, NQ, NK = att_shape
    att_flops = 4 * B * H * NQ * NK * 64
    # bf16 q, k, v and the bool mask in; f32 pv and den out
    att_bytes = B * H * 64 * (2 * NQ + 4 * NK) + B * NK \
        + B * H * NQ * (64 + 1) * 4
    att_bound, att_by = lower_bound(att_bytes, att_flops, BF16_FLOPS)

    sweep_ms = cuda_ms(lambda: dense.disparity_sweep(
        I0r, I1r, lo, hi, n_disp=128, window=7), 10)
    sweep_plain_ms = cuda_ms(lambda: dense.disparity_sweep_plain(
        I0r, I1r, lo, hi, dense._pad_bucket(lo, hi), n_disp=128, window=7), 2)
    px = sweep_shape[0] * sweep_shape[1]
    # two f32 planes in; disparity, cost, uniqueness f32 and inbounds bool out
    sweep_bound, sweep_by = lower_bound(px * (2 * 4 + 3 * 4 + 1),
                                        px * 128 * SWEEP_OPS, F32_FLOPS)

    c0, c1, m0, m1 = dual_softmax_inputs(*DSMAX_SHAPE, dev, seed=4)
    ds_ms = cuda_ms(lambda: dual_softmax.dual_softmax_kernel(
        c0, c1, m0, m1, DSMAX_T), 10)
    ds_plain_ms = cuda_ms(lambda: dual_softmax.best_of(
        dual_softmax.confidence_plain(c0, c1, m0, m1, DSMAX_T)), 3)
    B, L0, L1 = DSMAX_SHAPE
    # the benchmark's coarse_match bound: the similarity's 2 L0 L1 d
    # operations at the tensor cores' dense rate; f32 features and bool
    # masks in, bj and bi int64 and bv f32 out
    ds_bound, ds_by = lower_bound(
        B * (L0 + L1) * (256 * 4 + 1) + B * L0 * 12 + B * L1 * 8,
        2 * B * L0 * L1 * 256, BF16_FLOPS)
    log(f"dual softmax {DSMAX_SHAPE} d 256: {ds_ms:.3f} ms, plain "
        f"{ds_plain_ms:.3f} ms, bound {ds_bound:.3f} ms ({ds_by})")
    del c0, c1, m0, m1

    kernels = [
        {"name": "fused_nms_border", "route": "cuda",
         "source": "icepy4d_tpu_torch/csrc/nms.cu",
         "replaces": "icepy4d_tpu/ops/pallas_nms.py:105",
         "launches": path_launches["nms"] + training["launches"]["nms"]
         + batched["launches"]["nms"] + commands["launches"]["nms"],
         "max_abs_err": nms_err,
         "ms": nms_ms, "plain_ms": nms_plain_ms, "bound_ms": nms_bound,
         "bound_by": nms_by, "library_ms": None},
        {"name": "masked_flash_attention", "route": "cuda",
         "source": "icepy4d_tpu_torch/csrc/attention.cu",
         "replaces": "icepy4d_tpu/ops/attention.py:109",
         "launches": path_launches["attention"]
         + training["launches"]["attention"]
         + batched["launches"]["attention"]
         + commands["launches"]["attention"], "max_abs_err": att_err,
         "ms": att_ms, "plain_ms": att_plain_ms, "bound_ms": att_bound,
         "bound_by": att_by, "library_ms": sdpa_ms},
        {"name": "disparity_sweep", "route": "cuda",
         "source": "icepy4d_tpu_torch/csrc/sweep.cu",
         "replaces": "icepy4d_tpu/ops/pallas_sweep.py:196",
         "launches": dense_launches["sweep"] + commands["launches"]["sweep"],
         "max_abs_err": sweep_err,
         "ms": sweep_ms, "plain_ms": sweep_plain_ms, "bound_ms": sweep_bound,
         "bound_by": sweep_by, "library_ms": None},
        {"name": "dual_softmax", "route": "cuda",
         "source": "icepy4d_tpu_torch/csrc/dual_softmax.cu",
         "replaces": None, "shape": DSMAX_SHAPE,
         "launches": loftr["loftr"]["launches"]["dual_softmax"]
         + loftr["loftr_card_vs_cpu"]["launches"],
         "max_abs_err": ds_err["bv_max_abs"],
         "max_rel_err": ds_err["bv_max_rel"],
         "ms": ds_ms, "plain_ms": ds_plain_ms, "bound_ms": ds_bound,
         "bound_by": ds_by, "library_ms": None},
    ]
    log(json.dumps({"main_path": {
        "warm_s": times["warm"], "cold_s": times["cold"], "stages_s": stages,
        "flops": match_flops,
        "putative": n_put, "inliers": n_inl, "precision": precision,
        "lightglue_agreement": agree, "agreement_yardstick": yardstick},
        "dense_path": {
            "warm_s": dense_times["warm"], "cold_s": dense_times["cold"],
            "stages_s": dense_stages, "valid_inner": valid_inner,
            "median_rel_depth_err": depth_err, "median_abs_z_err_m": z_err,
            "sweep_shape": sweep_shape},
        "season_path": season, "sift_season_path": sift_season,
        "adaptive_path": adaptive, "multicam_path": multicam,
        "pnp_magsac_resection": pnp, "superglue_path": superglue,
        "extractor_path": extractors, "loftr_semidense_path": loftr,
        "season_tools_path": tools, "products_path": products,
        "training_path": training, "batched_path": batched,
        "sharded_path": sharded, "commands_path": commands},
        default=str))
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
