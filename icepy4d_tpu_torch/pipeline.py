"""Multi-epoch pipeline of stereo and n-camera seasons.

Counterpart of `icepy4d_tpu/pipeline.py`. Per stereo epoch: match
(SuperPoint + LightGlue, static or adaptive, SuperPoint + SuperGlue,
mutual NN over SuperPoint, DISK or ALIKED features, the semi-dense grid
matcher, LoFTR, or SIFT + Lowe NN with the epipolar-guided rematch, each
with geometric verification) -> temporal tracking of the previous epoch's features
(proc.do_tracking) -> relative orientation -> triangulation ->
reprojection and cheirality filter -> absolute orientation on targets ->
space resection of each camera on its targets (proc.do_space_resection)
-> bundle adjustment with the adaptive trim ladder -> recovery ladder
for gated epochs -> dense reconstruction (proc.do_dense) -> sparse
points, CSV sinks and checkpoint. With more than two cameras an epoch
is master-centric (`_process_multicam`): the master is matched against
every slave, the matches are merged into tracks, each slave is oriented
against the master, and the tracks are triangulated, georeferenced and
adjusted over the full (points x cameras) grid, after a reprojection
filter the JAX package's n-camera path lacks. After the season,
proc.do_homography_warping re-bases one camera's frames onto a
reference epoch's orientation. `run()` decodes and uploads the next
epoch's frames in a worker thread while the current epoch computes;
`watch()` polls the image folders and processes epochs as they arrive;
`warmup()` runs one dummy match first.

The config is the JAX `Pipeline`'s: a dict (or a YAML path) with the
sections paths, proc, matching, georef, ba, quality_gates, recovery,
dense and other. `run_batched` matches B epochs in one batched step
(`parallel/epoch_step.py`) and orients them one by one;
`run_distributed` splits the season over the processes of a
`torch.distributed` group.

Each processed epoch leaves its stage times in `self.stage_times`. The
matcher, tracking, relative orientation, triangulation, BA and dense
calls run inside `torch.profiler` ranges named "matcher", "track",
"ransac", "triangulation", "ba" and "dense", which a profiler reads as
the epoch's device split.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from icepy4d_tpu_torch.core import (Calibration, Camera, Epoch, EpochDataMap,
                                    Epoches, Features, Points, Targets)
from icepy4d_tpu_torch.core.point_cloud import PointCloud
from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.io.export2textfile import (
    write_cameras_to_file, write_reprojection_error_to_file)
from icepy4d_tpu_torch.matching import (GeometricVerification,
                                        LightGlueMatcher, LoFTRMatcher,
                                        NearestNeighborMatcher, Quality,
                                        SemiDenseMatcher, SIFTMatcher,
                                        SuperGlueMatcher, TileSelection,
                                        track_matches)
from icepy4d_tpu_torch.matching.matchers import _host_gray
from icepy4d_tpu_torch.sfm import (AbsoluteOrientation, BAConfig,
                                   BundleAdjustment, PlaneSweepStereo,
                                   RelativeOrientation, SpaceResection,
                                   Triangulate, fundamental_from_cameras,
                                   pose_from_known_center)
from icepy4d_tpu_torch.sfm.geometry import project_points
from icepy4d_tpu_torch.utils.config import DotDict, parse_cfg

logger = logging.getLogger("icepy4d_tpu_torch")

MATCHERS = {
    "lightglue": LightGlueMatcher,
    "superglue": SuperGlueMatcher,
    "loftr": LoFTRMatcher,
    "semidense": SemiDenseMatcher,
    "nn": NearestNeighborMatcher,
    "sift": SIFTMatcher,
}
# what space resection catches: the numerics of a singular or
# unconverged system (a device or launch error propagates)
_RESECTION_ERRORS = (np.linalg.LinAlgError, torch.linalg.LinAlgError)


class Pipeline:
    """Config-driven pipeline of a stereo or n-camera season.

        epoches = Pipeline(cfg).run()

    device: None runs on the card (and raises without one); "cpu" runs
    the plain PyTorch path."""

    _RECOVERABLE = {"ba_rmse", "ba_failed", "few_inliers", "few_matches",
                    "no_orientation"}

    def __init__(self, cfg, device=None) -> None:
        cfg = DotDict.wrap(cfg) if isinstance(cfg, dict) else parse_cfg(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.paths = cfg.paths
        self.results_dir = Path(cfg.paths.results_dir)
        proc = cfg.get("proc", {})
        m_cfg = cfg.get("matching", DotDict())
        name = str(m_cfg.get("matcher", "lightglue")).lower()
        if name not in MATCHERS:
            raise KeyError(f"unknown matcher {name!r}")
        self.results_dir.mkdir(parents=True, exist_ok=True)
        self._epoch_map_kwargs = dict(
            master_camera=cfg.paths.get("master_camera"),
            time_tolerance_sec=int(proc.get("time_tolerance_sec", 1200)),
            use_mtime_fallback=bool(proc.get("use_mtime_fallback", False)))
        self.epoch_map = EpochDataMap(cfg.paths.image_dir,
                                      **self._epoch_map_kwargs)
        self.cams = self.epoch_map.cameras
        self.epoches = Epoches()
        opt = dict(m_cfg.get("options", {}) or {})
        if "max_keypoints" in m_cfg:
            opt.setdefault("max_keypoints", int(m_cfg.max_keypoints))
        self.matcher = MATCHERS[name](opt, device=self.device)
        self._next_track_id = 0
        self._prefetched: dict[int, dict] = {}
        self._active_prefetch: dict | None = None
        self._calib_scale = 1.0
        self.stage_times: dict[int, dict] = {}
        self._stage: dict = {}
        self._suppress_sinks = False

    # -- the batched and multi-process seasons -------------------------------

    def run_batched(self, mesh=None, tp: int = 1) -> Epoches:
        """The season in groups of B epochs, B the mesh's data axis: each
        group's frames go through one batched step (extraction of each
        side, one matcher forward over the B pairs, each pair's essential
        RANSAC and triangulation), then orientation, BA and the sinks
        run per epoch on the host. Frames are matched full frame at the
        quality scale, without tiling, tracking, verification or
        recovery; the last group is padded by repeating its last epoch,
        and only real epochs are recorded. Takes the lightglue,
        superglue, sift and nn matchers (ValueError otherwise); the
        classic ones run 512 hypotheses (matching.options.n_hypotheses)
        and, with guided_rounds, the epipolar-guided second round on the
        GCP prior where there is one. Without `mesh`,
        `make_mesh(tp=tp)` on the pipeline's device: one slot a visible
        device."""
        from icepy4d_tpu_torch.matching.enums import QUALITY_SCALE
        from icepy4d_tpu_torch.matching.matchers import _preprocess
        from icepy4d_tpu_torch.ops.geometry import scale_intrinsics
        from icepy4d_tpu_torch.parallel import (make_mesh,
                                                make_sharded_match_step,
                                                make_sharded_nn_step)

        m = self.matcher
        learned = isinstance(m, (LightGlueMatcher, SuperGlueMatcher))
        if not (learned or type(m) in (NearestNeighborMatcher, SIFTMatcher)):
            raise ValueError(
                "run_batched requires lightglue/superglue/sift/nn")
        mesh = mesh or make_mesh(tp=tp, device=self.device)
        b = mesh.shape[mesh.axis_names[0]]
        proc = self.cfg.get("proc", DotDict())
        m_cfg = self.cfg.get("matching", DotDict())
        qname = str(m_cfg.get("quality", "high")).lower()
        scale = QUALITY_SCALE[Quality[qname.upper()]]
        todo = proc.get("epoch_to_process", "all")
        if todo == "all" or todo is None:
            todo = list(range(len(self.epoch_map)))
        todo = [e for e in todo if e < len(self.epoch_map)]
        if not todo:
            logger.warning("run_batched: no epochs to process")
            return self.epoches
        # orientation reads no prior, F or confidences of an earlier match
        self._epoch_prior = None
        m._reset()

        sp = m._superpoint(m._max_keypoints)
        thr = float(self.cfg.get("other", DotDict()).get(
            "pydegensac_threshold", 2.0))
        guided = None
        if not learned and int(getattr(m, "_guided_rounds", 0)) > 0:
            guided = {"band": float(m._guided_band) * scale,
                      "ratio": float(m._guided_ratio),
                      "min_sim": float(m._guided_min_sim)}

        def make_step(h: int, w: int):
            # the matcher's extraction chunk: B full frames at once
            # would not fit the activation budget
            kw = {"threshold_px": thr,
                  "extract_chunk": m._extract_chunk(b, h, w)}
            if learned:
                return make_sharded_match_step(mesh, sp, m.matcher, **kw)
            return make_sharded_nn_step(
                mesh, sp, m._nn, guided=guided, n_hypotheses=int(
                    m_cfg.get("options", {}).get("n_hypotheses", 512)),
                **kw)

        K0 = K1 = step = None
        for g0 in range(0, len(todo), b):
            group = list(range(g0, min(g0 + b, len(todo))))
            # only this group's frames are decoded and held
            epochs = {i: self._initialize_epoch(todo[i]) for i in group}
            if K0 is None:
                first = epochs[group[0]]
                K0, K1 = (scale_intrinsics(torch.as_tensor(
                    np.asarray(first.cameras[c].K), dtype=torch.float32,
                    device=self.device), scale) for c in self.cams[:2])
            pad = group + [group[-1]] * (b - len(group))
            with torch.inference_mode():
                ims0, ims1 = (torch.stack([
                    _preprocess(torch.from_numpy(np.ascontiguousarray(
                        epochs[i].images[c].value)).to(self.device), qname)
                    for i in pad]) for c in self.cams[:2])
            if step is None:
                step = make_step(*ims0.shape[1:])
            if learned or guided is None:
                out = step(ims0, ims1, K0, K1)
            else:
                # each pair's surveyed prior F, from original pixels to
                # the match frame (x_match = scale * x): S^T F S with
                # S = diag(1 / scale, 1 / scale, 1)
                S = np.diag([1.0 / scale, 1.0 / scale, 1.0])
                F_prior = np.zeros((b, 3, 3), np.float32)
                prior_ok = np.zeros((b,), bool)
                for j, i in enumerate(pad):
                    pr = self._gcp_prior(epochs[i])
                    if pr is not None:
                        F_prior[j] = S.T @ np.asarray(pr[1]) @ S
                        prior_ok[j] = True
                out = step(ims0, ims1, K0, K1,
                           torch.from_numpy(F_prior).to(self.device),
                           torch.from_numpy(prior_ok).to(self.device))
            del ims0, ims1
            out = {k: v.cpu().numpy() for k, v in out.items()}
            for j, i in enumerate(group):
                epoch = epochs[i]
                valid = out["valid"][j]
                mk0 = out["mkpts0"][j][valid] / scale
                mk1 = out["mkpts1"][j][valid] / scale
                ids = np.arange(self._next_track_id,
                                self._next_track_id + len(mk0),
                                dtype=np.int32)
                self._next_track_id += len(mk0)
                for c, mk in ((self.cams[0], mk0), (self.cams[1], mk1)):
                    feats = Features()
                    feats.append_features_from_numpy(mk, track_ids=ids)
                    epoch.features[c] = feats
                pts3d = self._orient_epoch(epoch)
                if pts3d is not None and bool(proc.get("do_ba", True)):
                    pts3d = self._bundle_epoch(epoch, pts3d)
                self._finalize_epoch(epoch, pts3d)
                self.epoches.add_epoch(epoch, todo[i])
            logger.info("batched group %s done", [todo[i] for i in group])
        return self.epoches

    def run_distributed(self) -> Epoches:
        """The season split over the processes of a `torch.distributed`
        group (`parallel.distributed.init_distributed`): each process runs
        its contiguous shard of the epochs (`partition_epochs`) with the
        per-epoch flow of run(), checkpoints landing in the shared
        results directory by epoch. With tracking, a process whose shard
        does not start the season first processes the epoch before it as
        a warm seed, with no checkpoint and no CSV rows (its owner
        records it). The processes' epoch counts are all-gathered at the
        end. A single process runs the whole season as run() does."""
        from icepy4d_tpu_torch.parallel.distributed import (
            all_gather_host, partition_epochs, process_count, process_index)

        proc = self.cfg.get("proc", DotDict())
        todo = proc.get("epoch_to_process", "all")
        if todo == "all" or todo is None:
            todo = list(range(len(self.epoch_map)))
        shard = partition_epochs(len(todo))
        mine = [todo[i] for i in shard.indices]
        logger.info("process %d/%d takes epochs %s", process_index(),
                    process_count(), mine)
        prev = None
        if bool(proc.get("do_tracking", False)) and shard.start > 0:
            seed_ep = todo[shard.start - 1]
            logger.info("tracking warm seed: boundary epoch %d (not "
                        "recorded)", seed_ep)
            saved = proc.get("save_checkpoints", True)
            proc["save_checkpoints"] = False
            self._suppress_sinks = True
            try:
                prev = self.process_epoch(seed_ep, None)
            finally:
                proc["save_checkpoints"] = saved
                self._suppress_sinks = False
        for ep in mine:
            if ep >= len(self.epoch_map):
                break
            epoch = self.process_epoch(ep, prev)
            self.epoches.add_epoch(epoch, ep)
            prev = epoch
        if process_count() > 1:
            done = all_gather_host({"epochs_done": np.asarray(
                [len(mine)], np.float32)})
            logger.info("season summary: per-process epochs %s",
                        done["epochs_done"].ravel().tolist())
        return self.epoches

    def warmup(self) -> None:
        """One dummy match on zeros at the season's frame shape, quality
        and tiling, without verification: it builds the kernels, loads
        the weights on the card and lets cuDNN pick its convolution
        plans before the first epoch. On zeros SuperPoint finds no
        keypoint, so the matcher's forward itself may not run."""
        images = self.epoch_map.get_images(0)
        im = images[self.cams[0]].value
        dummy = np.zeros(im.shape[:2], np.uint8)
        cfg = self.cfg.get("matching", DotDict())
        quality = Quality[str(cfg.get("quality", "high")).upper()]
        tile = TileSelection[str(cfg.get("tile_selection", "none")).upper()]
        logger.info("warmup: a dummy match at %s, %s", im.shape, quality)
        self.matcher.match(dummy, dummy, quality=quality, tile_selection=tile,
                           grid=list(cfg.get("grid", [1, 1])),
                           overlap=int(cfg.get("overlap", 0)),
                           geometric_verification=GeometricVerification.NONE)
        self.matcher._reset()

    def watch(self, poll_interval: float = 60.0, max_polls: int | None = None,
              stop_after: int | None = None) -> Epoches:
        """Poll the image folders for new epochs and process each as it
        arrives, with tracking and checkpoints as in run().

        Epochs are kept by timestamp: an epoch that arrives late with an
        earlier timestamp than one already processed shifts the indices
        of the rebuilt map but is processed once, without a tracking
        seed (tracking only extends the chronological tail). max_polls
        bounds the passes over the folders and stop_after the epochs
        processed (None: no bound); the accumulated Epoches is returned
        when a bound is reached."""
        prev = None
        prev_ts = None
        done_ts: set = set()
        n_done = 0
        polls = 0
        while True:
            for ep in range(len(self.epoch_map)):
                ts = self.epoch_map.get_timestamp(ep)
                if ts in done_ts:
                    continue
                in_order = prev_ts is None or ts > prev_ts
                if not in_order:
                    logger.warning("[watch] out-of-order arrival %s (already "
                                   "past %s): processed without a tracking "
                                   "seed", ts, prev_ts)
                logger.info("=== [watch] new epoch %s ===", ts)
                epoch = self.process_epoch(ep, prev if in_order else None)
                self.epoches.add_epoch(epoch)
                done_ts.add(ts)
                if in_order:
                    prev, prev_ts = epoch, ts
                n_done += 1
                if stop_after is not None and n_done >= stop_after:
                    return self.epoches
            polls += 1
            if max_polls is not None and polls >= max_polls:
                return self.epoches
            time.sleep(poll_interval)
            self.epoch_map = EpochDataMap(self.cfg.paths.image_dir,
                                          **self._epoch_map_kwargs)

    # -- stage timing ---------------------------------------------------------

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _add_time(self, stage: str, t0: float) -> float:
        t1 = self._now()
        self._stage[stage] = self._stage.get(stage, 0.0) + (t1 - t0)
        return t1

    # -- per-epoch helpers ------------------------------------------------------

    def _prefetch_epoch_images(self, ep: int) -> None:
        """Decode, grayscale and upload one epoch's frames (worker
        thread); a failure leaves the epoch to the main thread."""
        try:
            images = self.epoch_map.get_images(ep)
            self._prefetched[ep] = {
                c: torch.from_numpy(np.ascontiguousarray(
                    _host_gray(images[c].value))).to(self.device)
                for c in self.cams}
        except Exception as e:
            logger.debug("prefetch of epoch %d failed: %s", ep, e)

    def _load_calibrations(self, image_shape) -> dict[str, Camera]:
        """Per-camera calibration -> Camera; K follows the frames when
        they differ from the calibrated resolution."""
        h, w = image_shape[:2]
        cams = {}
        for c in self.cams:
            cam = Calibration(Path(self.paths.calibration_dir)
                              / f"{c}.txt").to_camera()
            if cam.width and cam.width != w:
                s = w / cam.width
                self._calib_scale = s
                K = np.asarray(cam.K) * s
                K[2, 2] = 1.0
                cam = Camera.create(width=w, height=h, K=K,
                                    dist=np.asarray(cam.dist))
                logger.info("scaled %s intrinsics by %.4f to image size",
                            c, s)
            else:
                self._calib_scale = 1.0
            cams[c] = cam
        return cams

    def _load_targets(self, images) -> Targets | None:
        g = self.cfg.get("georef", None)
        if not g:
            return None
        tdir = Path(g.get("target_dir", ""))
        if not tdir.is_absolute():
            tdir = Path(self.paths.image_dir).parent / tdir
        ext = g.get("target_file_ext", ".csv")
        files = [tdir / f"{images[c].path.stem}{ext}" for c in self.cams]
        world = tdir / g.get("target_world_file", "target_world.csv")
        if not all(f.exists() for f in files) or not world.exists():
            logger.warning("targets missing for this epoch - skipping AO")
            return None
        return Targets(im_file_path=files, obj_file_path=world)

    def _initialize_epoch(self, ep: int) -> Epoch:
        images = self.epoch_map.get_images(ep)
        cameras = self._load_calibrations(images[self.cams[0]].value.shape)
        targets = self._load_targets(images)
        if targets is not None and self._calib_scale != 1.0:
            targets.scale_image_coordinates(self._calib_scale)
        ts = self.epoch_map.get_timestamp(ep)
        return Epoch(timestamp=ts, images=images, cameras=cameras,
                     features={c: Features() for c in self.cams},
                     points=Points(), targets=targets,
                     epoch_dir=self.results_dir / "epochs"
                     / ts.strftime("%Y-%m-%d_%H-%M-%S"))

    def _gcp_prior(self, epoch: Epoch):
        """Pair geometry from surveyed camera centres and targets before
        any matching: each camera's rotation from its target bearings
        (`pose_from_known_center`), and the pair's F. Returns (cameras,
        F) or None; proc.use_gcp_prior: false disables it."""
        if not bool(self.cfg.get("proc", DotDict()).get("use_gcp_prior",
                                                        True)):
            return None
        centers = self.cfg.get("georef", DotDict()).get(
            "camera_centers_world", None)
        if epoch.targets is None or centers is None \
                or epoch.targets.obj_coor is None:
            return None
        labels = list(epoch.targets.obj_coor["label"])
        t_world, found = epoch.targets.get_object_coor_by_label(labels)
        cams = {}
        for i, c in enumerate(self.cams):
            xy, f2 = epoch.targets.get_image_coor_by_label(found, i)
            if len(f2) < 2:
                return None
            w_sel = t_world[[found.index(lab) for lab in f2]]
            cams[c] = pose_from_known_center(
                epoch.cameras[c], np.asarray(centers[i]), xy, w_sel)
        return cams, fundamental_from_cameras(cams[self.cams[0]],
                                              cams[self.cams[1]])

    def _threshold(self) -> float:
        return float(self.cfg.get("other", {}).get("pydegensac_threshold",
                                                   1.0))

    def _match_epoch(self, epoch: Epoch, prev: Epoch | None) -> float:
        """Pair match, then (proc.do_tracking) the previous epoch's
        features tracked into the same frames; returns the seconds the
        tracking took."""
        cfg = self.cfg.get("matching", DotDict())
        pf = self._active_prefetch or {}
        # one object per frame for the match and the tracking: the
        # matcher's feature cache is keyed by the objects' identities
        im0 = pf.get(self.cams[0], epoch.images[self.cams[0]].value)
        im1 = pf.get(self.cams[1], epoch.images[self.cams[1]].value)
        prior = self._gcp_prior(epoch)
        self._epoch_prior = prior
        tile = TileSelection[str(cfg.get("tile_selection", "none")).upper()]
        do_viz = bool(self.cfg.get("other", {}).get("do_viz", False))
        with record_function("matcher"):
            self.matcher.match(
                im0, im1,
                quality=Quality[str(cfg.get("quality", "high")).upper()],
                tile_selection=tile,
                grid=list(cfg.get("grid", [1, 1])),
                overlap=int(cfg.get("overlap", 0)),
                threshold=self._threshold(),
                confidence=float(cfg.get("confidence", 0.9999)),
                geometric_verification=GeometricVerification[str(cfg.get(
                    "geometric_verification", "pydegensac")).upper()],
                do_viz_matches=do_viz,
                save_dir=str(epoch.epoch_dir) if do_viz else None,
                F_prior=(prior[1] if prior is not None else None))

        # tracking reuses the pair match's grid and overlap, so its
        # extraction is the pair match's (the cache hits)
        tracked, track_s = None, 0.0
        if prev is not None and bool(self.cfg.get("proc", DotDict()).get(
                "do_tracking", False)) \
                and all(len(prev.features[c]) for c in self.cams):
            tiled = tile is not TileSelection.NONE
            t0 = self._now()
            with record_function("track"):
                tracked = track_matches(
                    self.matcher, {c: prev.features[c] for c in self.cams},
                    {self.cams[0]: im0, self.cams[1]: im1},
                    grid=tuple(cfg.get("tracking_grid", tuple(
                        cfg.get("grid", (1, 1))) if tiled else (1, 1))),
                    overlap=int(cfg.get("tracking_overlap", int(
                        cfg.get("overlap", 0)) if tiled else 0)),
                    quality=str(cfg.get("quality", "high")))
            track_s = self._now() - t0
        mk0, mk1 = self.matcher.mkpts0, self.matcher.mkpts1
        inl = self.matcher.inlier_mask
        stats = epoch.quality["stats"]
        stats["n_putative"] = len(inl) if inl is not None else len(mk0)
        stats["n_matches"] = len(mk0)
        if len(mk0) < int(self.cfg.get("quality_gates", DotDict()).get(
                "min_matches", 8)):
            epoch.flag("few_matches", "failed", n_matches=len(mk0))
        new_ids = np.arange(self._next_track_id,
                            self._next_track_id + len(mk0), dtype=np.int32)
        self._next_track_id += len(mk0)
        for c, mk, d, s in (
                (self.cams[0], mk0, self.matcher.descriptors0.T,
                 self.matcher.scores0),
                (self.cams[1], mk1, self.matcher.descriptors1.T,
                 self.matcher.scores1)):
            feats = Features()
            feats.append_features_from_numpy(mk, descr=d, scores=s,
                                             track_ids=new_ids)
            epoch.features[c] = feats
        if tracked is not None:
            # tracked features follow the new matches, with their old ids
            for c in self.cams:
                t = tracked[c]
                epoch.features[c].append_features_from_numpy(
                    t.kpts_to_numpy(), descr=t.descr_to_numpy(),
                    scores=t.scores_to_numpy(),
                    track_ids=t.track_ids_to_numpy())
        return track_s

    def _reprojects(self, pts3d: np.ndarray, cam, xy: np.ndarray
                    ) -> np.ndarray:
        """Points that reproject within twice the RANSAC threshold of
        their observations `xy` in `cam` and lie in front of it."""
        err = np.linalg.norm(project_points(pts3d, cam) - xy, axis=1)
        E = np.asarray(cam.extrinsics)
        return (np.isfinite(err) & (err < 2.0 * self._threshold())
                & ((pts3d @ E[2, :3] + E[2, 3]) > 0))

    def _reprojection_keep(self, epoch: Epoch, pts3d, kpts) -> np.ndarray:
        """Triangulated points that reproject within twice the RANSAC
        threshold into both views and lie in front of both cameras."""
        keep = np.isfinite(pts3d).all(axis=1)
        for i, c in enumerate(self.cams):
            keep &= self._reprojects(pts3d, epoch.cameras[c], kpts[i])
        return keep

    def _orient_epoch(self, epoch: Epoch) -> np.ndarray | None:
        proc = self.cfg.get("proc", DotDict())
        if not bool(proc.get("do_orientation", True)):
            return None
        g = self.cfg.get("georef", DotDict())
        kpts = [epoch.features[c].kpts_to_numpy() for c in self.cams]
        n = min(len(k) for k in kpts)
        if n < 8:
            epoch.flag("no_orientation", "failed", n_matches=n)
            return None
        kpts = [k[:n] for k in kpts]
        centers = g.get("camera_centers_world", None)
        baseline = (float(np.linalg.norm(
            np.asarray(centers[0], np.float64)
            - np.asarray(centers[1], np.float64)))
            if centers is not None else None)
        rel = RelativeOrientation([epoch.cameras[c] for c in self.cams],
                                  kpts, device=self.device)
        # seed the essential search with the surveyed pair geometry, else
        # the matcher's verified F; match confidences guide sampling
        prior = getattr(self, "_epoch_prior", None)
        F_hint = prior[1] if prior is not None else self.matcher.F
        mconf = self.matcher.mconf
        scores = None
        if mconf is not None and len(mconf):
            m = np.asarray(mconf, np.float32)
            scores = np.full(n, float(np.median(m)), np.float32)
            scores[:min(n, len(m))] = m[:min(n, len(m))]
        with record_function("ransac"):
            valid = np.asarray(rel.estimate_pose(
                threshold=self._threshold(), scale_factor=baseline,
                scores=scores, F_hint=F_hint), bool)
        epoch.cameras[self.cams[1]] = rel.cameras[1]
        n_inl = int(valid.sum())
        epoch.quality["stats"]["n_orientation_inliers"] = n_inl
        if n_inl < int(self.cfg.get("quality_gates", DotDict()).get(
                "min_inliers", 8)):
            epoch.flag("few_inliers", "failed", n_inliers=n_inl)
        for c in self.cams:
            epoch.features[c].filter_feature_by_mask(valid)
        kpts = [k[valid] for k in kpts]

        with record_function("triangulation"):
            pts3d = Triangulate([epoch.cameras[c] for c in self.cams], kpts,
                                device=self.device).triangulate_two_views()
        # drop the chance inliers of the consensus: points that do not
        # reproject into both views
        keep = self._reprojection_keep(epoch, pts3d, kpts)
        if not keep.all():
            logger.info("reprojection filter: %d / %d triangulated points "
                        "kept", int(keep.sum()), len(keep))
            for c in self.cams:
                epoch.features[c].filter_feature_by_mask(keep)
            pts3d = pts3d[keep]
        epoch.quality["stats"]["n_triangulated"] = len(pts3d)

        if epoch.targets is not None and centers is not None:
            labels = list(g.get("targets_to_use", []))
            t_world, found = epoch.targets.get_object_coor_by_label(labels)
            t_im, ok = [], len(found) >= 2
            for i, c in enumerate(self.cams):
                xy, f2 = epoch.targets.get_image_coor_by_label(found, i)
                ok &= len(f2) == len(found)
                t_im.append(xy)
            if ok:
                abso = AbsoluteOrientation(
                    tuple(epoch.cameras[c] for c in self.cams),
                    points3d_final=t_world, image_points=tuple(t_im),
                    camera_centers_world=tuple(np.asarray(cc)
                                               for cc in centers),
                    device=self.device)
                abso.estimate_transformation_linear(estimate_scale=True)
                pts3d = abso.apply_transformation(points3d=pts3d)
                for i, c in enumerate(self.cams):
                    epoch.cameras[c] = abso.cameras[i]
            else:
                logger.warning("epoch %s: not enough targets for AO",
                               epoch.date_str)
        # after AO, so the resected poses share the points' world frame
        if bool(proc.get("do_space_resection", False)):
            self._space_resection(epoch, centers)
        return np.asarray(pts3d)

    def _space_resection(self, epoch: Epoch, centers) -> None:
        """Each camera's world pose from its visible targets: from two or
        more bearings when its centre is surveyed
        (`pose_from_known_center`), else by PnP RANSAC (`SpaceResection`)
        from six or more. A camera with fewer targets, or whose system is
        singular, keeps its AO pose."""
        if epoch.targets is None or epoch.targets.obj_coor is None:
            return
        labels = list(epoch.targets.obj_coor["label"])
        t_world, found = epoch.targets.get_object_coor_by_label(labels)
        for i, c in enumerate(self.cams):
            xy, f2 = epoch.targets.get_image_coor_by_label(found, i)
            w_sel = t_world[[found.index(lab) for lab in f2]]
            try:
                if len(f2) >= 2 and centers is not None:
                    epoch.cameras[c] = pose_from_known_center(
                        epoch.cameras[c], np.asarray(centers[i]), xy, w_sel)
                elif len(f2) >= 6:
                    epoch.cameras[c] = SpaceResection(
                        epoch.cameras[c], device=self.device).estimate(
                            xy, w_sel, reprojection_error=float(
                                self.cfg.get("other", {}).get(
                                    "pydegensac_threshold", 3.0)))
                else:
                    logger.warning("epoch %s: space resection of %s skipped "
                                   "(%d targets visible)", epoch.date_str, c,
                                   len(f2))
                    continue
                epoch.quality["stats"][f"resection_targets_{c}"] = len(f2)
                logger.info("epoch %s: %s space-resected from %d targets",
                            epoch.date_str, c, len(f2))
            except _RESECTION_ERRORS as e:
                logger.warning("epoch %s: space resection of %s failed: %s "
                               "- keeping the AO pose", epoch.date_str, c, e)

    def _ba_config(self) -> BAConfig:
        ba_cfg = self.cfg.get("ba", DotDict())
        # free_intrinsics: indices into [fx, fy, cx, cy, k1, k2, p1, p2,
        # k3, k4, k5, k6], or "metashape" = f, cx, cy, k1, k2, k3, p1, p2
        fi = ba_cfg.get("free_intrinsics", ())
        if isinstance(fi, str):
            if fi.lower() != "metashape":
                raise ValueError(f"unknown free_intrinsics preset {fi!r}")
            fi = (0, 1, 2, 3, 4, 5, 6, 7, 8)
        rd = ba_cfg.get("robust_delta", 2.0)
        return BAConfig(
            tie_point_sigma_px=float(ba_cfg.get("tiepoint_accuracy", 1.0)),
            marker_projection_sigma_px=float(
                ba_cfg.get("marker_projection_accuracy", 0.5)),
            marker_location_sigma_m=float(
                ba_cfg.get("marker_location_accuracy", 0.01)),
            camera_center_sigma_m=float(
                ba_cfg.get("camera_location_accuracy", 0.5)),
            free_intrinsics=tuple(int(i) for i in fi),
            fit_f=bool(ba_cfg.get("fit_f", True)),
            robust_delta=None if rd is None else float(rd),
            max_iters=int(ba_cfg.get("max_iters", 60)),
            min_points=int(ba_cfg.get("min_points", 10)))

    def _solve(self, *args, **kwargs):
        with record_function("ba"):
            out = BundleAdjustment(*args, device=self.device,
                                   **kwargs).run()
        self._stage["ba_solves"] = self._stage.get("ba_solves", 0) + 1
        self._stage["ba_iterations"] = (self._stage.get("ba_iterations", 0)
                                        + out.iterations)
        return out

    def _bundle_epoch(self, epoch: Epoch, pts3d: np.ndarray) -> np.ndarray:
        ba_cfg = self.cfg.get("ba", DotDict())
        g = self.cfg.get("georef", DotDict())
        obs = {c: epoch.features[c].kpts_to_numpy() for c in self.cams}
        mobs, mworld = None, None
        if epoch.targets is not None:
            mworld, found = epoch.targets.get_object_coor_by_label(
                list(g.get("targets_to_use", [])))
            if len(found):
                mobs = {}
                for i, c in enumerate(self.cams):
                    xy, f2 = epoch.targets.get_image_coor_by_label(found, i)
                    mobs[c] = xy if len(f2) == len(found) else None
                if any(v is None for v in mobs.values()):
                    mobs, mworld = None, None
        centers = g.get("camera_centers_world", None)
        cam_centers = ({c: np.asarray(centers[i])
                        for i, c in enumerate(self.cams)}
                       if centers is not None else {})
        cfg = self._ba_config()
        out = self._solve({c: epoch.cameras[c] for c in self.cams}, obs,
                          pts3d, marker_image_points=mobs,
                          marker_world=mworld, camera_centers=cam_centers,
                          cfg=cfg)
        if not out.ok:
            logger.warning("epoch %s BA refused: %s - keeping pre-BA "
                           "cameras", epoch.date_str, out.failure)
            epoch.flag("ba_failed", "degraded", ba_failure=out.failure)
            return pts3d

        # trim ladder: while the RMSE gate (or the trim target) would
        # fire, keep the largest prefix of points in ascending
        # max-residual order whose static RMS meets the target, bounded
        # by trim_frac and trim_max_frac, and re-solve from the refined
        # state; the features follow the kept points
        max_rmse = float(self.cfg.get("quality_gates", DotDict()).get(
            "max_ba_rmse_px", 10.0))
        target = ba_cfg.get("trim_target_rmse_px", None)
        stop_rmse = max_rmse if target is None else min(max_rmse,
                                                        float(target))
        trim_frac = float(ba_cfg.get("trim_frac", 0.2))
        trim_max = float(ba_cfg.get("trim_max_frac", 0.4))
        min_keep = max(int(cfg.min_points), 16)
        for _ in range(int(ba_cfg.get("trim_rounds", 2))):
            if out.reprojection_rmse_px <= stop_rmse or trim_frac <= 0:
                break
            res = np.zeros(len(out.points))
            sse = np.zeros(len(out.points))
            for c in self.cams:
                err = np.linalg.norm(project_points(out.points,
                                                    out.cameras[c])
                                     - obs[c], axis=1)
                err = np.nan_to_num(err, nan=np.inf)
                res = np.maximum(res, err)
                sse += np.minimum(err, 1e12) ** 2
            order = np.argsort(res)
            prefix_rms = np.sqrt(np.cumsum(sse[order])
                                 / (len(self.cams)
                                    * np.arange(1, len(res) + 1)))
            good = np.nonzero(prefix_rms <= 0.95 * stop_rmse)[0]
            n_target = int(good[-1]) + 1 if len(good) else min_keep
            n_floor = int(np.ceil(len(res) * (1.0 - trim_frac)))
            n_cap = int(np.ceil(len(res) * (1.0 - trim_max)))
            n_keep = max(min(n_target, n_floor), n_cap, min_keep)
            keep = np.zeros(len(res), bool)
            keep[order[:n_keep]] = True
            if int(keep.sum()) < min_keep or int((~keep).sum()) == 0:
                break
            logger.info("epoch %s BA trim: rmse %.3f px > %.2f - dropping "
                        "%d / %d worst-residual points", epoch.date_str,
                        out.reprojection_rmse_px, stop_rmse,
                        int((~keep).sum()), len(keep))
            for c in self.cams:
                epoch.features[c].filter_feature_by_mask(keep)
                obs[c] = obs[c][keep]
            out2 = self._solve(out.cameras, obs, out.points[keep],
                               marker_image_points=mobs, marker_world=mworld,
                               camera_centers=cam_centers, cfg=cfg)
            if not out2.ok:
                break
            out = out2

        logger.info("epoch %s BA: rmse %.3f px in %d iters", epoch.date_str,
                    out.reprojection_rmse_px, out.iterations)
        epoch.quality["stats"]["ba_rmse_px"] = out.reprojection_rmse_px
        if out.reprojection_rmse_px > max_rmse:
            epoch.flag("ba_rmse", "degraded",
                       ba_rmse_px=out.reprojection_rmse_px)
        for c in self.cams:
            epoch.cameras[c] = out.cameras[c]
        return out.points

    # -- n cameras --------------------------------------------------------------

    def _process_multicam(self, epoch: Epoch, prev: Epoch | None):
        """Master-centric epoch of more than two cameras: track the
        previous epoch's features into every camera (proc.do_tracking),
        match the master against each slave, merge the matches into
        tracks keyed by the master keypoint (its coordinates in tenths
        of a pixel), orient each slave against the master, triangulate
        each track with the first slave that sees it, georeference on
        the targets and adjust over the (P, C) observation grid, NaN
        where a camera does not see a track. Returns (points, {cam:
        (P, 2) grid}), or (None, None) with fewer than 8 tracks.

        The master is extracted again for each slave: a match extracts
        both frames, and the feature cache serves only the tracking of
        the last match's pair."""
        cfg = self.cfg.get("matching", DotDict())
        proc = self.cfg.get("proc", DotDict())
        g = self.cfg.get("georef", DotDict())
        master, slaves = self.cams[0], self.cams[1:]
        pf = self._active_prefetch or {}
        frames = {c: pf.get(c, epoch.images[c].value) for c in self.cams}
        quality = Quality[str(cfg.get("quality", "high")).upper()]
        tile = TileSelection[str(cfg.get("tile_selection", "none")).upper()]
        tiled = tile is not TileSelection.NONE
        t = self._now()

        tracked = None
        if prev is not None and bool(proc.get("do_tracking", False)) \
                and all(len(prev.features.get(c, [])) for c in self.cams):
            with record_function("track"):
                tracked = track_matches(
                    self.matcher, {c: prev.features[c] for c in self.cams},
                    frames,
                    grid=tuple(cfg.get("tracking_grid", tuple(
                        cfg.get("grid", (1, 1))) if tiled else (1, 1))),
                    overlap=int(cfg.get("tracking_overlap", int(
                        cfg.get("overlap", 0)) if tiled else 0)),
                    quality=str(cfg.get("quality", "high")))
            t = self._add_time("track_s", t)

        tracks: dict[tuple, dict] = {}
        for sl in slaves:
            with record_function("matcher"):
                self.matcher.match(frames[master], frames[sl],
                                   quality=quality, tile_selection=tile,
                                   grid=list(cfg.get("grid", [1, 1])),
                                   overlap=int(cfg.get("overlap", 0)),
                                   threshold=self._threshold())
            inl = self.matcher.inlier_mask
            epoch.quality["stats"][f"n_putative_{sl}"] = (
                len(inl) if inl is not None else len(self.matcher.mkpts0))
            epoch.quality["stats"][f"n_matches_{sl}"] = len(
                self.matcher.mkpts0)
            d_m = self.matcher.descriptors0.T
            d_s = self.matcher.descriptors1.T
            s_m, s_s = self.matcher.scores0, self.matcher.scores1
            for i, (xym, xys) in enumerate(zip(self.matcher.mkpts0,
                                               self.matcher.mkpts1)):
                key = (round(float(xym[0]) * 10), round(float(xym[1]) * 10))
                e = tracks.setdefault(key, {"m": xym, "md": d_m[i],
                                            "ms": s_m[i], "obs": {}})
                e["obs"][sl] = (xys, d_s[i], s_s[i])
        t = self._add_time("match_s", t)
        if len(tracks) < 8:
            logger.warning("epoch %s: %d multicam tracks", epoch.date_str,
                           len(tracks))
            return None, None

        track_list = list(tracks.values())
        p = len(track_list)
        ids = np.arange(self._next_track_id, self._next_track_id + p,
                        dtype=np.int32)
        self._next_track_id += p
        dd = self.matcher.descriptor_dim
        xy = {master: np.stack([tr["m"] for tr in track_list])}
        descr = {master: np.stack([tr["md"] for tr in track_list])}
        scores = {master: np.asarray([tr["ms"] for tr in track_list],
                                     np.float32)}
        for sl in slaves:
            a = np.full((p, 2), np.nan, np.float32)
            d = np.zeros((p, dd), np.float32)
            s = np.zeros((p,), np.float32)
            for i, tr in enumerate(track_list):
                if sl in tr["obs"]:
                    a[i], d[i], s[i] = tr["obs"][sl]
            xy[sl], descr[sl], scores[sl] = a, d, s

        # each slave against the master, the scale from the surveyed
        # centres; a slave's orientation outliers leave its grid column
        centers = g.get("camera_centers_world", None)
        cam_m = epoch.cameras[master]
        for si, sl in enumerate(slaves, start=1):
            seen = np.isfinite(xy[sl]).all(axis=1)
            if seen.sum() < 8:
                continue
            baseline = (float(np.linalg.norm(np.asarray(centers[0])
                                             - np.asarray(centers[si])))
                        if centers is not None else None)
            rel = RelativeOrientation([cam_m, epoch.cameras[sl]],
                                      [xy[master][seen], xy[sl][seen]],
                                      device=self.device)
            with record_function("ransac"):
                valid = np.asarray(rel.estimate_pose(
                    threshold=self._threshold(), scale_factor=baseline),
                    bool)
            epoch.cameras[sl] = rel.cameras[1]
            epoch.quality["stats"][f"n_orientation_inliers_{sl}"] = int(
                valid.sum())
            xy[sl][np.where(seen)[0][~valid]] = np.nan

        pts3d = np.full((p, 3), np.nan, np.float32)
        for sl in slaves:
            todo = np.isnan(pts3d[:, 0]) & np.isfinite(xy[sl]).all(axis=1)
            if todo.sum() < 2:
                continue
            with record_function("triangulation"):
                pts3d[todo] = Triangulate(
                    [cam_m, epoch.cameras[sl]],
                    [xy[master][todo], xy[sl][todo]],
                    device=self.device).triangulate_two_views()
        self._multicam_reprojection_filter(epoch, pts3d, xy)
        # tracks that never triangulated leave: zeros would feed origin
        # points with real master observations into the BA and the sinks
        ok = np.isfinite(pts3d).all(axis=1)
        if not ok.all():
            logger.info("multicam: dropping %d / %d untriangulated tracks",
                        int((~ok).sum()), p)
        pts3d, ids = pts3d[ok], ids[ok]
        for c in self.cams:
            xy[c], descr[c], scores[c] = xy[c][ok], descr[c][ok], \
                scores[c][ok]
        p = int(ok.sum())
        epoch.quality["stats"]["n_tracks"] = p
        if p < 8:
            logger.warning("epoch %s: %d triangulated multicam tracks",
                           epoch.date_str, p)
            epoch.flag("few_inliers", "failed", n_tracks=p)
            return None, None

        if epoch.targets is not None and centers is not None:
            labels = list(g.get("targets_to_use", []))
            t_world, found = epoch.targets.get_object_coor_by_label(labels)
            t_im, all_found = [], len(found) >= 2
            for i, c in enumerate(self.cams):
                txy, f2 = epoch.targets.get_image_coor_by_label(found, i)
                all_found &= len(f2) == len(found)
                t_im.append(txy)
            if all_found:
                abso = AbsoluteOrientation(
                    tuple(epoch.cameras[c] for c in self.cams),
                    points3d_final=t_world, image_points=tuple(t_im[:2]),
                    camera_centers_world=tuple(np.asarray(cc)
                                               for cc in centers),
                    device=self.device)
                abso.estimate_transformation_linear(estimate_scale=True)
                pts3d = abso.apply_transformation(points3d=pts3d)
                for i, c in enumerate(self.cams):
                    epoch.cameras[c] = abso.cameras[i]
        t = self._add_time("orient_s", t)

        # the BA over the (P, C) grid takes three keys of the ba block,
        # as in the JAX package
        if bool(proc.get("do_ba", True)):
            ba_cfg = self.cfg.get("ba", DotDict())
            out = self._solve(
                {c: epoch.cameras[c] for c in self.cams}, xy,
                np.asarray(pts3d, np.float32),
                camera_centers=({c: np.asarray(centers[i])
                                 for i, c in enumerate(self.cams)}
                                if centers is not None else {}),
                cfg=BAConfig(
                    camera_center_sigma_m=float(ba_cfg.get(
                        "camera_location_accuracy", 0.5)),
                    fit_f=bool(ba_cfg.get("fit_f", False)),
                    max_iters=int(ba_cfg.get("max_iters", 60))))
            if out.ok:
                epoch.quality["stats"]["ba_rmse_px"] = \
                    out.reprojection_rmse_px
                for c in self.cams:
                    epoch.cameras[c] = out.cameras[c]
                pts3d = out.points
            else:
                logger.warning("epoch %s BA refused: %s - keeping pre-BA "
                               "cameras", epoch.date_str, out.failure)
                epoch.flag("ba_failed", "degraded", ba_failure=out.failure)
            t = self._add_time("ba_s", t)

        # per-camera features (the master: every track; a slave: those it
        # sees), with descriptors and scores to seed the next tracking
        for c in self.cams:
            seen = np.isfinite(xy[c]).all(axis=1)
            feats = Features(descr_dim=dd)
            feats.append_features_from_numpy(
                xy[c][seen], descr=descr[c][seen], scores=scores[c][seen],
                track_ids=ids[seen])
            if tracked is not None and len(tracked[c]):
                tr = tracked[c]
                feats.append_features_from_numpy(
                    tr.kpts_to_numpy(), descr=tr.descr_to_numpy(),
                    scores=tr.scores_to_numpy(),
                    track_ids=tr.track_ids_to_numpy())
            epoch.features[c] = feats
        return pts3d, xy

    def _multicam_reprojection_filter(self, epoch: Epoch, pts3d: np.ndarray,
                                      xy: dict) -> None:
        """Drop, in place, the observations of the triangulated tracks that
        do not reproject within twice the RANSAC threshold or lie behind
        their camera: a slave's leaves its grid column, a master's failure
        drops the track, and so does a track no slave sees any more.

        The JAX package has no such filter on its n-camera path (its
        stereo path has `_reprojection_keep`): a slave's mismatch that
        lies along its epipolar line passes the slave's orientation test,
        and on full-size frames such observations, hundreds of pixels off
        the track's point, reach its BA, which has no robust loss, and
        collapse the rig (ROADMAP section 3)."""
        tri = np.isfinite(pts3d).all(axis=1)
        n_before = {c: int((tri & np.isfinite(xy[c]).all(axis=1)).sum())
                    for c in self.cams}
        for c in self.cams:
            seen = tri & np.isfinite(xy[c]).all(axis=1)
            bad = np.zeros_like(seen)
            bad[seen] = ~self._reprojects(pts3d[seen], epoch.cameras[c],
                                          xy[c][seen])
            if c == self.cams[0]:
                pts3d[bad] = np.nan
                tri &= ~bad
            else:
                xy[c][bad] = np.nan
        multi = np.logical_or.reduce([np.isfinite(xy[sl]).all(axis=1)
                                      for sl in self.cams[1:]])
        pts3d[~multi] = np.nan
        dropped = {c: n_before[c] - int((np.isfinite(pts3d).all(axis=1)
                                         & np.isfinite(xy[c]).all(axis=1))
                                        .sum()) for c in self.cams}
        epoch.quality["stats"]["n_reprojection_dropped"] = dropped
        if any(dropped.values()):
            logger.info("multicam reprojection filter dropped %s "
                        "observations", dropped)

    # -- recovery ladder --------------------------------------------------------

    @classmethod
    def _needs_recovery(cls, epoch: Epoch) -> bool:
        return epoch.quality["status"] != "ok" \
            and bool(set(epoch.quality["flags"]) & cls._RECOVERABLE)

    @staticmethod
    def _epoch_score(epoch: Epoch) -> tuple:
        """Lower is better: status rank, BA RMSE (missing is worst), then
        more orientation inliers."""
        q = epoch.quality
        rank = {"ok": 0, "degraded": 1, "failed": 2}[q["status"]]
        rmse = q["stats"].get("ba_rmse_px", np.inf)
        if not np.isfinite(rmse):
            rmse = np.inf
        return (rank, rmse, -q["stats"].get("n_orientation_inliers", 0))

    def _relaxed_matcher_options(self, epoch: Epoch):
        """(options, verification threshold or None) of the recovery
        rematch. NN, SIFT and semi-dense: a widened epipolar band and
        permissive ratio and similarity thresholds, each override only
        ever more permissive than the live matcher's; LightGlue and
        SuperGlue: a lowered filter threshold (which SuperGlue does not
        read, as in the JAX package), LoFTR a lowered confidence
        threshold, and a widened verification threshold."""
        rec = self.cfg.get("recovery", DotDict())
        m_cfg = self.cfg.get("matching", DotDict())
        opt = dict(m_cfg.get("options", {}) or {})
        if "max_keypoints" in m_cfg:
            opt.setdefault("max_keypoints", int(m_cfg.max_keypoints))
        if isinstance(self.matcher, NearestNeighborMatcher):
            base_band = float(opt.get("guided_band_px", 3.0))
            opt.update({
                "guided_band_px": float(rec.get("guided_band_px",
                                                3.0 * base_band)),
                "guided_ratio": float(rec.get("guided_ratio", 0.95)),
                "guided_min_sim": float(rec.get("guided_min_sim", 0.55)),
            })
            # the plain NN matcher runs without a ratio test: forcing one
            # would make the retry stricter than the failure
            if self.matcher._ratio_th is not None:
                opt["ratio_threshold"] = max(
                    float(rec.get("ratio_threshold", 0.97)),
                    float(self.matcher._ratio_th))
            if hasattr(self.matcher, "_sim_th"):
                opt["distance_threshold"] = min(
                    float(rec.get("distance_threshold", 0.5)),
                    float(self.matcher._sim_th))
            logger.info("epoch %s: recovery rematch with relaxed guidance "
                        "(band %.1f px)", epoch.date_str,
                        opt["guided_band_px"])
            return opt, None
        if isinstance(self.matcher, LoFTRMatcher):
            opt["confidence_threshold"] = min(
                float(rec.get("confidence_threshold", 0.1)),
                float(opt.get("confidence_threshold", 0.2)))
        else:
            opt["filter_threshold"] = min(
                float(rec.get("filter_threshold", 0.0)),
                float(opt.get("filter_threshold", 0.1)))
        relaxed_gv = float(rec.get("gv_threshold", 2.0 * self._threshold()))
        logger.info("epoch %s: recovery rematch with relaxed learned-"
                    "matcher thresholds (GV %.1f px)", epoch.date_str,
                    relaxed_gv)
        return opt, relaxed_gv

    def _recover_epoch(self, ep: int, epoch: Epoch, pts3d,
                       prev: Epoch | None):
        """Step 1: re-run match -> orient -> BA with relaxed matcher
        settings (`_relaxed_matcher_options`), adopted only if it scores
        strictly better. Step 2: with surveyed geometry, pin the cameras
        to the prior poses and re-triangulate and re-adjust from
        there."""
        rec = self.cfg.get("recovery", DotDict())
        proc = self.cfg.get("proc", DotDict())
        if bool(rec.get("relaxed_rematch", True)):
            opt, relaxed_gv = self._relaxed_matcher_options(epoch)
            saved_matcher = self.matcher
            other = self.cfg.setdefault("other", DotDict())
            saved_th = other.get("pydegensac_threshold", 1.0)
            try:
                self.matcher = type(saved_matcher)(opt, device=self.device)
                if relaxed_gv is not None:
                    other["pydegensac_threshold"] = relaxed_gv
                retry = self._initialize_epoch(ep)
                self._match_epoch(retry, prev)
                pts_retry = self._orient_epoch(retry)
                if pts_retry is not None and bool(proc.get("do_ba", True)):
                    pts_retry = self._bundle_epoch(retry, pts_retry)
            except Exception as e:  # recovery must never sink an epoch
                logger.warning("epoch %s: recovery rematch failed: %s",
                               epoch.date_str, e)
                retry, pts_retry = None, None
            finally:
                self.matcher = saved_matcher
                other["pydegensac_threshold"] = saved_th
            if retry is not None \
                    and self._epoch_score(retry) < self._epoch_score(epoch):
                retry.quality["stats"]["recovered"] = "relaxed_rematch"
                logger.info("epoch %s: relaxed rematch adopted (%s -> %s)",
                            epoch.date_str, epoch.quality["status"],
                            retry.quality["status"])
                epoch, pts3d = retry, pts_retry

        if self._needs_recovery(epoch) and bool(rec.get("gcp_fallback",
                                                        True)):
            prior = self._gcp_prior(epoch)
            if prior is not None:
                recovered = self._gcp_fallback(epoch, prior)
                if recovered is not None:
                    pts3d = recovered
        return epoch, pts3d

    def _gcp_fallback(self, epoch: Epoch, prior) -> np.ndarray | None:
        """Replace a divergent epoch geometry with the surveyed prior:
        bearing-resected cameras, re-triangulated verified matches,
        reprojection-filtered, then BA with tight camera-centre priors.
        Returns the recovered points or None."""
        proc = self.cfg.get("proc", DotDict())
        cams_prior, _F = prior
        kpts = [epoch.features[c].kpts_to_numpy() for c in self.cams]
        n = min(len(k) for k in kpts)
        if n < 8:
            return None
        kpts = [k[:n] for k in kpts]
        for c in self.cams:
            epoch.cameras[c] = cams_prior[c]
        with record_function("triangulation"):
            pts3d = np.asarray(Triangulate(
                [epoch.cameras[c] for c in self.cams], kpts,
                device=self.device).triangulate_two_views())
        keep = self._reprojection_keep(epoch, pts3d, kpts)
        min_pts = int(self.cfg.get("ba", DotDict()).get("min_points", 10))
        if int(keep.sum()) < max(min_pts, 16):
            logger.warning("epoch %s: GCP fallback kept only %d points - "
                           "not adopted", epoch.date_str, int(keep.sum()))
            return None
        for c in self.cams:
            epoch.features[c].filter_feature_by_mask(keep)
        pts3d = pts3d[keep]
        logger.info("epoch %s: GCP-prior fallback with %d points",
                    epoch.date_str, len(pts3d))
        stats = dict(epoch.quality["stats"])
        stats["recovered"] = "gcp_prior"
        stats["n_triangulated"] = len(pts3d)
        epoch.quality = {"status": "ok", "flags": [], "stats": stats}
        if bool(proc.get("do_ba", True)):
            # as in the JAX package, the tighter sigma reaches the solve
            # only through a config that has a ba block
            ba_blk = self.cfg.get("ba", DotDict())
            saved_sigma = ba_blk.get("camera_location_accuracy", 0.5)
            ba_blk["camera_location_accuracy"] = float(
                self.cfg.get("recovery", DotDict()).get(
                    "fallback_center_sigma_m", 0.05))
            try:
                pts3d = self._bundle_epoch(epoch, pts3d)
            finally:
                ba_blk["camera_location_accuracy"] = saved_sigma
        return pts3d

    # -- dense -------------------------------------------------------------------

    def _dense_epoch(self, epoch: Epoch, pts3d: np.ndarray) -> None:
        """Dense cloud of the epoch's first two cameras: PlaneSweepStereo at the
        `dense` block's settings over a depth range from the sparse
        cloud's 2nd and 98th distance percentiles, optional SOR, and
        `dense_<date>.ply` in the epoch's directory."""
        dn = self.cfg.get("dense", DotDict())
        cam0 = epoch.cameras[self.cams[0]]
        d = np.linalg.norm(pts3d - np.asarray(cam0.C).reshape(1, 3), axis=1)
        d_lo = float(np.percentile(d, 2) * float(dn.get("near_margin", 0.7)))
        d_hi = float(np.percentile(d, 98) * float(dn.get("far_margin", 1.5)))
        pair = self.cams[:2]
        pss = PlaneSweepStereo(
            [epoch.cameras[c] for c in pair],
            [epoch.images[c].value for c in pair],
            depth_min=d_lo, depth_max=d_hi,
            n_planes=int(dn.get("n_planes", 128)),
            window=int(dn.get("window", 7)),
            downscale=int(dn.get("downscale", 1)),
            cost_threshold=float(dn.get("cost_threshold", 0.4)),
            uniqueness_threshold=float(dn.get("uniqueness_threshold", 0.99)),
            device=self.device)
        with record_function("dense"):
            pss.run()
            pts, colors = pss.to_point_cloud()
        pc = PointCloud(points3d=pts, points_col=colors)
        if bool(self.cfg.get("other", {}).get("do_SOR_filter", False)) \
                and len(pc) > 100:
            pc.sor_filter(device=self.device)
        epoch.point_cloud = pc
        epoch.epoch_dir.mkdir(parents=True, exist_ok=True)
        pc.write_ply(epoch.epoch_dir / f"dense_{epoch.date_str}.ply")
        logger.info("epoch %s dense cloud: %d points", epoch.date_str,
                    len(pc))

    # -- season loop -----------------------------------------------------------

    def _bump_track_ids(self, epoch: Epoch) -> None:
        """Keep the track-id allocator ahead of ids already in use."""
        for c in self.cams:
            ids = epoch.features[c].track_ids_to_numpy()
            if len(ids):
                self._next_track_id = max(self._next_track_id,
                                          int(ids.max()) + 1)

    def _finalize_epoch(self, epoch: Epoch, pts3d,
                        image_points: dict | None = None) -> None:
        """Points, CSV sinks and checkpoint. image_points: {cam: (P, 2)}
        NaN-padded observations aligned with pts3d (the multicam grid);
        by default each camera's features."""
        proc = self.cfg.get("proc", DotDict())
        if pts3d is not None:
            pts_obj = Points()
            pts_obj.append_points_from_numpy(
                pts3d, track_ids=epoch.features[
                    self.cams[0]].track_ids_to_numpy()[:len(pts3d)])
            epoch.points = pts_obj
            if image_points is None:
                image_points = {
                    c: epoch.features[c].kpts_to_numpy()[:len(pts3d)]
                    for c in self.cams}
            # no rows for the distributed warm-seed epoch: its owner
            # process writes them
            if not self._suppress_sinks:
                cameras = {c: epoch.cameras[c] for c in self.cams}
                write_reprojection_error_to_file(
                    self.results_dir / "residuals_image.csv",
                    epoch.date_str, cameras, pts3d, image_points)
                write_cameras_to_file(
                    self.results_dir / "estimated_cameras.csv",
                    epoch.date_str, cameras)
        if bool(proc.get("save_checkpoints", True)):
            epoch.save_pickle(epoch.epoch_dir / f"{epoch.date_str}.pickle")

    def process_epoch(self, ep: int, prev: Epoch | None = None) -> Epoch:
        proc = self.cfg.get("proc", DotDict())
        self._stage = {}
        t = self._now()
        epoch = self._initialize_epoch(ep)
        pkl = epoch.epoch_dir / f"{epoch.date_str}.pickle"
        if bool(proc.get("load_existing_results", False)) and pkl.exists():
            try:
                loaded = Epoch.read_pickle(pkl)
                self._bump_track_ids(loaded)
                logger.info("epoch %s loaded from checkpoint",
                            epoch.date_str)
                return loaded
            except Exception as e:  # a corrupted checkpoint is rebuilt
                logger.warning("re-processing epoch %s: %s", epoch.date_str,
                               e)
        # the worker thread may be adding an entry: take a snapshot of the
        # keys (a late prefetch of this epoch would otherwise stay)
        self._active_prefetch = self._prefetched.pop(ep, None)
        for k in [k for k in list(self._prefetched) if k <= ep]:
            self._prefetched.pop(k, None)
        t = self._add_time("decode_s", t)
        image_points = None
        if len(self.cams) > 2:
            pts3d, image_points = self._process_multicam(epoch, prev)
            t = self._now()
        else:
            track_s = self._match_epoch(epoch, prev)
            t = self._add_time("match_s", t)
            if bool(proc.get("do_tracking", False)):
                self._stage["match_s"] -= track_s
                self._stage["track_s"] = track_s
            pts3d = self._orient_epoch(epoch)
            t = self._add_time("orient_s", t)
            if pts3d is not None and bool(proc.get("do_ba", True)):
                pts3d = self._bundle_epoch(epoch, pts3d)
            t = self._add_time("ba_s", t)
            if bool(proc.get("do_recovery", True)) and self._needs_recovery(
                    epoch):
                epoch, pts3d = self._recover_epoch(ep, epoch, pts3d, prev)
                t = self._add_time("recovery_s", t)
        self._active_prefetch = None
        if pts3d is not None and len(pts3d) > 10 \
                and bool(proc.get("do_dense", False)):
            self._dense_epoch(epoch, pts3d)
            t = self._add_time("dense_s", t)
        self._finalize_epoch(epoch, pts3d, image_points)
        self._add_time("finalize_s", t)
        self.stage_times[ep] = dict(self._stage)
        return epoch

    def run(self, on_epoch=None) -> Epoches:
        """Process the configured season; `on_epoch(epoch)` is called
        after each epoch (an exception there aborts the season)."""
        proc = self.cfg.get("proc", DotDict())
        todo = proc.get("epoch_to_process", "all")
        if todo == "all" or todo is None:
            todo = list(range(len(self.epoch_map)))
        todo = [ep for ep in todo if ep < len(self.epoch_map)]
        prev = None
        try:
            with ThreadPoolExecutor(max_workers=1) as pool:
                for i, ep in enumerate(todo):
                    if i + 1 < len(todo):
                        pool.submit(self._prefetch_epoch_images,
                                    todo[i + 1])
                    logger.info("=== Epoch %d / %d ===", ep, len(todo))
                    epoch = self.process_epoch(ep, prev)
                    self.epoches.add_epoch(epoch, ep)
                    prev = epoch
                    if on_epoch is not None:
                        on_epoch(epoch)
        finally:
            self._prefetched.clear()
            self._active_prefetch = None
        self.summarize_quality()
        if bool(proc.get("do_homography_warping", False)):
            self._homography_warping()
        return self.epoches

    def _homography_warping(self) -> None:
        """Warp proc.camera_to_warp's frame of every epoch (default: the
        last camera) onto the reference epoch's orientation, with the
        rotations median-smoothed over proc.warping_smooth_window epochs;
        JPGs land in results_dir/warped. The reference epoch is
        proc.warping_reference_day (a date such as "2022_07_28") or
        proc.warping_reference_epoch (an index, default 0)."""
        from icepy4d_tpu_torch.utils.homography import homography_warping

        proc = self.cfg.get("proc", DotDict())
        cam = proc.get("camera_to_warp", None) or self.cams[-1]
        if cam not in self.cams:
            logger.warning("camera_to_warp %r unknown (cams: %s) - skipping "
                           "warping", cam, self.cams)
            return
        ref = int(proc.get("warping_reference_epoch", 0))
        day = proc.get("warping_reference_day", None)
        if day is not None:
            want = str(day).replace("_", "-").replace(":", "-")[:10]
            rid = next((eid for eid in sorted(self.epoches._epochs)
                        if self.epoches[eid].date_str[:10] == want), None)
            if rid is None:
                logger.warning("warping_reference_day %s not in the season - "
                               "using epoch %d", day, ref)
            else:
                ref = rid
        logger.info("homography warping of %s onto epoch %d", cam, ref)
        homography_warping(
            self.epoches, cam, reference_epoch=ref,
            smooth_window=int(proc.get("warping_smooth_window", 2)),
            out_dir=self.results_dir / "warped", device=self.device)

    def summarize_quality(self) -> dict:
        """Per-status epoch counts and the flagged epochs by name."""
        counts = {"ok": 0, "degraded": 0, "failed": 0}
        flagged = {}
        for ep in self.epoches:
            q = ep.quality
            counts[q["status"]] = counts.get(q["status"], 0) + 1
            if q["flags"]:
                flagged[ep.date_str] = list(q["flags"])
        logger.info("season quality: %d ok / %d degraded / %d failed",
                    counts["ok"], counts["degraded"], counts["failed"])
        for date, flags in flagged.items():
            logger.warning("  epoch %s: %s", date, ", ".join(flags))
        return {"counts": counts, "flagged": flagged}
