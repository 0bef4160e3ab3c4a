"""Multi-epoch stereo pipeline.

Counterpart of the stereo path of `icepy4d_tpu/pipeline.py`. Per epoch:
match (SuperPoint + LightGlue, SuperPoint + mutual NN, or SIFT + Lowe
NN with the epipolar-guided rematch, each with geometric verification)
-> temporal tracking of the previous epoch's features (proc.do_tracking)
-> relative orientation -> triangulation -> reprojection and cheirality
filter -> absolute orientation on targets -> bundle adjustment with the
adaptive trim ladder -> recovery ladder for gated epochs -> dense
reconstruction (proc.do_dense) -> sparse points, CSV sinks and
checkpoint. `run()` decodes and uploads the next epoch's frames in a
worker thread while the current epoch computes.

The config is the JAX `Pipeline`'s: a dict (or a YAML path) with the
sections paths, proc, matching, georef, ba, quality_gates, recovery,
dense and other. Paths the port does not run yet raise
NotImplementedError naming what they wait for: more than two cameras,
space resection, homography warping, the superglue, loftr and semidense
matchers, LightGlue's adaptive forward, other.do_viz, `run_batched`,
`run_distributed`, `watch` and `warmup`.

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
                                        LightGlueMatcher,
                                        NearestNeighborMatcher, Quality,
                                        SIFTMatcher, TileSelection,
                                        track_matches)
from icepy4d_tpu_torch.matching.matchers import _host_gray
from icepy4d_tpu_torch.sfm import (AbsoluteOrientation, BAConfig,
                                   BundleAdjustment, PlaneSweepStereo,
                                   RelativeOrientation, Triangulate,
                                   fundamental_from_cameras,
                                   pose_from_known_center)
from icepy4d_tpu_torch.sfm.geometry import project_points
from icepy4d_tpu_torch.utils.config import DotDict, parse_cfg

logger = logging.getLogger("icepy4d_tpu_torch")

MATCHERS = {
    "lightglue": LightGlueMatcher,
    "nn": NearestNeighborMatcher,
    "sift": SIFTMatcher,
}
# the JAX package's other matchers, which the port does not run yet
_UNPORTED_MATCHERS = ("superglue", "loftr", "semidense")
_UNPORTED_FLAGS = {
    "do_space_resection": "SpaceResection (ransac_pnp and pnp_dlt)",
    "do_homography_warping": "the homography warping of the season",
}


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to icepy4d_tpu_torch "
                               "yet")


class Pipeline:
    """Config-driven stereo pipeline.

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
        for key, what in _UNPORTED_FLAGS.items():
            if bool(proc.get(key, False)):
                raise _not_ported(f"proc.{key}: {what}")
        if bool(cfg.get("other", {}).get("do_viz", False)):
            raise _not_ported("other.do_viz (the match plot and the "
                              "matched keypoints as text)")
        m_cfg = cfg.get("matching", DotDict())
        name = str(m_cfg.get("matcher", "lightglue")).lower()
        if name in _UNPORTED_MATCHERS:
            raise _not_ported(f"the {name} matcher")
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
        if len(self.cams) > 2:
            raise _not_ported("the multicam pipeline (more than two "
                              "cameras; triangulate_nviews)")
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

    # -- unported entry points ----------------------------------------------

    def run_batched(self, *args, **kwargs):
        raise _not_ported("run_batched (the batched season over a mesh)")

    def run_distributed(self, *args, **kwargs):
        raise _not_ported("run_distributed (the multi-process season)")

    def watch(self, *args, **kwargs):
        raise _not_ported("watch (the polling monitor)")

    def warmup(self, *args, **kwargs):
        raise _not_ported("warmup (the dummy match that builds programs)")

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

    def _reprojection_keep(self, epoch: Epoch, pts3d, kpts) -> np.ndarray:
        """Triangulated points that reproject within twice the RANSAC
        threshold into both views and lie in front of both cameras."""
        th = 2.0 * self._threshold()
        keep = np.isfinite(pts3d).all(axis=1)
        for i, c in enumerate(self.cams):
            err = np.linalg.norm(project_points(pts3d, epoch.cameras[c])
                                 - kpts[i], axis=1)
            keep &= np.isfinite(err) & (err < th)
            E = np.asarray(epoch.cameras[c].extrinsics)
            keep &= (pts3d @ E[2, :3] + E[2, 3]) > 0
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
        return np.asarray(pts3d)

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
        rematch. NN and SIFT: a widened epipolar band and permissive
        ratio and similarity thresholds, each override only ever more
        permissive than the live matcher's; LightGlue: a lowered filter
        threshold and a widened verification threshold."""
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
        """Dense cloud of the epoch's pair: PlaneSweepStereo at the
        `dense` block's settings over a depth range from the sparse
        cloud's 2nd and 98th distance percentiles, optional SOR, and
        `dense_<date>.ply` in the epoch's directory."""
        dn = self.cfg.get("dense", DotDict())
        cam0 = epoch.cameras[self.cams[0]]
        d = np.linalg.norm(pts3d - np.asarray(cam0.C).reshape(1, 3), axis=1)
        d_lo = float(np.percentile(d, 2) * float(dn.get("near_margin", 0.7)))
        d_hi = float(np.percentile(d, 98) * float(dn.get("far_margin", 1.5)))
        pss = PlaneSweepStereo(
            [epoch.cameras[c] for c in self.cams],
            [epoch.images[c].value for c in self.cams],
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

    def _finalize_epoch(self, epoch: Epoch, pts3d) -> None:
        """Points, CSV sinks and checkpoint."""
        proc = self.cfg.get("proc", DotDict())
        if pts3d is not None:
            pts_obj = Points()
            pts_obj.append_points_from_numpy(
                pts3d, track_ids=epoch.features[
                    self.cams[0]].track_ids_to_numpy()[:len(pts3d)])
            epoch.points = pts_obj
            image_points = {c: epoch.features[c].kpts_to_numpy()[:len(pts3d)]
                            for c in self.cams}
            cameras = {c: epoch.cameras[c] for c in self.cams}
            write_reprojection_error_to_file(
                self.results_dir / "residuals_image.csv", epoch.date_str,
                cameras, pts3d, image_points)
            write_cameras_to_file(self.results_dir / "estimated_cameras.csv",
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
        self._finalize_epoch(epoch, pts3d)
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
        return self.epoches

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
