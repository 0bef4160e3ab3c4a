"""User-facing bundle adjustment.

Counterpart of `icepy4d_tpu/sfm/bundle.py`: `BundleAdjustment` builds a
BA problem from cameras, tie-point observations, points, optional
markers (targets) and camera-centre priors, solves it with the Schur LM
of `ops/ba.py` on the device, and returns refined cameras and points.
Weights follow Metashape's accuracy settings (tie-point projection
sigma 1 px, marker projection 0.5 px, marker location 0.01 m, camera
centre per config). With `compute_covariance` the output carries each
tie point's 3x3 covariance. The problem is re-centred on the scene centroid for
float32 conditioning, and the RMSE is taken in that frame. The JAX
package pads the point count to a bucket with zero-weight rows; here
the problem has its exact size.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from icepy4d_tpu_torch.core.camera import Camera
from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.ops import geometry_np as geom_np
from icepy4d_tpu_torch.ops.ba import BAProblem, lm_solve, point_covariances


@dataclass
class BAConfig:
    tie_point_sigma_px: float = 1.0
    marker_projection_sigma_px: float = 0.5
    marker_location_sigma_m: float = 0.01
    camera_center_sigma_m: float = 0.0       # 0 = no centre priors
    fix_cameras: list = field(default_factory=list)  # camera names
    free_intrinsics: tuple = ()  # indices into [fx, fy, cx, cy, dist8]
    fit_f: bool = False          # shortcut: free (fx, fy)
    robust_delta: float | None = None  # Huber band (sigma); None = LS
    compute_covariance: bool = False   # point covariances of the solution
    max_iters: int = 100
    min_points: int = 10         # tie points seen by >= 2 cameras


@dataclass
class BAOutput:
    cameras: dict
    points: np.ndarray
    cost: float
    initial_cost: float
    iterations: int
    reprojection_rmse_px: float
    point_covariances: np.ndarray | None = None
    ok: bool = True              # False: a guard fired, and cameras and
    failure: str | None = None   # points are the unchanged inputs


def _camera_to_theta(cam: Camera) -> np.ndarray:
    rvec = geom_np.matrix_to_rodrigues(np.asarray(cam.R))
    return np.concatenate([rvec, np.asarray(cam.t).reshape(3)]).astype(
        np.float32)


def _theta_to_extrinsics(theta: np.ndarray) -> np.ndarray:
    E = np.eye(4, dtype=np.float32)
    E[:3, :3] = geom_np.rodrigues_to_matrix(theta[:3])
    E[:3, 3] = theta[3:6]
    return E


def _camera_to_intr(cam: Camera) -> np.ndarray:
    K = np.asarray(cam.K)
    return np.concatenate([[K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
                           np.asarray(cam.dist).reshape(-1)]).astype(
                               np.float32)


class BundleAdjustment:
    """cameras: {name: Camera}; image_points: {name: (N, 2)} tie-point
    observations aligned by row (NaN = unseen); points3d: (N, 3);
    marker_image_points / marker_world: target observations and world
    coordinates (optional); camera_centers: {name: (3,)} (optional).
    device: None solves on the card (and raises without one)."""

    def __init__(self, cameras: dict, image_points: dict,
                 points3d: np.ndarray,
                 marker_image_points: dict | None = None,
                 marker_world: np.ndarray | None = None,
                 camera_centers: dict | None = None,
                 cfg: BAConfig | None = None, device=None):
        self.cfg = cfg or BAConfig()
        self.device = resolve_device(device)
        self.cam_names = list(cameras.keys())
        self.cameras = cameras
        self.image_points = image_points
        self.points3d = np.asarray(points3d, np.float32)
        self.marker_image_points = marker_image_points or {}
        self.marker_world = (None if marker_world is None
                             else np.asarray(marker_world, np.float32))
        self.camera_centers = camera_centers or {}

    def _assemble_numpy(self):
        """The problem's leaves as numpy, re-centred: (leaves, shift,
        n_tie)."""
        cfg = self.cfg
        names = self.cam_names
        c = len(names)
        n_tie = self.points3d.shape[0]
        n_mark = 0 if self.marker_world is None else len(self.marker_world)
        p = n_tie + n_mark

        obs_xy = np.zeros((p, c, 2), np.float32)
        obs_w = np.zeros((p, c), np.float32)
        for ci, name in enumerate(names):
            xy = np.asarray(self.image_points[name], np.float32)
            ok = np.isfinite(xy).all(axis=1)
            obs_xy[:n_tie, ci] = np.where(ok[:, None], xy, 0.0)
            obs_w[:n_tie, ci] = ok / cfg.tie_point_sigma_px
            mk = self.marker_image_points.get(name)
            if mk is not None and n_mark:
                mk = np.asarray(mk, np.float32)
                mok = np.isfinite(mk).all(axis=1)
                obs_xy[n_tie:, ci] = np.where(mok[:, None], mk, 0.0)
                obs_w[n_tie:, ci] = mok / cfg.marker_projection_sigma_px

        pt_prior = np.zeros((p, 3), np.float32)
        pt_prior_w = np.zeros((p,), np.float32)
        pts0 = self.points3d
        if n_mark:
            pt_prior[n_tie:] = self.marker_world
            pt_prior_w[n_tie:] = 1.0 / cfg.marker_location_sigma_m
            pts0 = np.concatenate([pts0, self.marker_world], axis=0)

        cam_prior = np.zeros((c, 3), np.float32)
        cam_prior_w = np.zeros((c,), np.float32)
        if cfg.camera_center_sigma_m > 0:
            for ci, name in enumerate(names):
                ctr = self.camera_centers.get(name)
                if ctr is not None:
                    cam_prior[ci] = np.asarray(ctr, np.float32).reshape(3)
                    cam_prior_w[ci] = 1.0 / cfg.camera_center_sigma_m

        cam_theta = np.stack([_camera_to_theta(self.cameras[n])
                              for n in names])
        intr = np.stack([_camera_to_intr(self.cameras[n]) for n in names])
        cam_fixed = np.array([n in cfg.fix_cameras for n in names], bool)

        # re-centre on the scene centroid; extrinsics t' = t + R @ shift
        shift = pts0.mean(axis=0)
        pts0 = pts0 - shift
        pt_prior = pt_prior - shift
        cam_prior = cam_prior - shift
        for ci in range(c):
            R = geom_np.rodrigues_to_matrix(cam_theta[ci, :3])
            cam_theta[ci, 3:] = cam_theta[ci, 3:] + R @ shift
        leaves = dict(cam_theta=cam_theta, intrinsics=intr, points=pts0,
                      obs_xy=obs_xy, obs_w=obs_w, pt_prior=pt_prior,
                      pt_prior_w=pt_prior_w, cam_prior=cam_prior,
                      cam_prior_w=cam_prior_w, cam_fixed=cam_fixed)
        return leaves, shift, n_tie

    def _failed(self, failure: str) -> BAOutput:
        return BAOutput(cameras=dict(self.cameras), points=self.points3d,
                        cost=float("nan"), initial_cost=float("nan"),
                        iterations=0, reprojection_rmse_px=float("nan"),
                        ok=False, failure=failure)

    def run(self) -> BAOutput:
        cfg = self.cfg
        free_intr = tuple(cfg.free_intrinsics)
        if cfg.fit_f and not free_intr:
            free_intr = (0, 1)

        # degeneracy guard before solving: only tie points with >= 2
        # finite observations constrain the cameras
        n_multi = 0
        if self.points3d.shape[0]:
            seen = np.zeros(self.points3d.shape[0], np.int32)
            for name in self.cam_names:
                xy = np.asarray(self.image_points[name], np.float32)
                seen += np.isfinite(xy).all(axis=1)[: len(seen)]
            n_multi = int((seen >= 2).sum())
        if n_multi < cfg.min_points:
            return self._failed(f"only {n_multi} multi-view tie points "
                                f"(min_points={cfg.min_points})")

        leaves, shift, n_tie = self._assemble_numpy()
        prob = BAProblem.from_numpy(self.device, **leaves)
        res = lm_solve(prob, free_intr=free_intr, max_iters=cfg.max_iters,
                       robust_delta=cfg.robust_delta)
        cam_theta = res.cam_theta.cpu().numpy()
        intr = res.intrinsics.cpu().numpy()
        pts_c = res.points.cpu().numpy()[:n_tie]

        cameras = {}
        for ci, name in enumerate(self.cam_names):
            th = cam_theta[ci].copy()
            th[3:] = th[3:] - geom_np.rodrigues_to_matrix(th[:3]) @ shift
            K = np.array([[intr[ci, 0], 0, intr[ci, 2]],
                          [0, intr[ci, 1], intr[ci, 3]], [0, 0, 1]],
                         np.float32)
            old = self.cameras[name]
            cameras[name] = Camera.create(
                width=old.width, height=old.height, K=K, dist=intr[ci, 4:],
                extrinsics=_theta_to_extrinsics(th))
        pts = pts_c + shift

        # pixel RMSE from the residuals, in the re-centred frame (the
        # cost is the Huber objective with a robust band)
        sq, n_obs = 0.0, 0
        obs_xy = leaves["obs_xy"][:n_tie]
        obs_w = leaves["obs_w"][:n_tie]
        for ci in range(len(self.cam_names)):
            ok = obs_w[:, ci] > 0
            if not ok.any():
                continue
            th = cam_theta[ci]
            Xc = pts_c[ok] @ geom_np.rodrigues_to_matrix(th[:3]).T + th[3:6]
            xd = geom_np.distort_normalized(Xc[:, :2] / Xc[:, 2:],
                                            intr[ci, 4:12])
            r = xd * intr[ci, :2] + intr[ci, 2:4] - obs_xy[:, ci][ok]
            sq += float((r ** 2).sum())
            n_obs += int(ok.sum())
        rmse = float(np.sqrt(sq / max(n_obs, 1)))

        # a diverged solve must never overwrite the input cameras
        if not (np.isfinite(rmse) and np.isfinite(cam_theta).all()
                and np.isfinite(intr).all() and np.isfinite(pts).all()):
            return self._failed(f"non-finite solution after "
                                f"{int(res.iterations)} iters (rmse={rmse})")
        covs = None
        if cfg.compute_covariance:
            # translation-invariant: the re-centred frame serves
            covs = point_covariances(
                prob, res.cam_theta, res.intrinsics, res.points,
                free_intr=free_intr, robust_delta=cfg.robust_delta)
            covs = covs[:n_tie].cpu().numpy()
        return BAOutput(cameras=cameras, points=pts, cost=float(res.cost),
                        initial_cost=float(res.initial_cost),
                        iterations=int(res.iterations),
                        reprojection_rmse_px=rmse, point_covariances=covs)
