"""Free-function geometry API.

Counterpart of `icepy4d_tpu/sfm/geometry.py`. `estimate_pose` runs the
hypothesis-parallel essential RANSAC of `ops/ransac.py` on the device;
`project_points` and `undistort_points` are host numpy, as in the JAX
package, for the per-epoch callers (filters, trim-ladder residuals,
CSV sinks); `fundamental_from_cameras` is float64 host math.
"""

from __future__ import annotations

import numpy as np
import torch

from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.ops import geometry_np as geom_np
from icepy4d_tpu_torch.ops import ransac as ransac_ops


def estimate_pose(kpts0: np.ndarray, kpts1: np.ndarray, K0: np.ndarray,
                  K1: np.ndarray, thresh: float = 1.0, conf: float = 0.9999,
                  n_hypotheses: int = 1024, seed: int = 0,
                  scores: np.ndarray | None = None,
                  F_hint: np.ndarray | None = None, idx=None, device=None):
    """Relative pose from matched keypoints: (R, t (3, 1), valid mask),
    or None below 5 correspondences.

    `conf` is kept for signature parity (all `n_hypotheses` are always
    scored). `scores` guide sampling and scoring, `F_hint` adds a
    hypothesis (see `ops/ransac.py::ransac_essential_pose`). The draws
    come from a `torch.Generator` seeded with `seed`, or are the given
    (H, 8) index sets `idx`. The RANSAC runs at the exact count of
    matches, where the JAX package pads to a bucket and masks the rows.
    """
    dev = resolve_device(device)
    kpts0 = np.asarray(kpts0, np.float32).reshape(-1, 2)
    kpts1 = np.asarray(kpts1, np.float32).reshape(-1, 2)
    n = len(kpts0)
    if n < 5:
        return None

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    guidance = None
    if scores is not None and len(scores) == n:
        guidance = t(scores).reshape(-1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    if idx is not None:
        idx = torch.as_tensor(np.array(idx), dtype=torch.int64, device=dev)
    with torch.no_grad():
        R, tvec, _E, inliers = ransac_ops.ransac_essential_pose(
            gen, t(kpts0), t(kpts1), t(K0), t(K1),
            torch.ones(n, dtype=torch.bool, device=dev),
            threshold_px=float(thresh), n_hypotheses=n_hypotheses,
            guidance=guidance, F_hint=None if F_hint is None else t(F_hint),
            idx=idx)
    return (R.cpu().numpy(), tvec.cpu().numpy().reshape(3, 1),
            inliers.cpu().numpy())


def project_points(points_3d, camera, image=None) -> np.ndarray:
    """World points -> pixels through a Camera (host numpy)."""
    pts = np.asarray(points_3d, np.float32).reshape(-1, 3)
    return geom_np.project_points(pts, camera.K, camera.extrinsics,
                                  camera.dist)


def undistort_points(points_2d, camera) -> np.ndarray:
    """Remove distortion, keeping K as the projection (host numpy)."""
    pts = np.asarray(points_2d, np.float32).reshape(-1, 2)
    return geom_np.undistort_points(pts, camera.K, camera.dist)


def fundamental_from_cameras(cam0, cam1) -> np.ndarray:
    """F of an oriented camera pair (x1^T F x0 = 0 for undistorted
    pixels), float64, scaled to a largest entry of 1."""
    E0 = np.asarray(cam0.extrinsics, np.float64)
    E1 = np.asarray(cam1.extrinsics, np.float64)
    R = E1[:3, :3] @ E0[:3, :3].T
    t = E1[:3, 3] - R @ E0[:3, 3]
    tx = np.array([[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]],
                   [-t[1], t[0], 0.0]])
    K0 = np.asarray(cam0.K, np.float64)
    K1 = np.asarray(cam1.K, np.float64)
    F = np.linalg.inv(K1).T @ (tx @ R) @ np.linalg.inv(K0)
    return F / max(abs(F).max(), 1e-12)
