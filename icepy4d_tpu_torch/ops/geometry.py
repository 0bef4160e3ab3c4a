"""Projective geometry on tensors.

Counterpart of `icepy4d_tpu/ops/geometry.py`. Points are float32
row-major (N, 2) / (N, 3) tensors on any device; extrinsics is a 4x4
world -> camera transform; K the 3x3 upper-triangular intrinsics.
Distortion follows the OpenCV rational + tangential model, dist = (k1,
k2, p1, p2, k3, k4, k5, k6), shorter vectors zero-padded. A distortion
given as numpy or a list enters as float32 scalars; a tensor of 8 terms
stays a tensor, so that derivatives can flow through it (the bundle
adjustment refines it).
"""

from __future__ import annotations

import numpy as np
import torch


def to_homogeneous(x: torch.Tensor) -> torch.Tensor:
    """(N, d) -> (N, d+1) with a trailing column of ones."""
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def from_homogeneous(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """(N, d+1) -> (N, d), dividing by the last coordinate."""
    w = x[..., -1:]
    return x[..., :-1] / torch.where(w.abs() < eps, eps, w)


def skew_symmetric(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> 3x3 cross-product matrix (batched over leading dims)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def pad_distortion(dist) -> torch.Tensor:
    """Zero-pad any OpenCV distortion vector (0/4/5/8 terms) to 8 terms
    (float32, on the CPU)."""
    d = torch.as_tensor(np.asarray(dist, np.float32)).reshape(-1)
    if d.shape[0] >= 8:
        return d[:8]
    return torch.cat([d, torch.zeros(8 - d.shape[0], dtype=torch.float32)])


def _coefficients(dist):
    """The eight distortion terms: the entries of an 8-term tensor, or
    float32 values as Python floats for anything else."""
    if torch.is_tensor(dist) and dist.shape[-1] == 8:
        return dist.unbind(-1)
    return tuple(float(v) for v in pad_distortion(dist))


def distort_normalized(xn: torch.Tensor, dist) -> torch.Tensor:
    """Apply the OpenCV rational + tangential distortion model.

    xn: (..., 2) normalised image coords (x/z, y/z) on any device."""
    k1, k2, p1, p2, k3, k4, k5, k6 = _coefficients(dist)
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (
        1.0 + k4 * r2 + k5 * r4 + k6 * r6)
    xy = x * y
    x_t = 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
    y_t = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
    return torch.stack([x * radial + x_t, y * radial + y_t], -1)


def undistort_normalized(xd: torch.Tensor, dist,
                         iters: int = 20) -> torch.Tensor:
    """Invert `distort_normalized` by a fixed number of fixed-point
    iterations (OpenCV's undistortPoints loop)."""
    k1, k2, p1, p2, k3, k4, k5, k6 = _coefficients(dist)
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (
            1.0 + k4 * r2 + k5 * r4 + k6 * r6)
        xy = x * y
        dx = 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
        xn = torch.stack([(xd[..., 0] - dx) / radial,
                          (xd[..., 1] - dy) / radial], -1)
    return xn


def world_to_camera(points: torch.Tensor,
                    extrinsics: torch.Tensor) -> torch.Tensor:
    """(N, 3) world points -> (N, 3) camera-frame points."""
    return points @ extrinsics[:3, :3].mT + extrinsics[:3, 3]


def project_points(points: torch.Tensor, K: torch.Tensor,
                   extrinsics: torch.Tensor, dist=None) -> torch.Tensor:
    """Pinhole projection with distortion: (N, 3) world -> (N, 2) px."""
    pc = world_to_camera(points, extrinsics)
    z = pc[..., 2:3]
    xn = pc[..., :2] / torch.where(z.abs() < 1e-12, 1e-12, z)
    if dist is not None:
        xn = distort_normalized(xn, dist)
    u = K[0, 0] * xn[..., 0] + K[0, 1] * xn[..., 1] + K[0, 2]
    v = K[1, 1] * xn[..., 1] + K[1, 2]
    return torch.stack([u, v], -1)


def normalize_points(points: torch.Tensor, K) -> torch.Tensor:
    """Pixel coords -> normalised camera coords (honours the skew
    K[0, 1], which `project_points` applies)."""
    fx, fy, cx, cy, sk = K[0][0], K[1][1], K[0][2], K[1][2], K[0][1]
    yn = (points[..., 1] - cy) / fy
    xn = (points[..., 0] - cx - sk * yn) / fx
    return torch.stack([xn, yn], -1)


def undistort_points(points: torch.Tensor, K, dist,
                     iters: int = 20) -> torch.Tensor:
    """Remove lens distortion from pixel coords, keeping K (OpenCV's
    P = K mode): (N, 2) distorted -> (N, 2) undistorted pixels. K may be
    a tensor or numpy; numpy values enter as float32 scalars."""
    if not torch.is_tensor(K):
        K = [[float(v) for v in row] for row in np.asarray(K, np.float32)]
    xu = undistort_normalized(normalize_points(points, K), dist, iters)
    return torch.stack([xu[..., 0] * K[0][0] + K[0][1] * xu[..., 1]
                        + K[0][2], xu[..., 1] * K[1][1] + K[1][2]], -1)


def compute_reprojection_error(observed: torch.Tensor,
                               projected: torch.Tensor, mask=None):
    """Per-point residuals and (masked) RMSE."""
    res = projected - observed
    norm2 = (res * res).sum(-1)
    if mask is None:
        return res, norm2.mean().sqrt()
    m = mask.to(res.dtype)
    return res, ((norm2 * m).sum() / m.sum().clamp_min(1.0)).sqrt()


def scale_intrinsics(K: torch.Tensor, scale: float) -> torch.Tensor:
    """Scale fx, skew, fy, cx, cy by `scale` (skew is a pixel quantity
    and scales with the rest)."""
    S = torch.tensor([[scale, scale, scale], [1.0, scale, scale],
                      [1.0, 1.0, 1.0]], dtype=torch.float32, device=K.device)
    return K.to(torch.float32) * S


def fundamental_from_cameras(K0: torch.Tensor, E0: torch.Tensor,
                             K1: torch.Tensor,
                             E1: torch.Tensor) -> torch.Tensor:
    """F of two calibrated cameras (world -> camera extrinsics E)."""
    R = E1[:3, :3] @ E0[:3, :3].mT
    t = E1[:3, 3] - R @ E0[:3, 3]
    E = skew_symmetric(t) @ R
    return torch.linalg.inv(K1).mT @ E @ torch.linalg.inv(K0)
