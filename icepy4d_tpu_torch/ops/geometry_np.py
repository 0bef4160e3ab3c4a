"""Host-side numpy camera geometry: distortion, projection, rotations.

Counterpart of `icepy4d_tpu/ops/geometry_np.py` (the port keeps its own
copy). Cameras are built and read on the host, where numpy on a few
points costs microseconds. Distortion follows the OpenCV rational +
tangential model, dist = (k1, k2, p1, p2, k3, k4, k5, k6).
"""

from __future__ import annotations

import numpy as np


def pad_distortion(dist) -> np.ndarray:
    """Zero-pad any OpenCV distortion vector (0/4/5/8 terms) to 8."""
    dist = np.atleast_1d(np.asarray(dist, np.float32)).reshape(-1)
    if dist.shape[0] >= 8:
        return np.ascontiguousarray(dist[:8])
    out = np.zeros((8,), np.float32)
    out[: dist.shape[0]] = dist
    return out


def distort_normalized(xn: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Apply OpenCV rational+tangential distortion. xn (..., 2)."""
    k1, k2, p1, p2, k3, k4, k5, k6 = (float(dist[i]) for i in range(8))
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (
        1.0 + k4 * r2 + k5 * r4 + k6 * r6
    )
    xy = x * y
    x_t = 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
    y_t = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
    return np.stack([x * radial + x_t, y * radial + y_t], axis=-1)


def undistort_normalized(xd: np.ndarray, dist: np.ndarray,
                         iters: int = 20) -> np.ndarray:
    """Invert `distort_normalized` by fixed-point iteration (cv2-style)."""
    k1, k2, p1, p2, k3, k4, k5, k6 = (float(dist[i]) for i in range(8))
    xn = xd.copy()
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (
            1.0 + k4 * r2 + k5 * r4 + k6 * r6
        )
        xy = x * y
        dx = 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
        xn = np.stack([(xd[..., 0] - dx) / radial,
                       (xd[..., 1] - dy) / radial], axis=-1)
    return xn


def project_points(points: np.ndarray, K: np.ndarray,
                   extrinsics: np.ndarray, dist=None) -> np.ndarray:
    """World (N, 3) -> pixel (N, 2) through K [R|t] + distortion."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    K = np.asarray(K, np.float32)
    extrinsics = np.asarray(extrinsics, np.float32)
    R = extrinsics[:3, :3]
    t = extrinsics[:3, 3]
    Xc = points @ R.T + t
    z = np.where(np.abs(Xc[:, 2:3]) < 1e-12, 1e-12, Xc[:, 2:3])
    xn = Xc[:, :2] / z
    if dist is not None:
        xn = distort_normalized(xn, pad_distortion(dist))
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    s = K[0, 1]
    u = fx * xn[..., 0] + s * xn[..., 1] + cx
    v = fy * xn[..., 1] + cy
    return np.stack([u, v], axis=-1)


def undistort_points(points: np.ndarray, K: np.ndarray, dist,
                     iters: int = 20) -> np.ndarray:
    """Pixel (N, 2) -> undistorted pixels (same K as projection)."""
    pts = np.asarray(points, np.float32).reshape(-1, 2)
    K = np.asarray(K, np.float32)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    sk = K[0, 1]  # Agisoft b1 skew, same as ops/geometry.normalize_points
    yn = (pts[:, 1] - cy) / fy
    xn = np.stack([(pts[:, 0] - cx - sk * yn) / fx, yn], axis=-1)
    xu = undistort_normalized(xn, pad_distortion(dist), iters=iters)
    return np.stack([xu[:, 0] * fx + sk * xu[:, 1] + cx,
                     xu[:, 1] * fy + cy], axis=-1)


def rodrigues_to_matrix(rvec) -> np.ndarray:
    """Axis-angle (3,) -> rotation matrix (3, 3)."""
    rvec = np.asarray(rvec, np.float64).reshape(3)
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3, dtype=np.float32)
    k = rvec / theta
    Kx = np.array([[0, -k[2], k[1]],
                   [k[2], 0, -k[0]],
                   [-k[1], k[0], 0]], np.float64)
    R = np.eye(3) + np.sin(theta) * Kx + (1.0 - np.cos(theta)) * (Kx @ Kx)
    return R.astype(np.float32)


def matrix_to_rodrigues(R) -> np.ndarray:
    """Rotation matrix (3, 3) -> axis-angle (3,) (inverse of
    `rodrigues_to_matrix`)."""
    R = np.asarray(R, np.float64).reshape(3, 3)
    cos_t = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = float(np.arccos(cos_t))
    if theta < 1e-12:
        return np.zeros(3, np.float32)
    if abs(np.pi - theta) < 1e-6:
        # sin(theta) ~ 0: axis from the dominant column of R + I
        A = R + np.eye(3)
        col = A[:, int(np.argmax(np.sum(A * A, axis=0)))]
        axis = col / np.linalg.norm(col)
        # fix sign convention to match the generic branch's limit
        v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                      R[1, 0] - R[0, 1]])
        if np.dot(axis, v) < 0:
            axis = -axis
        return (theta * axis).astype(np.float32)
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]]) / (2.0 * np.sin(theta))
    return (theta * axis).astype(np.float32)


def euler_from_matrix(R, eps: float = 1e-8):
    """Static-xyz Euler angles (ax, ay, az) of R."""
    R = np.asarray(R, np.float64)
    cy = np.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    safe = cy > eps
    ax = np.where(safe,
                  np.arctan2(R[..., 2, 1], R[..., 2, 2]),
                  np.arctan2(-R[..., 1, 2], R[..., 1, 1]))
    ay = np.arctan2(-R[..., 2, 0], cy)
    az = np.where(safe, np.arctan2(R[..., 1, 0], R[..., 0, 0]), 0.0)
    return ax, ay, az


def similarity_from_points(v0, v1, with_scale: bool = True,
                           weights=None) -> np.ndarray:
    """Least-squares similarity T (4x4, float32) with v1 ~= T @ v0, by
    Umeyama's SVD method in float64 (absolute orientation solves this
    every epoch on a handful of points)."""
    v0 = np.asarray(v0, np.float64).reshape(-1, 3)
    v1 = np.asarray(v1, np.float64).reshape(-1, 3)
    w = (np.ones(len(v0)) if weights is None
         else np.asarray(weights, np.float64).reshape(-1))
    wsum = max(float(w.sum()), 1e-12)
    mu0 = (v0 * w[:, None]).sum(0) / wsum
    mu1 = (v1 * w[:, None]).sum(0) / wsum
    x0 = v0 - mu0
    x1 = v1 - mu1
    cov = (x1 * w[:, None]).T @ x0 / wsum
    U, S, Vt = np.linalg.svd(cov)
    d = float(np.sign(np.linalg.det(U @ Vt)))
    R = U @ np.diag([1.0, 1.0, d]) @ Vt
    var0 = float((w[:, None] * x0 * x0).sum()) / wsum
    s = ((S[0] + S[1] + S[2] * d) / max(var0, 1e-12)) if with_scale else 1.0
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = s * R
    T[:3, 3] = mu1 - s * (R @ mu0)
    return T.astype(np.float32)
