"""7-parameter Helmert similarity: residuals and least-squares estimation
(counterpart of `icepy4d_tpu/least_squares/absolute_orientation.py`).

params = (rx, ry, rz, tx, ty, tz, m) -> T = [m R | t]; weighted
residuals x1 - T(x0); the estimate is Umeyama's closed form refined by
Gauss-Newton on the seven parameters (`ops/transforms.py`), in float32
on centroid-relative coordinates.
"""

from __future__ import annotations

import numpy as np
import torch

from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.ops import transforms as tf
from icepy4d_tpu_torch.ops.geometry_np import similarity_from_points


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def get_T_from_params(params, device=None) -> np.ndarray:
    """(rx, ry, rz, tx, ty, tz, m) -> 4x4 similarity transform."""
    dev = resolve_device(device)
    return tf.helmert_params_to_matrix(_f32(params, dev)).cpu().numpy()


def compute_residuals(params, x0, x1, weights=None,
                      device=None) -> np.ndarray:
    """Flattened weighted residuals x1 - T(x0)."""
    dev = resolve_device(device)
    r = tf.helmert_residuals(
        _f32(params, dev), _f32(x0, dev), _f32(x1, dev),
        None if weights is None else _f32(weights, dev))
    return r.cpu().numpy().reshape(-1)


def estimate_similarity_least_squares(x0, x1, weights=None, T0=None,
                                      device=None) -> tuple[np.ndarray, dict]:
    """T with x1 ~= T(x0): Umeyama (or T0) refined by Gauss-Newton.

    Returns (T (4, 4) float64, {"rmse", "residuals"}). The float32
    solve only sees centroid-relative values: world coordinates are
    UTM-scale (~5e6 m), where a float32 step is ~0.5 m."""
    dev = resolve_device(device)
    x0 = np.asarray(x0, np.float64)
    x1 = np.asarray(x1, np.float64)
    c0 = x0.mean(axis=0)
    c1 = x1.mean(axis=0)
    x0c = x0 - c0
    x1c = x1 - c1
    if T0 is None:
        Tc0 = np.asarray(similarity_from_points(x0c, x1c, with_scale=True),
                         np.float64)
    else:
        T0 = np.asarray(T0, np.float64)
        Tc0 = np.eye(4)
        Tc0[:3, :3] = T0[:3, :3]
        Tc0[:3, 3] = T0[:3, 3] - c1 + T0[:3, :3] @ c0
    Tc = tf.refine_similarity_gauss_newton(
        _f32(Tc0, dev), _f32(x0c, dev), _f32(x1c, dev),
        weights=None if weights is None else _f32(weights, dev))
    Tc = Tc.cpu().numpy().astype(np.float64)
    T = np.eye(4)
    T[:3, :3] = Tc[:3, :3]
    T[:3, 3] = c1 + Tc[:3, 3] - Tc[:3, :3] @ c0
    res = x1 - (x0 @ T[:3, :3].T + T[:3, 3])
    rmse = float(np.sqrt(np.mean(np.sum(res ** 2, axis=1))))
    return T, {"rmse": rmse, "residuals": res}
