"""Projective geometry on tensors: the subset dense stereo needs.

Counterpart of `icepy4d_tpu/ops/geometry.py` (`pad_distortion`,
`distort_normalized`, `scale_intrinsics`). Distortion follows the OpenCV
rational + tangential model, dist = (k1, k2, p1, p2, k3, k4, k5, k6),
shorter vectors zero-padded.
"""

from __future__ import annotations

import numpy as np
import torch


def pad_distortion(dist) -> torch.Tensor:
    """Zero-pad any OpenCV distortion vector (0/4/5/8 terms) to 8 terms
    (float32, on the CPU)."""
    d = torch.as_tensor(np.asarray(dist, np.float32)).reshape(-1)
    if d.shape[0] >= 8:
        return d[:8]
    return torch.cat([d, torch.zeros(8 - d.shape[0], dtype=torch.float32)])


def distort_normalized(xn: torch.Tensor, dist) -> torch.Tensor:
    """Apply the OpenCV rational + tangential distortion model.

    xn: (..., 2) normalised image coords (x/z, y/z) on any device; dist:
    the coefficients, whose float32 values enter as scalars.
    """
    k1, k2, p1, p2, k3, k4, k5, k6 = (float(v) for v in pad_distortion(dist))
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


def scale_intrinsics(K: torch.Tensor, scale: float) -> torch.Tensor:
    """Scale fx, skew, fy, cx, cy by `scale` (skew is a pixel quantity
    and scales with the rest)."""
    S = torch.tensor([[scale, scale, scale], [1.0, scale, scale],
                      [1.0, 1.0, 1.0]], dtype=torch.float32, device=K.device)
    return K.to(torch.float32) * S
