"""Stereo rectification (Fusiello, Trucco and Verri's compact algorithm).

Counterpart of `icepy4d_tpu/ops/rectify.py`. Rectifying both views once
turns the plane sweep into a disparity sweep: every depth hypothesis is
an x-shift of the rectified secondary image.

`rectify_pair` is 3x3 algebra in float32 numpy on the host, as the JAX
package computes it in float32; the per-pixel helpers take tensors and
run on their device.
"""

from __future__ import annotations

import numpy as np
import torch

from icepy4d_tpu_torch.ops.image import map_homography


def rectify_pair(K0, E0, K1, E1, image_size: tuple | None = None) -> dict:
    """Rectifying transforms for two calibrated views (float32 numpy).

    Returns dict with H0, H1 (3, 3) homographies mapping ORIGINAL image
    pixels to the rectified frame, K_new (3, 3) rectified camera-0
    intrinsics, R_new (3, 3) world->rect rotation, baseline, the camera-0
    centre C0, and disp_offset.

    image_size (w, h): when given, each rectified frame is re-centred on
    its own image content (convergent rigs otherwise map entirely
    outside the window). The horizontal shifts of the two cameras differ,
    so the stereo relation becomes d = f * B / Z + disp_offset.
    """
    K0, E0, K1, E1 = (np.asarray(a, np.float32) for a in (K0, E0, K1, E1))
    R0, t0 = E0[:3, :3], E0[:3, 3]
    R1, t1 = E1[:3, :3], E1[:3, 3]
    C0 = -R0.T @ t0
    C1 = -R1.T @ t1

    b = C1 - C0
    baseline = np.linalg.norm(b)
    e1 = b / np.maximum(baseline, np.float32(1e-12))
    # new z roughly along the mean optical axis, orthogonalised
    z_mean = np.float32(0.5) * (R0[2] + R1[2])
    e2 = np.cross(z_mean, e1)
    e2 = e2 / np.maximum(np.linalg.norm(e2), np.float32(1e-12))
    e3 = np.cross(e1, e2)
    R_new = np.stack([e1, e2, e3])         # world -> rectified cam

    K_new = np.float32(0.5) * (K0 + K1)
    K_new[0, 1] = 0.0                      # no skew

    H0 = K_new @ R_new @ R0.T @ np.linalg.inv(K0)
    H1 = K_new @ R_new @ R1.T @ np.linalg.inv(K1)
    H0 = H0 / H0[2, 2]
    H1 = H1 / H1[2, 2]
    disp_offset = np.float32(0.0)
    if image_size is not None:
        w, h = image_size
        ctr = np.array([w / 2.0, h / 2.0, 1.0], np.float32)

        def mapped(Hm):
            c = Hm @ ctr
            return c[:2] / c[2]

        c0, c1 = mapped(H0), mapped(H1)
        tx0 = np.float32(w / 2.0) - c0[0]
        tx1 = np.float32(w / 2.0) - c1[0]
        # the vertical shift is common: rows stay epipolar-aligned
        ty = np.float32(h / 2.0) - np.float32(0.5) * (c0[1] + c1[1])
        T0 = np.eye(3, dtype=np.float32)
        T1 = np.eye(3, dtype=np.float32)
        T0[0, 2], T0[1, 2] = tx0, ty
        T1[0, 2], T1[1, 2] = tx1, ty
        H0 = T0 @ H0
        H1 = T1 @ H1
        K_new[0, 2] += tx0
        K_new[1, 2] += ty
        disp_offset = tx0 - tx1
    return {"H0": H0, "H1": H1, "K_new": K_new, "R_new": R_new,
            "baseline": baseline, "C0": C0, "disp_offset": disp_offset}


def _focal_baseline(K_new, baseline) -> float:
    return float(np.float32(np.asarray(K_new, np.float32)[0, 0])
                 * np.float32(baseline))


def disparity_to_depth(disp: torch.Tensor, K_new, baseline,
                       disp_offset=0.0) -> torch.Tensor:
    """Z (rectified frame) = f * B / (d - disp_offset)."""
    d = torch.as_tensor(disp, dtype=torch.float32) \
        - float(np.float32(disp_offset))
    return _focal_baseline(K_new, baseline) / torch.where(
        d.abs() < 1e-9, 1e-9, d)


def depth_to_disparity(depth: torch.Tensor, K_new, baseline,
                       disp_offset=0.0) -> torch.Tensor:
    """d = f * B / Z + disp_offset."""
    z = torch.as_tensor(depth, dtype=torch.float32)
    return _focal_baseline(K_new, baseline) / torch.clamp_min(z, 1e-9) \
        + float(np.float32(disp_offset))


def rect_pixels_to_world(xy: torch.Tensor, depth: torch.Tensor, K_new,
                         R_new, C0) -> torch.Tensor:
    """Unproject rectified pixels (N, 2) with depths (N,) to world
    points (N, 3)."""
    rays = map_homography(np.linalg.inv(np.asarray(K_new, np.float32)),
                          xy[:, 0], xy[:, 1])
    Xr = [r * depth for r in rays]
    R_new = np.asarray(R_new, np.float32)
    C0 = np.asarray(C0, np.float32)
    # R_new.T @ Xr + C0
    return torch.stack([Xr[0] * float(R_new[0, i]) + Xr[1] * float(R_new[1, i])
                        + Xr[2] * float(R_new[2, i]) + float(C0[i])
                        for i in range(3)], -1)
