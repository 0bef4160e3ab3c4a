"""Homography warping for camera stabilisation before DIC (counterpart
of `icepy4d_tpu/utils/homography.py`).

A camera's frames are re-based onto a reference orientation under a
rotation-only model (H = K_ref R_ref R^T K^-1), with each epoch's Euler
angles median-smoothed over a window of epochs so the warped sequence
is stable in time. The pose algebra runs in float32, as in the JAX
package; the warp is `ops.image.warp_homography` on the device.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.ops.image import warp_homography
from icepy4d_tpu_torch.ops.transforms import euler_from_matrix, euler_matrix

logger = logging.getLogger("icepy4d_tpu_torch")


def homography_from_cameras(cam_ref, cam) -> np.ndarray:
    """H mapping cam's pixels onto cam_ref's orientation:
    K_ref R_ref R^T K^-1, scaled to H[2, 2] = 1."""
    R_rel = np.asarray(cam_ref.R) @ np.asarray(cam.R).T
    H = np.asarray(cam_ref.K) @ R_rel @ np.linalg.inv(np.asarray(cam.K))
    return H / H[2, 2]


def warp_image_to_reference(image, cam, cam_ref, device=None) -> np.ndarray:
    """`image` (taken by cam; uint8 scaled to [0, 1]) warped to cam_ref's
    orientation, as a host float32 array of the image's shape.
    device: None runs on the card (and raises without one)."""
    dev = resolve_device(device)
    img = torch.as_tensor(np.asarray(image), device=dev)
    img = img.float() / 255.0 if img.dtype == torch.uint8 else img.float()
    h, w = image.shape[:2]
    H = homography_from_cameras(cam_ref, cam).astype(np.float32)
    with torch.no_grad():
        return warp_homography(img, H, h, w).cpu().numpy()


def smooth_euler_angles(angles: np.ndarray, window: int = 2) -> np.ndarray:
    """Median of each epoch's Euler angle triplet over +-window epochs."""
    angles = np.asarray(angles, np.float64)
    out = np.empty_like(angles)
    n = len(angles)
    for i in range(n):
        lo, hi = max(0, i - window), min(n, i + window + 1)
        out[i] = np.median(angles[lo:hi], axis=0)
    return out


def homography_warping(epoches, camera_to_warp: str, reference_epoch: int = 0,
                       smooth_window: int = 2, out_dir=None,
                       device=None) -> dict[int, np.ndarray]:
    """Warp every epoch's `camera_to_warp` frame onto the reference
    epoch's orientation, with the rotations median-smoothed over
    +-`smooth_window` epochs; with `out_dir`, each lands there as
    warped_<epoch>.jpg. Returns {epoch id: warped image in [0, 1]}."""
    eids = sorted(epoches._epochs.keys())
    cams = [epoches[e].cameras[camera_to_warp] for e in eids]
    # the angles of the world-to-camera R itself (not Camera.euler_angles,
    # which describes R^T)
    angles = np.stack([np.array([float(a) for a in euler_from_matrix(
        torch.as_tensor(np.asarray(c.R, np.float32)))]) for c in cams])
    sm = smooth_euler_angles(angles, window=smooth_window)
    ref_cam = epoches[reference_epoch].cameras[camera_to_warp]
    out = {}
    for i, eid in enumerate(eids):
        R_s = euler_matrix(*torch.as_tensor(sm[i], dtype=torch.float32))
        E = np.asarray(cams[i].extrinsics).copy()
        E[:3, :3] = R_s.numpy()
        warped = warp_image_to_reference(
            epoches[eid].images[camera_to_warp].value,
            cams[i].update_extrinsics(E), ref_cam, device=device)
        out[eid] = warped
        if out_dir is not None:
            import cv2

            p = Path(out_dir)
            p.mkdir(parents=True, exist_ok=True)
            img = warped[..., ::-1] if warped.ndim == 3 else warped
            cv2.imwrite(str(p / f"warped_{eid:03d}.jpg"),
                        np.clip(img * 255, 0, 255).astype(np.uint8))
    logger.info("homography-warped %d epochs of %s", len(out),
                camera_to_warp)
    return out
