"""Dense two-view reconstruction: `PlaneSweepStereo`.

Counterpart of `icepy4d_tpu/sfm/dense.py`. Takes two calibrated cameras
and their images, undistorts (and optionally downscales) them, sweeps
depth hypotheses and unprojects the valid depths to a coloured world
point cloud. Two sweep engines:

- method="rectified" (default): rectify both views once, then sweep
  disparities as x-shifts (the CUDA sweep kernel on the card), forward
  and, with the left-right check, in reverse over the negated range;
- method="homography": a fronto-parallel plane sweep in the reference
  frame (one gather per plane; any motion).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from icepy4d_tpu_torch.core.camera import Camera
from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.ops.dense import (depth_to_points, disparity_sweep,
                                         lr_consistency_mask, plane_sweep)
from icepy4d_tpu_torch.ops.geometry import scale_intrinsics
from icepy4d_tpu_torch.ops.image import (resize, rgb_to_gray,
                                         undistort_image, warp_homography)
from icepy4d_tpu_torch.ops.rectify import (depth_to_disparity,
                                           disparity_to_depth,
                                           rect_pixels_to_world,
                                           rectify_pair)
from icepy4d_tpu_torch.utils.timer import AverageTimer

logger = logging.getLogger("icepy4d_tpu_torch")


class PlaneSweepStereo:
    """Dense two-view reconstruction.

    cameras: [reference Camera, secondary Camera] with world extrinsics.
    images: matching [img0, img1] (H, W[, 3]) uint8 or float.
    depth range: in the REFERENCE camera frame (metres).
    device: None runs on the card (and raises without one); "cpu" runs
    the plain PyTorch path.
    """

    def __init__(self, cameras: list[Camera], images: list[np.ndarray],
                 depth_min: float, depth_max: float, n_planes: int = 96,
                 window: int = 7, downscale: int = 1,
                 cost_threshold: float = 0.5,
                 uniqueness_threshold: float = 0.98,
                 method: str = "rectified", lr_check: bool = True,
                 lr_tau: float = 2.0, device=None) -> None:
        if method not in ("rectified", "homography"):
            raise ValueError(f"unknown method {method!r}")
        self.cameras = list(cameras)
        self.images = list(images)
        self.depth_min = float(depth_min)
        self.depth_max = float(depth_max)
        self.n_planes = int(n_planes)
        self.window = int(window)
        self.downscale = int(downscale)
        self.cost_threshold = float(cost_threshold)
        self.uniqueness_threshold = float(uniqueness_threshold)
        self.method = method
        self.lr_check = bool(lr_check)
        self.lr_tau = float(lr_tau)
        self.device = resolve_device(device)
        self.depth: np.ndarray | None = None
        self.valid: np.ndarray | None = None

    def _prep(self, cam: Camera, img: np.ndarray):
        g = torch.as_tensor(np.asarray(img)).to(self.device)
        g = g.to(torch.float32) / 255.0 if g.dtype == torch.uint8 \
            else g.to(torch.float32)
        rgb = None
        if g.ndim == 3:
            rgb, g = g, rgb_to_gray(g)
        g = undistort_image(g, cam.K, cam.dist)
        if rgb is not None:
            # the colours follow the geometry (the JAX package samples
            # them from the still distorted image)
            rgb = undistort_image(rgb, cam.K, cam.dist)
        K = np.asarray(cam.K, np.float32)
        if self.downscale > 1:
            s = 1.0 / self.downscale
            h, w = g.shape
            size = (int(h * s), int(w * s))
            g = resize(g, size)
            if rgb is not None:
                rgb = resize(rgb, size)
            K = scale_intrinsics(torch.from_numpy(K), s).numpy()
        return g, rgb, K

    def run(self) -> dict:
        """Sweep; returns numpy depth, cost and valid maps (H, W)."""
        self.timer = AverageTimer(device=self.device)
        cam0, cam1 = self.cameras
        g0, rgb0, K0 = self._prep(cam0, self.images[0])
        g1, _, K1 = self._prep(cam1, self.images[1])
        self.timer.update("undistort")
        E0, E1 = cam0.extrinsics, cam1.extrinsics

        if self.method == "rectified":
            h, w = g0.shape
            rect = rectify_pair(K0, E0, K1, E1, image_size=(w, h))
            g0r = warp_homography(g0, rect["H0"], h, w)
            g1r = warp_homography(g1, rect["H1"], h, w)
            if rgb0 is not None:
                rgb0 = warp_homography(rgb0, rect["H0"], h, w)
            off = rect["disp_offset"]
            d_lo, d_hi = (float(depth_to_disparity(
                torch.tensor(z), rect["K_new"], rect["baseline"], off))
                for z in (self.depth_max, self.depth_min))
            self.timer.update("rectify_warp")
            out = disparity_sweep(g0r, g1r, d_lo, d_hi,
                                  n_disp=self.n_planes, window=self.window)
            self.timer.update("forward_sweep")
            depth = disparity_to_depth(out["disparity"], rect["K_new"],
                                       rect["baseline"], off)
            inbounds = out["inbounds"]
            if self.lr_check:
                # view 1 -> view 0 disparities: the negated range
                rev = disparity_sweep(g1r, g0r, -d_hi, -d_lo,
                                      n_disp=self.n_planes,
                                      window=self.window)
                self.timer.update("reverse_sweep")
                inbounds = inbounds & lr_consistency_mask(
                    out["disparity"], rev["disparity"], tau=self.lr_tau)
                self.timer.update("lr_mask")
            self._rect = rect
        else:
            out = plane_sweep(g0, g1, K0, K1, E0, E1, self.depth_min,
                              self.depth_max, n_planes=self.n_planes,
                              window=self.window)
            self.timer.update("plane_sweep")
            depth = out["depth"]
            inbounds = out["inbounds"]
            self._rect = None

        valid = inbounds & (out["cost"] < self.cost_threshold) \
            & (out["uniqueness"] < self.uniqueness_threshold)
        self.depth = depth.cpu().numpy()
        self.cost = out["cost"].cpu().numpy()
        self.valid = valid.cpu().numpy()
        self._K0 = K0
        self._rgb0 = rgb0
        self.timer.update("download")
        logger.info("dense sweep (%s): %.1f%% valid pixels", self.method,
                    100.0 * self.valid.mean())
        return {"depth": self.depth, "cost": self.cost, "valid": self.valid}

    def to_point_cloud(self) -> tuple[np.ndarray, np.ndarray | None]:
        """World points (N, 3) of the valid depths, and their colours
        (N, 3) in [0, 1] when the reference image is RGB."""
        if self.depth is None:
            raise RuntimeError("run() first")
        dev = self.device
        valid = torch.from_numpy(self.valid).to(dev)
        depth = torch.from_numpy(self.depth).to(dev)
        if self._rect is not None:
            ys, xs = torch.nonzero(valid, as_tuple=True)
            pix = torch.stack([xs, ys], -1).to(torch.float32)
            pts = rect_pixels_to_world(pix, depth[valid],
                                       self._rect["K_new"],
                                       self._rect["R_new"], self._rect["C0"])
        else:
            allpts, _ = depth_to_points(depth, self._K0,
                                        self.cameras[0].extrinsics)
            pts = allpts[valid.reshape(-1)]
        colors = None
        if self._rgb0 is not None:
            colors = self._rgb0.reshape(-1, 3)[valid.reshape(-1)].cpu().numpy()
        return pts.cpu().numpy(), colors
