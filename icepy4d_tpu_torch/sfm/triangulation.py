"""Two-view and n-view triangulation.

Counterpart of `icepy4d_tpu/sfm/triangulation.py::Triangulate`: both
observation sets are undistorted (keeping K) and triangulated by the
iterative linear LS solver in one device step, all points at once;
colours are a batched bilinear gather. `triangulate_nviews` is the
n-view DLT of every camera's observations. Products run in full float32
(TF32 off) whatever the caller set. The JAX package pads the points
to a bucket; here they run at their exact count.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from icepy4d_tpu_torch.core.camera import Camera
from icepy4d_tpu_torch.device import full_f32_matmul, resolve_device
from icepy4d_tpu_torch.ops import geometry as geom
from icepy4d_tpu_torch.ops import triangulation as tri

logger = logging.getLogger("icepy4d_tpu_torch")


def undistort_and_triangulate(p0, p1, K0, d0, K1, d1, P0, P1):
    """Undistort both (N, 2) pixel sets and triangulate them: returns
    (points (N, 3), status (N,) int32) as tensors."""
    p0u = geom.undistort_points(p0, K0, d0)
    p1u = geom.undistort_points(p1, K1, d1)
    return tri.iterative_ls_triangulation(p0u, p1u, P0, P1)


class Triangulate:
    """cameras: Camera list; image_points: matching (N, 2) arrays.
    device: None runs on the card (and raises without one)."""

    def __init__(self, cameras: list[Camera] | None = None,
                 image_points: list[np.ndarray] | None = None,
                 device=None) -> None:
        self.cameras = cameras
        self.image_points = image_points
        self.device = resolve_device(device)
        self.points3d: np.ndarray | None = None
        self.colors: np.ndarray | None = None

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def triangulate_two_views(self, views_ids: list[int] = [0, 1],
                              approach: str = "iterative_LS_triangulation",
                              compute_colors: bool = False,
                              image: np.ndarray | None = None,
                              cam_id: int = 0) -> np.ndarray:
        """Undistort both observation sets and triangulate them on P =
        K [R | t]; optionally sample colours. Returns (N, 3)."""
        cam0 = self.cameras[views_ids[0]]
        cam1 = self.cameras[views_ids[1]]
        p0 = self._t(self.image_points[views_ids[0]]).reshape(-1, 2)
        p1 = self._t(self.image_points[views_ids[1]]).reshape(-1, 2)
        n = p0.shape[0]
        with torch.no_grad(), full_f32_matmul():
            if approach == "iterative_LS_triangulation":
                pts3d, status = undistort_and_triangulate(
                    p0, p1, cam0.K, cam0.dist, cam1.K, cam1.dist,
                    self._t(cam0.P), self._t(cam1.P))
                frac = float(status.float().sum()) / max(n, 1)
                logger.info("Point triangulation succeeded: %.3f", frac)
            elif approach == "linear_triangulation":
                pts3d = tri.linear_eigen_triangulation(
                    geom.undistort_points(p0, cam0.K, cam0.dist),
                    geom.undistort_points(p1, cam1.K, cam1.dist),
                    self._t(cam0.P), self._t(cam1.P))
            else:
                raise ValueError(
                    f"Unknown triangulation approach {approach!r}")
        self.points3d = pts3d.cpu().numpy()
        if compute_colors:
            if image is None:
                raise ValueError("image required for colour interpolation")
            self.interpolate_colors_from_image(image, self.cameras[cam_id])
        return self.points3d

    def triangulate_nviews(self) -> np.ndarray:
        """N-view DLT over every camera's observations, as they are (no
        undistortion, as in the JAX package). Returns (N, 3)."""
        us = torch.stack([self._t(p)[..., :2].reshape(-1, 2)
                          for p in self.image_points])
        Ps = torch.stack([self._t(cam.P) for cam in self.cameras])
        with torch.no_grad(), full_f32_matmul():
            pts = tri.triangulate_nview(us, Ps)
        self.points3d = pts.cpu().numpy()
        return self.points3d

    def interpolate_colors_from_image(self, image: np.ndarray,
                                      camera: Camera,
                                      convert_BRG2RGB: bool = False
                                      ) -> np.ndarray:
        """Project the points into `image` and sample colours in [0, 1]
        bilinearly (the image is taken as RGB unless convert_BRG2RGB)."""
        if self.points3d is None:
            raise ValueError("triangulate first")
        img = np.asarray(image)
        if convert_BRG2RGB and img.ndim == 3 and img.shape[2] == 3:
            img = img[..., ::-1]
        with torch.no_grad():
            uv = geom.project_points(self._t(self.points3d), self._t(camera.K),
                                     self._t(camera.extrinsics), camera.dist)
            cols = tri.interpolate_bilinear(self._t(img) / 255.0, uv)
        self.colors = cols.clamp(0.0, 1.0).cpu().numpy()
        logger.info("Point colors interpolated")
        return self.colors
