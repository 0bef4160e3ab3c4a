"""Point cloud container with a statistical-outlier-removal filter
(counterpart of `icepy4d_tpu/core/point_cloud.py`).

Host numpy storage, PLY through `io/ply.py`, and the SOR filter as a
blocked brute-force kNN on the device.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from icepy4d_tpu_torch.device import full_f32_matmul, resolve_device
from icepy4d_tpu_torch.io.ply import read_ply, write_ply


def centred(xyz: torch.Tensor) -> torch.Tensor:
    """float32 coordinates relative to the cloud's mean (taken in
    float64).

    The brute-force kNN forms squared distances as |a|^2 + |b|^2 - 2a.b;
    in float32 that keeps centimetres only near the origin (at 1.4 km
    |a|^2 is resolved to ~0.2 m^2). Distances do not change under a
    translation, so every kNN here runs on centred coordinates.
    """
    x64 = xyz.to(torch.float64)
    return (x64 - x64.mean(0)).to(torch.float32)


def _sor_mask(xyz: torch.Tensor, knn: int, std_ratio: float,
              block: int = 4096) -> torch.Tensor:
    """Statistical outlier removal mask by brute-force kNN.

    Distances run in row blocks on centred coordinates, so the peak is a
    (block, N) tile, not (N, N): each point's mean distance to its k
    nearest others (self masked), kept when it lies within `std_ratio`
    standard deviations of the mean of those means.
    """
    n = xyz.shape[0]
    k = min(knn, n - 1)
    xyz = centred(xyz)
    sq_all = torch.sum(xyz * xyz, 1)
    cols = torch.arange(n, device=xyz.device)
    means = []
    for i0 in range(0, n, block):
        pts = xyz[i0:i0 + block]
        with full_f32_matmul():
            cross = pts @ xyz.T
        d2 = (torch.sum(pts * pts, 1)[:, None] + sq_all[None, :]
              - 2.0 * cross).clamp_min_(0.0)
        d2.masked_fill_(cols[i0:i0 + len(pts), None] == cols[None, :],
                        torch.inf)
        near = torch.topk(d2, k, dim=1, largest=False).values
        means.append(torch.sqrt(near.clamp_min(0.0)).mean(1))
    mean_d = torch.cat(means)
    mu = mean_d.mean()
    sigma = mean_d.std(correction=0)
    return mean_d <= mu + std_ratio * sigma


class PointCloud:
    """Points (N, 3) float32 and optional colours (N, 3) in [0, 1]."""

    def __init__(self, points3d: np.ndarray | None = None,
                 pcd_path: str | Path | None = None,
                 points_col: np.ndarray | None = None):
        if pcd_path is not None:
            xyz, rgb = read_ply(pcd_path)
            self.points = xyz
            self.colors = (rgb.astype(np.float32) / 255.0
                           if rgb is not None else None)
        else:
            self.points = (np.asarray(points3d, np.float32).reshape(-1, 3)
                           if points3d is not None
                           else np.zeros((0, 3), np.float32))
            if points_col is not None:
                c = np.asarray(points_col, np.float32).reshape(-1, 3)
                if c.max(initial=0.0) > 1.0:
                    c = c / 255.0
                self.colors = c
            else:
                self.colors = None

    def __len__(self) -> int:
        return self.points.shape[0]

    def get_points(self) -> np.ndarray:
        return self.points.copy()

    def get_colors(self, as_uint8: bool = True) -> np.ndarray | None:
        if self.colors is None:
            return None
        if as_uint8:
            return (self.colors * 255.0).astype(np.uint8)
        return self.colors.copy()

    def sor_filter(self, nb_neighbors: int = 10, std_ratio: float = 3.0,
                   device=None) -> "PointCloud":
        """Statistical outlier removal on `device` (None: the card)."""
        if len(self) <= nb_neighbors:
            return self
        dev = resolve_device(device)
        mask = _sor_mask(torch.as_tensor(self.points, device=dev),
                         int(nb_neighbors), float(std_ratio)).cpu().numpy()
        self.points = self.points[mask]
        if self.colors is not None:
            self.colors = self.colors[mask]
        return self

    def write_ply(self, path) -> None:
        write_ply(path, self.points, self.colors)

    def write_las(self, path) -> None:
        """LAS export; needs the optional laspy package."""
        try:
            import laspy
        except ImportError as e:
            raise ImportError(
                "laspy not available — use write_ply instead") from e
        header = laspy.LasHeader(point_format=2)
        las = laspy.LasData(header)
        las.x = self.points[:, 0]
        las.y = self.points[:, 1]
        las.z = self.points[:, 2]
        if self.colors is not None:
            c = (np.asarray(self.colors) * 65535).astype(np.uint16)
            las.red, las.green, las.blue = c[:, 0], c[:, 1], c[:, 2]
        las.write(str(path))

    save = write_ply
