"""Grid tiling with overlap and one uniform tile size, so a tile batch is
one tensor (counterpart of `icepy4d_tpu/matching/tiling.py`)."""

from __future__ import annotations

import numpy as np
import torch

from icepy4d_tpu_torch.ops.image import compute_tile_limits, extract_tiles


class Tiler:
    """grid = [nrows, ncols]; overlap in px; origin = [x, y] top-left offset."""

    def __init__(self, grid=None, overlap: int = 0, origin=None):
        self._grid = list(grid) if grid is not None else [1, 1]
        self._overlap = int(overlap)
        self._origin = list(origin) if origin is not None else [0, 0]
        self._limits: dict[int, tuple] = {}
        self._tile_size: tuple[int, int] = (0, 0)

    @property
    def grid(self):
        return self._grid

    @property
    def overlap(self) -> int:
        return self._overlap

    @property
    def origin(self):
        return self._origin

    @property
    def limits(self) -> dict[int, tuple]:
        """tile_idx -> (xmin, ymin, xmax, ymax), row-major."""
        return self._limits

    @property
    def n_tiles(self) -> int:
        return self._grid[0] * self._grid[1]

    @property
    def tile_size(self) -> tuple[int, int]:
        """(th, tw) shared by every tile."""
        return self._tile_size

    def compute_limits_by_grid(self, image) -> tuple[dict[int, tuple], list]:
        """Per-tile bounding boxes for `image` (H, W[, C]), clamped inside
        the image so every tile has the same shape."""
        h, w = image.shape[:2]
        ox, oy = self._origin
        lims = compute_tile_limits(
            h - oy, w - ox, (self._grid[0], self._grid[1]), self._overlap)
        lims[:, 0] += ox
        lims[:, 1] += oy
        th, tw = int(lims[0, 3]), int(lims[0, 2])
        self._tile_size = (th, tw)
        self._limits = {
            i: (int(x0), int(y0), int(x0) + tw, int(y0) + th)
            for i, (x0, y0, _, _) in enumerate(lims)
        }
        self._origins_np = lims[:, :2].astype(np.int32)
        return self._limits, self._origin

    def tile_origins(self) -> np.ndarray:
        """(T, 2) int32 [x0, y0] per tile (row-major)."""
        return self._origins_np

    def extract_patch(self, image, limits) -> np.ndarray:
        """Host-side crop of one tile, limits (xmin, ymin, xmax, ymax)."""
        return np.asarray(image)[limits[1]: limits[3], limits[0]: limits[2]]

    def extract_all(self, image) -> torch.Tensor:
        """Every tile of `image` (H, W[, C]) in one gather on its device:
        (T, th, tw[, C]). A numpy image is taken as a CPU tensor."""
        th, tw = self._tile_size
        return extract_tiles(torch.as_tensor(image), self._origins_np, th, tw)
