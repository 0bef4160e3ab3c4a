"""Tiling of a frame as icepy4d tiles it (`Tiler.compute_limits_by_grid`):
a rows x cols grid, steps rounded down to 10 px, one tile size grown by
the overlap on each side, the last row and column on the frame's edge.
EXHAUSTIVE tile selection pairs every tile of one frame with every tile
of the other, in row-major order of (tile0, tile1)."""

from __future__ import annotations

from itertools import product

import numpy as np


def tile_limits(h: int, w: int, grid, overlap: int) -> np.ndarray:
    """(rows * cols, 4) int [x0, y0, tw, th]."""
    rows, cols = grid
    dx = (w // cols) // 10 * 10
    dy = (h // rows) // 10 * 10
    tw, th = min(dx + 2 * overlap, w), min(dy + 2 * overlap, h)
    lims = []
    for r in range(rows):
        for c in range(cols):
            x0 = w - tw if c == cols - 1 else min(max(c * dx - overlap, 0),
                                                  w - tw)
            y0 = h - th if r == rows - 1 else min(max(r * dy - overlap, 0),
                                                  h - th)
            lims.append([x0, y0, tw, th])
    return np.asarray(lims, np.int64)


def exhaustive_pairs(n_tiles: int) -> list[tuple[int, int]]:
    return sorted(product(range(n_tiles), range(n_tiles)))
