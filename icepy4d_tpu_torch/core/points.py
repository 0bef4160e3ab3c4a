"""Host 3D point store.

Counterpart of `icepy4d_tpu/core/points.py::Points`: a growable numpy
store of coordinates, colours in [0, 1] and track ids. The padded
device struct (`PointSet`) is not ported: neither the pipeline nor the
tracking uses it.
"""

from __future__ import annotations

import numpy as np


class Points:
    def __init__(self):
        self._xyz = np.zeros((0, 3), np.float32)
        self._color = np.zeros((0, 3), np.float32)
        self._track_id = np.zeros((0,), np.int32)
        self._last_track_id = -1

    def __len__(self) -> int:
        return self._xyz.shape[0]

    def __repr__(self) -> str:
        return f"Points({len(self)} points)"

    def append_points_from_numpy(self, coords, track_ids=None,
                                 colors=None) -> None:
        """Append points; colours above 1 are taken as 0-255 values."""
        coords = np.asarray(coords, np.float32).reshape(-1, 3)
        n = coords.shape[0]
        if track_ids is None:
            track_ids = np.arange(self._last_track_id + 1,
                                  self._last_track_id + 1 + n, dtype=np.int32)
        else:
            track_ids = np.asarray(track_ids, np.int32).reshape(-1)
        if colors is None:
            colors = np.zeros((n, 3), np.float32)
        else:
            colors = np.asarray(colors, np.float32).reshape(-1, 3)
            if colors.max(initial=0.0) > 1.0:
                colors = colors / 255.0
        self._xyz = np.concatenate([self._xyz, coords])
        self._color = np.concatenate([self._color, colors])
        self._track_id = np.concatenate([self._track_id, track_ids])
        if n:
            self._last_track_id = int(max(self._last_track_id,
                                          track_ids.max()))

    def to_numpy(self) -> np.ndarray:
        return self._xyz.copy()

    def colors_to_numpy(self, as_uint8: bool = False) -> np.ndarray:
        if as_uint8:
            return (self._color * 255.0).astype(np.uint8)
        return self._color.copy()

    def track_ids_to_numpy(self) -> np.ndarray:
        return self._track_id.copy()

    def get_track_ids(self) -> tuple:
        return tuple(self._track_id.tolist())

    def _select(self, sel) -> None:
        self._xyz = self._xyz[sel]
        self._color = self._color[sel]
        self._track_id = self._track_id[sel]

    def filter_point_by_mask(self, mask) -> None:
        self._select(np.asarray(mask, bool).reshape(-1))

    def filter_point_by_index(self, indexes) -> None:
        self._select(np.asarray(indexes, np.int64).reshape(-1))
