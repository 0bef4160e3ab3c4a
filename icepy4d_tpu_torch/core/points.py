"""3D point containers (counterpart of `icepy4d_tpu/core/points.py`):
`PointSet`, the padded device struct {xyz, color, track_id, mask}, and
`Points`, the growable host store of coordinates, colours in [0, 1] and
track ids.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from icepy4d_tpu_torch.core.features import _capacity
from icepy4d_tpu_torch.device import resolve_device


@dataclasses.dataclass
class PointSet:
    xyz: torch.Tensor       # (N, 3) float32
    color: torch.Tensor     # (N, 3) float32 in [0, 1]
    track_id: torch.Tensor  # (N,) int32
    mask: torch.Tensor      # (N,) bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @property
    def num_valid(self) -> torch.Tensor:
        return self.mask.sum(-1, dtype=torch.int32)

    def replace(self, **changes) -> "PointSet":
        return dataclasses.replace(self, **changes)

    @classmethod
    def empty(cls, capacity: int, device=None) -> "PointSet":
        dev = resolve_device(device)
        return cls(xyz=torch.zeros((capacity, 3), device=dev),
                   color=torch.zeros((capacity, 3), device=dev),
                   track_id=torch.full((capacity,), -1, dtype=torch.int32,
                                       device=dev),
                   mask=torch.zeros((capacity,), dtype=torch.bool,
                                    device=dev))

    @classmethod
    def from_arrays(cls, xyz, color=None, track_id=None,
                    capacity: int | None = None, device=None) -> "PointSet":
        """Pad host arrays up to `capacity` (default: the next power of
        two); track ids default to 0..N-1."""
        xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
        n = xyz.shape[0]
        out = cls.empty(_capacity(n, capacity), device)
        dev = out.xyz.device
        out.xyz[:n] = torch.from_numpy(xyz).to(dev)
        out.mask[:n] = True
        if color is not None:
            out.color[:n] = torch.from_numpy(
                np.asarray(color, np.float32).reshape(-1, 3)).to(dev)
        ids = (np.arange(n, dtype=np.int32) if track_id is None
               else np.asarray(track_id, np.int32).reshape(-1))
        out.track_id[:n] = torch.from_numpy(ids).to(dev)
        return out


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

    def to_point_cloud(self):
        from icepy4d_tpu_torch.core.point_cloud import PointCloud

        return PointCloud(points3d=self._xyz, points_col=self._color)

    def to_padded(self, capacity: int | None = None,
                  device=None) -> PointSet:
        return PointSet.from_arrays(self._xyz, color=self._color,
                                    track_id=self._track_id,
                                    capacity=capacity, device=device)
