"""Feature containers (counterpart of `icepy4d_tpu/core/features.py`).

  * `FeatureSet`: the padded device struct, tensors of a fixed capacity
    {xy, descr, score, track_id, mask}, `mask` marking the valid rows;
  * `Features`: the growable host store (keypoints, descriptors,
    scores, track ids as numpy arrays) with the reference's API, which
    converts to and from a FeatureSet.
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path

import numpy as np
import torch

from icepy4d_tpu_torch.device import resolve_device


def _capacity(n: int, capacity: int | None) -> int:
    """The next power of two at or above n (at least 8) by default;
    ValueError when n rows do not fit."""
    if capacity is None:
        capacity = max(8, 1 << (max(n, 1) - 1).bit_length())
    if n > capacity:
        raise ValueError(f"{n} rows exceed the capacity {capacity}")
    return capacity


@dataclasses.dataclass
class FeatureSet:
    xy: torch.Tensor        # (N, 2) float32 pixel coordinates
    descr: torch.Tensor     # (N, D) float32 descriptors
    score: torch.Tensor     # (N,) float32 detection scores
    track_id: torch.Tensor  # (N,) int32 identity across epochs, -1 invalid
    mask: torch.Tensor      # (N,) bool validity

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    @property
    def num_valid(self) -> torch.Tensor:
        return self.mask.sum(-1, dtype=torch.int32)

    def replace(self, **changes) -> "FeatureSet":
        return dataclasses.replace(self, **changes)

    @classmethod
    def empty(cls, capacity: int, descr_dim: int = 256,
              device=None) -> "FeatureSet":
        dev = resolve_device(device)
        return cls(xy=torch.zeros((capacity, 2), device=dev),
                   descr=torch.zeros((capacity, descr_dim), device=dev),
                   score=torch.zeros((capacity,), device=dev),
                   track_id=torch.full((capacity,), -1, dtype=torch.int32,
                                       device=dev),
                   mask=torch.zeros((capacity,), dtype=torch.bool,
                                    device=dev))

    @classmethod
    def from_arrays(cls, xy, descr=None, score=None, track_id=None,
                    capacity: int | None = None, descr_dim: int = 256,
                    device=None) -> "FeatureSet":
        """Pad host arrays up to `capacity` (default: the next power of
        two). Descriptors may come as (N, D) or (D, N); track ids
        default to 0..N-1."""
        xy = np.asarray(xy, np.float32).reshape(-1, 2)
        n = xy.shape[0]
        if descr is not None:
            descr = np.asarray(descr, np.float32)
            if descr.shape[0] != n:
                descr = descr.T
            descr_dim = descr.shape[1]
        out = cls.empty(_capacity(n, capacity), descr_dim, device)
        dev = out.xy.device
        out.xy[:n] = torch.from_numpy(xy).to(dev)
        out.mask[:n] = True
        if descr is not None:
            out.descr[:n] = torch.from_numpy(descr).to(dev)
        if score is not None:
            out.score[:n] = torch.from_numpy(
                np.asarray(score, np.float32).reshape(-1)).to(dev)
        ids = (np.arange(n, dtype=np.int32) if track_id is None
               else np.asarray(track_id, np.int32).reshape(-1))
        out.track_id[:n] = torch.from_numpy(ids).to(dev)
        return out

    def compact(self) -> "Features":
        """The valid rows as a host Features."""
        m = self.mask.cpu().numpy()
        return Features.from_numpy(
            self.xy.cpu().numpy()[m], descr=self.descr.cpu().numpy()[m],
            scores=self.score.cpu().numpy()[m],
            track_ids=self.track_id.cpu().numpy()[m])


class Features:
    """Keypoints (N, 2), descriptors (N, D), scores (N,) and track ids
    (N,), kept aligned by row; track ids are the stable identities."""

    def __init__(self, descr_dim: int = 256):
        self._xy = np.zeros((0, 2), np.float32)
        self._descr = np.zeros((0, descr_dim), np.float32)
        self._score = np.zeros((0,), np.float32)
        self._track_id = np.zeros((0,), np.int32)
        self._last_track_id = -1

    def __len__(self) -> int:
        return self._xy.shape[0]

    def __repr__(self) -> str:
        return f"Features({len(self)} features, descr_dim={self.descr_dim})"

    @property
    def last_track_id(self) -> int:
        return self._last_track_id

    @property
    def descr_dim(self) -> int:
        return self._descr.shape[1]

    def set_last_track_id(self, tid: int) -> None:
        self._last_track_id = int(tid)

    @classmethod
    def from_numpy(cls, xy, descr=None, scores=None,
                   track_ids=None) -> "Features":
        f = cls(descr_dim=descr.shape[1] if descr is not None else 256)
        f.append_features_from_numpy(xy, descr=descr, scores=scores,
                                     track_ids=track_ids)
        return f

    def append_features_from_numpy(self, xy, descr=None, scores=None,
                                   track_ids=None) -> None:
        """Append features. Descriptors may come as (N, D) or (D, N);
        absent or colliding track ids are re-assigned progressively."""
        xy = np.asarray(xy, np.float32).reshape(-1, 2)
        n = xy.shape[0]
        if descr is not None:
            descr = np.asarray(descr, np.float32)
            if descr.shape[0] != n and descr.shape[1] == n:
                descr = descr.T
        else:
            descr = np.zeros((n, self.descr_dim), np.float32)
        scores = (np.zeros((n,), np.float32) if scores is None
                  else np.asarray(scores, np.float32).reshape(-1))
        fresh = np.arange(self._last_track_id + 1,
                          self._last_track_id + 1 + n, dtype=np.int32)
        if track_ids is None:
            track_ids = fresh
        else:
            track_ids = np.asarray(track_ids, np.int32).reshape(-1)
            ids = set(track_ids.tolist())
            if len(ids) != n or set(self._track_id.tolist()) & ids:
                track_ids = fresh
        if descr.shape[1] != self.descr_dim:
            if len(self):
                raise ValueError("descriptor dim mismatch")
            self._descr = np.zeros((0, descr.shape[1]), np.float32)
        self._xy = np.concatenate([self._xy, xy])
        self._descr = np.concatenate([self._descr, descr])
        self._score = np.concatenate([self._score, scores])
        self._track_id = np.concatenate([self._track_id, track_ids])
        if n:
            self._last_track_id = int(max(self._last_track_id,
                                          track_ids.max()))

    # -- exports -----------------------------------------------------------
    def to_numpy(self) -> dict:
        return {"kpts": self._xy.copy(), "descr": self._descr.copy(),
                "scores": self._score.copy(),
                "track_ids": self._track_id.copy()}

    def kpts_to_numpy(self) -> np.ndarray:
        return self._xy.copy()

    def descr_to_numpy(self) -> np.ndarray:
        return self._descr.copy()

    def scores_to_numpy(self) -> np.ndarray:
        return self._score.copy()

    def track_ids_to_numpy(self) -> np.ndarray:
        return self._track_id.copy()

    def get_track_ids(self) -> tuple:
        return tuple(self._track_id.tolist())

    def get_features_as_dict(self) -> dict:
        """SuperPoint-style keys, descriptors as (D, N)."""
        return {"keypoints0": self._xy.copy(),
                "descriptors0": self._descr.T.copy(),
                "scores0": self._score.copy()}

    # -- filtering ---------------------------------------------------------
    def _select(self, sel) -> None:
        self._xy = self._xy[sel]
        self._descr = self._descr[sel]
        self._score = self._score[sel]
        self._track_id = self._track_id[sel]

    def filter_feature_by_mask(self, inlier_mask, verbose: bool = False
                               ) -> None:
        self._select(np.asarray(inlier_mask, bool).reshape(-1))

    def filter_feature_by_index(self, indexes) -> None:
        self._select(np.asarray(indexes, np.int64).reshape(-1))

    def get_feature_by_track_id(self, tid: int):
        pos = np.nonzero(self._track_id == tid)[0]
        if len(pos) == 0:
            return None
        i = pos[0]
        return {"x": float(self._xy[i, 0]), "y": float(self._xy[i, 1]),
                "track_id": int(tid), "descr": self._descr[i],
                "score": float(self._score[i])}

    def to_padded(self, capacity: int | None = None,
                  device=None) -> FeatureSet:
        return FeatureSet.from_arrays(self._xy, descr=self._descr,
                                      score=self._score,
                                      track_id=self._track_id,
                                      capacity=capacity, device=device)

    # -- persistence -------------------------------------------------------
    def save_as_txt(self, path, fmt: str = "%i", delimiter: str = ",",
                    header: str = "x,y") -> None:
        np.savetxt(path, self._xy, fmt=fmt, delimiter=delimiter,
                   header=header, comments="")

    def save_as_pickle(self, path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def read_pickle(path) -> "Features":
        with open(path, "rb") as f:
            return pickle.load(f)
