"""Epoch containers and the multi-camera time synchronisation map.

Counterpart of `icepy4d_tpu/core/epoch.py`: an `Epoch` bundles what one
timestamp produced (images, cameras, features, points, targets) with its
quality record; `Epoches` orders them; `EpochDataMap` scans per-camera
image folders and pairs each master image with each other camera's
closest image within a time tolerance, writing `epoch_map.csv`.
"""

from __future__ import annotations

import csv
import os
import pickle
from datetime import datetime
from pathlib import Path

from icepy4d_tpu_torch.core.constants import DATETIME_FMT
from icepy4d_tpu_torch.core.images import Image, ImageDS

_STATUS_ORDER = {"ok": 0, "degraded": 1, "failed": 2}


def parse_str_to_datetime(s: str | datetime) -> datetime:
    if isinstance(s, datetime):
        return s
    for fmt in (DATETIME_FMT, "%Y-%m-%d %H:%M:%S", "%Y:%m:%d %H:%M:%S"):
        try:
            return datetime.strptime(s, fmt)
        except ValueError:
            continue
    raise ValueError(f"Unparseable timestamp: {s!r}")


def find_closest_timestamp(timestamps: list[datetime], target: datetime
                           ) -> tuple[int, float]:
    """Index and |dt| in seconds of the closest timestamp (-1, inf when
    there is none)."""
    best_i, best_dt = -1, float("inf")
    for i, ts in enumerate(timestamps):
        if ts is None:
            continue
        dt = abs((ts - target).total_seconds())
        if dt < best_dt:
            best_i, best_dt = i, dt
    return best_i, best_dt


class Epoch:
    """One epoch. `quality` records the gates that fired: status ok |
    degraded | failed, the flags by name, and the epoch's statistics."""

    def __init__(self, timestamp: str | datetime, images: dict | None = None,
                 cameras: dict | None = None, features: dict | None = None,
                 points=None, targets=None, point_cloud=None,
                 epoch_dir: str | Path | None = None):
        self.timestamp = parse_str_to_datetime(timestamp)
        self.images = images or {}
        self.cameras = cameras or {}
        self.features = features or {}
        self.points = points
        self.targets = targets
        self.point_cloud = point_cloud
        self.epoch_dir = Path(epoch_dir) if epoch_dir else None
        self.quality: dict = {"status": "ok", "flags": [], "stats": {}}

    def flag(self, flag: str, status: str = "degraded", **stats) -> None:
        """Record a failed quality gate; 'failed' dominates 'degraded'."""
        q = self.quality
        if flag not in q["flags"]:
            q["flags"].append(flag)
        if _STATUS_ORDER[status] > _STATUS_ORDER[q["status"]]:
            q["status"] = status
        q["stats"].update(stats)

    def __setstate__(self, state):
        self.__dict__.update(state)
        if "quality" not in state:
            self.quality = {"status": "ok", "flags": [], "stats": {}}

    def __repr__(self) -> str:
        return f"Epoch({self.date_str})"

    @property
    def date_str(self) -> str:
        return self.timestamp.strftime(DATETIME_FMT)

    def save_pickle(self, path: str | Path | None = None) -> Path:
        if path is None:
            if self.epoch_dir is None:
                raise ValueError("No path or epoch_dir set")
            path = self.epoch_dir / f"{self.date_str}.pickle"
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(self, f)
        return path

    @staticmethod
    def read_pickle(path) -> "Epoch":
        with open(path, "rb") as f:
            ep = pickle.load(f)
        if not isinstance(ep, Epoch):
            raise TypeError(f"{path} does not contain an Epoch")
        return ep


class Epoches:
    """Ordered collection of epochs keyed by id and by timestamp."""

    def __init__(self, starting_epoch: int = 0):
        self._starting = starting_epoch
        self._epochs: dict[int, Epoch] = {}
        self._by_ts: dict[datetime, int] = {}

    def __len__(self) -> int:
        return len(self._epochs)

    def __iter__(self):
        return iter(self._epochs.values())

    def __getitem__(self, epoch_id: int) -> Epoch:
        return self._epochs[epoch_id]

    def add_epoch(self, epoch: Epoch, epoch_id: int | None = None) -> int:
        if epoch_id is None:
            epoch_id = (max(self._epochs) + 1) if self._epochs \
                else self._starting
        self._epochs[epoch_id] = epoch
        self._by_ts[epoch.timestamp] = epoch_id
        return epoch_id

    def get_epoch_by_date(self, ts: str | datetime) -> Epoch | None:
        eid = self._by_ts.get(parse_str_to_datetime(ts))
        return self._epochs.get(eid) if eid is not None else None

    def get_epoch_id(self, ts: str | datetime) -> int | None:
        return self._by_ts.get(parse_str_to_datetime(ts))


class EpochDataMap:
    """Scans `image_dir/<cam>/`, takes the master camera (the given
    name, else the first alphabetically) and pairs each master image
    with every other camera's closest image within `time_tolerance_sec`;
    epochs with fewer than `min_images` cameras are dropped.
    use_mtime_fallback: timestamp EXIF-less images by their file
    modification time."""

    def __init__(self, image_dir: str | Path, master_camera: str | None = None,
                 time_tolerance_sec: float = 180.0, min_images: int = 2,
                 write_csv: bool = True, use_mtime_fallback: bool = False):
        self.image_dir = Path(image_dir)
        cams = sorted(p.name for p in self.image_dir.iterdir() if p.is_dir())
        if not cams:
            raise FileNotFoundError(f"No camera folders in {image_dir}")
        self.cams = cams
        self.master = master_camera if master_camera in cams else cams[0]
        self.time_tolerance = time_tolerance_sec
        self.min_images = min_images
        self._datastores = {c: ImageDS(self.image_dir / c) for c in cams}
        if use_mtime_fallback:
            for ds in self._datastores.values():
                for im in ds:
                    if im.datetime is None:
                        im._datetime = datetime.fromtimestamp(
                            os.path.getmtime(im.path))
        self._map: dict[int, dict] = {}
        self._build_map()
        if write_csv:
            self.write_csv(self.image_dir / "epoch_map.csv")

    def __len__(self) -> int:
        return len(self._map)

    def __getitem__(self, epoch_id: int) -> dict:
        return self._map[epoch_id]

    def __iter__(self):
        return iter(self._map.items())

    @property
    def cameras(self) -> list[str]:
        return list(self.cams)

    def _build_map(self) -> None:
        slaves = [c for c in self.cams if c != self.master]
        slave_ts = {c: self._datastores[c].timestamps() for c in slaves}
        eid = 0
        for im in self._datastores[self.master]:
            ts = im.datetime
            if ts is None:
                continue
            entry = {"timestamp": ts, "images": {self.master: im},
                     "dt": {self.master: 0.0}}
            for cam in slaves:
                idx, dt = find_closest_timestamp(slave_ts[cam], ts)
                if idx >= 0 and dt <= self.time_tolerance:
                    entry["images"][cam] = self._datastores[cam][idx]
                    entry["dt"][cam] = dt
            if len(entry["images"]) >= self.min_images:
                self._map[eid] = entry
                eid += 1

    def write_csv(self, path) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["epoch", "timestamp"]
                       + [f"{c}_image" for c in self.cams]
                       + [f"{c}_dt_sec" for c in self.cams])
            for eid, e in self._map.items():
                w.writerow(
                    [eid, e["timestamp"].strftime(DATETIME_FMT)]
                    + [e["images"][c].name if c in e["images"] else ""
                       for c in self.cams]
                    + [f"{e['dt'][c]:.1f}" if c in e["dt"] else ""
                       for c in self.cams])

    def get_images(self, epoch_id: int) -> dict[str, Image]:
        return self._map[epoch_id]["images"]

    def get_timestamp(self, epoch_id: int) -> datetime:
        return self._map[epoch_id]["timestamp"]
