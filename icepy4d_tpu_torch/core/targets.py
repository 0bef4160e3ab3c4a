"""Ground-control-point (target) store.

Counterpart of `icepy4d_tpu/core/targets.py`, read with the `csv`
module: one image-coordinate table (label,x,y) per camera and one world
table (label,X,Y,Z). A table is a dict of numpy columns, so that
`targets.obj_coor["label"]` lists the surveyed labels as the JAX
package's DataFrame does; labels stay strings.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np


def _read_table(path, need: tuple) -> dict:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header = [h.strip() for h in rows[0]] if rows else []
    if not set(need).issubset(header):
        raise ValueError(f"{path}: expected columns {set(need)}, got "
                         f"{header}")
    body = [r for r in rows[1:] if any(v.strip() for v in r)]
    table = {}
    for j, name in enumerate(header):
        col = [r[j].strip() if j < len(r) else "" for r in body]
        table[name] = np.array(col, dtype=str) if name == "label" \
            else np.array([float(v) for v in col], np.float64)
    return table


class Targets:
    def __init__(self, im_file_path: list[str | Path] | None = None,
                 obj_file_path: str | Path | None = None):
        self.im_coor: list[dict] = [
            _read_table(p, ("label", "x", "y")) for p in im_file_path or []]
        self.obj_coor: dict | None = (
            None if obj_file_path is None
            else _read_table(obj_file_path, ("label", "X", "Y", "Z")))

    def scale_image_coordinates(self, factor: float) -> None:
        """Rescale every image coordinate by `factor` (target tables are
        digitised on the calibrated resolution; the pipeline rescales K
        for downscaled frames, and the targets follow)."""
        for t in self.im_coor:
            t["x"] = t["x"] * factor
            t["y"] = t["y"] * factor

    @staticmethod
    def _lookup(table: dict, labels, cols: tuple):
        rows, found = [], []
        for lab in labels:
            hit = np.nonzero(table["label"] == str(lab))[0]
            if len(hit):
                rows.append([float(table[c][hit[0]]) for c in cols])
                found.append(lab)
        return np.array(rows, np.float32).reshape(-1, len(cols)), found

    def get_im_coor_by_label(self, labels: list[str], cam_id: int
                             ) -> tuple[np.ndarray, list[str]]:
        """(n, 2) image coordinates of the labels found on camera
        `cam_id`, and the labels found."""
        return self._lookup(self.im_coor[cam_id], labels, ("x", "y"))

    get_image_coor_by_label = get_im_coor_by_label

    def get_object_coor_by_label(self, labels: list[str]
                                 ) -> tuple[np.ndarray, list[str]]:
        if self.obj_coor is None:
            return np.zeros((0, 3), np.float32), []
        return self._lookup(self.obj_coor, labels, ("X", "Y", "Z"))

    def append_obj_cord(self, new_obj_coor: dict) -> None:
        if self.obj_coor is None:
            self.obj_coor = {k: np.asarray(v) for k, v in new_obj_coor.items()}
        else:
            self.obj_coor = {k: np.concatenate([self.obj_coor[k],
                                                np.asarray(new_obj_coor[k])])
                             for k in self.obj_coor}
