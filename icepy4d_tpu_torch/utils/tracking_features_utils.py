"""Time series of tracked features and points across epochs
(counterpart of `icepy4d_tpu/utils/tracking_features_utils.py`).

The features / points that share a track id across an `Epoches`
sequence become per-track time series and pandas DataFrames: the
velocities and displacement fields of the 4D products. pandas is
imported by the functions that build a DataFrame.
"""

from __future__ import annotations

import numpy as np


def sort_features_by_cam(epoches, cam: str) -> dict:
    """{epoch_id: Features} for one camera across all epochs."""
    return {eid: epoches[eid].features[cam] for eid in _ids(epoches)}


def _ids(epoches):
    return [eid for eid, _ in enumerate(iter(epoches))] \
        if not hasattr(epoches, "_epochs") else list(epoches._epochs.keys())


def tracked_features_time_series(
    epoches,
    cam: str,
    min_tracked_epoches: int = 2,
) -> dict[int, dict[int, np.ndarray]]:
    """{track_id: {epoch_id: (x, y)}} for tracks seen in at least
    `min_tracked_epoches` epochs."""
    series: dict[int, dict[int, np.ndarray]] = {}
    for eid in _ids(epoches):
        feats = epoches[eid].features.get(cam)
        if feats is None:
            continue
        ids = feats.track_ids_to_numpy()
        kpts = feats.kpts_to_numpy()
        for tid, xy in zip(ids, kpts):
            series.setdefault(int(tid), {})[eid] = xy
    return {tid: s for tid, s in series.items()
            if len(s) >= min_tracked_epoches}


def tracked_points_time_series(
    epoches,
    min_tracked_epoches: int = 2,
) -> dict[int, dict[int, np.ndarray]]:
    """{track_id: {epoch_id: (X, Y, Z)}} from each epoch's Points."""
    series: dict[int, dict[int, np.ndarray]] = {}
    for eid in _ids(epoches):
        pts = epoches[eid].points
        if pts is None or not len(pts):
            continue
        ids = pts.track_ids_to_numpy()
        xyz = pts.to_numpy()
        for tid, p in zip(ids, xyz):
            series.setdefault(int(tid), {})[eid] = p
    return {tid: s for tid, s in series.items()
            if len(s) >= min_tracked_epoches}


def tracked_time_series_to_df(series: dict, epoches=None):
    """Long-format DataFrame: track_id, epoch, (x, y[, z]) [+ date]."""
    import pandas as pd

    rows = []
    for tid, s in series.items():
        for eid, v in s.items():
            v = np.asarray(v).ravel()
            row = {"track_id": tid, "epoch": eid,
                   "x": v[0], "y": v[1]}
            if len(v) > 2:
                row["z"] = v[2]
            if epoches is not None:
                row["date"] = epoches[eid].timestamp
            rows.append(row)
    return pd.DataFrame(rows).sort_values(
        ["track_id", "epoch"]).reset_index(drop=True)


def compute_displacements(series: dict):
    """Per-track displacement between first and last observation:
    track_id, n_epochs, d (euclidean), per-axis deltas."""
    import pandas as pd

    rows = []
    for tid, s in series.items():
        eids = sorted(s)
        a = np.asarray(s[eids[0]], np.float64).ravel()
        b = np.asarray(s[eids[-1]], np.float64).ravel()
        d = b - a
        row = {"track_id": tid, "n_epochs": len(eids),
               "first_epoch": eids[0], "last_epoch": eids[-1],
               "displacement": float(np.linalg.norm(d))}
        for i, ax in enumerate("xyz"[: len(d)]):
            row[f"d{ax}"] = float(d[i])
        rows.append(row)
    return pd.DataFrame(rows)
