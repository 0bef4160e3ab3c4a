"""CSV metric sinks.

Counterpart of `icepy4d_tpu/io/export2textfile.py`, with the same
columns: `write_reprojection_error_to_file` appends one epoch's
per-camera residual means and the global residual-norm statistics,
`write_cameras_to_file` one epoch's focal, omega/phi/kappa and centre
per camera; `export_keypoints` and `export_points3D` are plain text
dumps.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_STAT_KEYS = ("count", "mean", "std", "min", "25%", "50%", "75%", "max")


def _stats(v: np.ndarray) -> dict:
    """describe()-style summary of a 1-D array."""
    if len(v) == 0:
        return {k: np.nan for k in _STAT_KEYS}
    return {"count": len(v), "mean": float(np.mean(v)),
            "std": float(np.std(v, ddof=1)) if len(v) > 1 else 0.0,
            "min": float(np.min(v)),
            "25%": float(np.percentile(v, 25)),
            "50%": float(np.percentile(v, 50)),
            "75%": float(np.percentile(v, 75)),
            "max": float(np.max(v))}


def compute_reprojection_residuals(cameras: dict, points3d: np.ndarray,
                                   image_points: dict) -> dict:
    """{cam: (N, 2) projected - observed}, over each camera's finite
    observations (NaN = unseen)."""
    res = {}
    for name, cam in cameras.items():
        xy = np.asarray(image_points[name], np.float32)
        ok = np.isfinite(xy).all(axis=1)
        pts = np.asarray(points3d, np.float32)[ok]
        proj = np.asarray(cam.project_point(pts)) if len(pts) else \
            np.zeros((0, 2), np.float32)
        res[name] = proj - xy[ok]
    return res


def _append_row(path: Path, cols: list, row: list) -> None:
    new = not path.exists()
    with open(path, "a") as f:
        if new:
            f.write(",".join(cols) + "\n")
        f.write(",".join(row) + "\n")


def write_reprojection_error_to_file(path: str | Path, epoch_label: str,
                                     cameras: dict, points3d: np.ndarray,
                                     image_points: dict) -> float:
    """Append one epoch's reprojection-error statistics; returns the
    global RMSE."""
    res = compute_reprojection_residuals(cameras, points3d, image_points)
    norms = {n: np.linalg.norm(r, axis=1) for n, r in res.items()}
    global_norm = np.concatenate(list(norms.values())) if norms \
        else np.zeros((0,))
    rmse = float(np.sqrt(np.mean(global_norm ** 2))) if len(global_norm) \
        else float("nan")
    cols, row = ["epoch"], [epoch_label]
    for name in cameras:
        cols += [f"{name}_mean_x", f"{name}_mean_y", f"{name}_mean_norm"]
        r = res[name]
        row += ([f"{np.mean(r[:, 0]):.4f}", f"{np.mean(r[:, 1]):.4f}",
                 f"{np.mean(norms[name]):.4f}"] if len(r)
                else ["nan", "nan", "nan"])
    st = _stats(global_norm)
    for k in _STAT_KEYS:
        cols.append(f"global_norm_{k}")
        row.append(str(st[k]) if k == "count" else f"{st[k]:.4f}")
    cols.append("global_rmse")
    row.append(f"{rmse:.4f}")
    _append_row(Path(path), cols, row)
    return rmse


def write_cameras_to_file(path: str | Path, epoch_label: str,
                          cameras: dict) -> None:
    """Append one epoch's focal, omega/phi/kappa (degrees) and centre per
    camera."""
    cols, row = ["epoch"], [epoch_label]
    for name, cam in cameras.items():
        K = np.asarray(cam.K)
        o, p, k = (float(np.rad2deg(np.asarray(a))) for a in cam.euler_angles)
        C = np.asarray(cam.C).ravel()
        cols += [f"{name}_f", f"{name}_omega", f"{name}_phi",
                 f"{name}_kappa", f"{name}_X", f"{name}_Y", f"{name}_Z"]
        row += [f"{K[0, 0]:.2f}", f"{o:.5f}", f"{p:.5f}", f"{k:.5f}",
                f"{C[0]:.3f}", f"{C[1]:.3f}", f"{C[2]:.3f}"]
    _append_row(Path(path), cols, row)


def export_keypoints(path: str | Path, features: dict) -> None:
    """Dump each camera's keypoints with their track ids as text."""
    with open(path, "w") as f:
        for name, feats in features.items():
            kpts = feats.kpts_to_numpy()
            f.write(f"# camera {name}: {len(kpts)} keypoints\n")
            for (x, y), tid in zip(kpts, feats.track_ids_to_numpy()):
                f.write(f"{name},{tid},{x:.3f},{y:.3f}\n")


def export_points3D(path: str | Path, points3d: np.ndarray) -> None:
    np.savetxt(path, np.asarray(points3d), fmt="%.4f", delimiter=",",
               header="X,Y,Z")
