"""Glaciology analysis products: borders, sections, voxels, volumes
(counterpart of `icepy4d_tpu/post_processing/analysis.py`).

- geometric features and border detection: a brute-force kNN as
  row-blocked float32 matmuls and `topk` on the device, on coordinates
  centred on the cloud's mean, then the batched eigen-decomposition of
  each point's 3x3 neighbourhood covariance;
- the glacier top-border time series;
- cross sections and their plots (matplotlib, imported when called);
- voxelization: scatter binning into a static grid on the device;
- the volume-variation workflow: DEM of difference along any axis, the
  CSV schema of the upstream scripts, daily / surface-normalised /
  cumulative series (pandas, imported when called) and their plots.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import torch

from icepy4d_tpu_torch.core.point_cloud import centred
from icepy4d_tpu_torch.device import full_f32_matmul, resolve_device
from icepy4d_tpu_torch.ops.epipolar import EIGH_CHUNK

logger = logging.getLogger("icepy4d_tpu_torch")

_AXIS = {"x": 0, "y": 1, "z": 2}
CPU_BLOCK = 2048            # kNN rows a block on the CPU


# -- geometric features (linearity / planarity / verticality) ----------------


def _knn_block(n: int, device: torch.device) -> int:
    """kNN rows a block: on the card, half its free memory over ~6
    float32 (block, n) tiles (the product, the distance terms and
    `topk`'s workspace); CPU_BLOCK on the CPU."""
    if device.type != "cuda":
        return CPU_BLOCK
    free = torch.cuda.mem_get_info(device)[0]
    return int(max(1, min(n, free // (2 * 6 * 4 * n))))


def _knn_indices(xyz: torch.Tensor, k: int,
                 block: int | None = None) -> torch.Tensor:
    """(N, k) indices of the k nearest neighbours (self included),
    nearest first.

    Row-blocked brute force on centred coordinates (`centred`): each
    block is one (block, N) float32 product (no TF32) and a `topk`;
    `block` None picks the rows from free memory (`_knn_block`).
    """
    n = xyz.shape[0]
    xyz = centred(xyz)
    if block is None:
        block = _knn_block(n, xyz.device)
    sq_all = torch.sum(xyz * xyz, 1)
    out = []
    for i0 in range(0, n, block):
        pts = xyz[i0:i0 + block]
        with full_f32_matmul():
            cross = pts @ xyz.T
        d2 = torch.sum(pts * pts, 1)[:, None] + sq_all[None, :] - 2.0 * cross
        del cross
        out.append(torch.topk(d2, k, dim=1, largest=False).indices)
        del d2
    return torch.cat(out)


def _features_from_knn(xyz: torch.Tensor, nbr: torch.Tensor, k: int) -> dict:
    """Covariance features of each point's neighbourhood `nbr` (N, k):
    eigenvalues l1 >= l2 >= l3 and the normal (smallest eigenvector),
    the eigen-decompositions in chunks of EIGH_CHUNK (cuSOLVER's batched
    eigh refuses larger batches)."""
    nb = xyz[nbr]                                    # (N, k, 3)
    d = nb - nb.mean(1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", d, d) / k     # (N, 3, 3)
    parts = [torch.linalg.eigh(c) for c in cov.split(EIGH_CHUNK)]
    evals = torch.cat([p[0] for p in parts])         # ascending
    evecs = torch.cat([p[1] for p in parts])
    l3, l2, l1 = evals[:, 0], evals[:, 1], evals[:, 2]
    eps = 1e-12
    normal = evecs[:, :, 0]
    # CloudCompare's Verticality = 1 - |n_z| (1 = vertical surface)
    return {"linearity": (l1 - l2) / (l1 + eps),
            "planarity": (l2 - l3) / (l1 + eps),
            "sphericity": l3 / (l1 + eps),
            "verticality": 1.0 - normal[:, 2].abs(),
            "normal": normal}


def geometric_features(points: np.ndarray, k: int = 32,
                       block: int | None = None, device=None) -> dict:
    """Per-point covariance features of the k-NN neighbourhood on
    `device` (None: the card), as CloudCompare's ``computeFeature``
    (Linearity, Verticality; radius neighbourhoods approximated by
    kNN). Returns numpy arrays keyed linearity / planarity / sphericity
    / verticality / normal."""
    dev = resolve_device(device)
    xyz = centred(torch.as_tensor(np.asarray(points, np.float32),
                                  device=dev))
    k = min(k, xyz.shape[0])
    nbr = _knn_indices(xyz, k, block)
    out = _features_from_knn(xyz, nbr, k)
    return {kk: v.cpu().numpy() for kk, v in out.items()}


def detect_border(
    points: np.ndarray,
    k: int = 32,
    linearity_percentile: tuple = (95, 100),
    verticality_percentile: tuple = (95, 100),
    z_percentile: tuple = (60, 95),
    device=None,
) -> np.ndarray:
    """Boolean mask of glacier top-border candidate points.

    The filter chain of the upstream border script: keep the
    top-linearity percentile band, then the top-verticality band within
    it, then a z-percentile band (the border sits below the very top of
    the vertical face).
    """
    points = np.asarray(points, np.float32)
    f = geometric_features(points, k=k, device=device)
    mask = np.ones(len(points), bool)

    for key, band in (("linearity", linearity_percentile),
                      ("verticality", verticality_percentile)):
        vals = np.where(mask, f[key], np.nan)
        lo = np.nanpercentile(vals, band[0])
        hi = np.nanpercentile(vals, band[1])
        mask &= (f[key] >= lo) & (f[key] <= hi)

    z = np.where(mask, points[:, 2], np.nan)
    lo = np.nanpercentile(z, z_percentile[0])
    hi = np.nanpercentile(z, z_percentile[1])
    mask &= (points[:, 2] >= lo) & (points[:, 2] <= hi)
    return mask


def border_statistics(
    border_points: np.ndarray,
    y_lims: tuple | None = None,
    x_halfwidth: float | None = 10.0,
) -> dict:
    """Center-of-border stats row: optional y band filter, keep points
    within ±x_halfwidth of the median x, then mean/median/std per
    axis."""
    pts = np.asarray(border_points, np.float64)
    if y_lims is not None:
        pts = pts[(pts[:, 1] >= y_lims[0]) & (pts[:, 1] <= y_lims[1])]
    if x_halfwidth is not None and len(pts):
        med_x = np.median(pts[:, 0])
        pts = pts[np.abs(pts[:, 0] - med_x) <= x_halfwidth]
    if not len(pts):
        nan = float("nan")
        return {f"{a}_{s}": nan for a in "xyz"
                for s in ("mean", "median", "std")}
    row = {}
    for i, a in enumerate("xyz"):
        row[f"{a}_mean"] = float(pts[:, i].mean())
        row[f"{a}_median"] = float(np.median(pts[:, i]))
        row[f"{a}_std"] = float(pts[:, i].std())
    return row


def write_border_time_series(rows: list, path) -> Path:
    """CSV in the top_border_coords.txt schema: one row per (pcd_name,
    date)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write("pcd_name,date,x_mean,x_median,x_std,"
                "y_mean,y_median,y_std,z_mean,z_median,z_std\n")
        for name, date, st in rows:
            f.write(f"{name},{date},"
                    f"{st['x_mean']:.3f},{st['x_median']:.3f},"
                    f"{st['x_std']:.3f},{st['y_mean']:.3f},"
                    f"{st['y_median']:.3f},{st['y_std']:.3f},"
                    f"{st['z_mean']:.3f},{st['z_median']:.3f},"
                    f"{st['z_std']:.3f}\n")
    return path


# -- cross sections ----------------------------------------------------------


def extract_section(points: np.ndarray, axis: str, station: float,
                    thickness: float = 1.0,
                    colors: np.ndarray | None = None):
    """Points within ±thickness/2 of `station` along `axis` (a planar
    slab)."""
    pts = np.asarray(points)
    a = _AXIS[axis]
    m = np.abs(pts[:, a] - station) <= thickness / 2.0
    if colors is not None:
        return pts[m], np.asarray(colors)[m]
    return pts[m]


def extract_sections(points: np.ndarray, axis: str, stations,
                     thickness: float = 1.0) -> dict:
    """{station: (M, 3) section} for a list of stations."""
    return {float(s): extract_section(points, axis, float(s), thickness)
            for s in stations}


def set_axes_equal(ax) -> None:
    """Equal-scale 3D axes."""
    limits = np.array([ax.get_xlim3d(), ax.get_ylim3d(),
                       ax.get_zlim3d()])
    origin = np.mean(limits, axis=1)
    radius = 0.5 * np.max(np.abs(limits[:, 1] - limits[:, 0]))
    x, y, z = origin
    ax.set_xlim3d([x - radius, x + radius])
    ax.set_ylim3d([y - radius, y + radius])
    ax.set_zlim3d([z - radius, z + radius])


def plot_sections(sections: dict, elev: float = 0.0, azim: float = -90.0,
                  out: str | Path | None = None):
    """Orthographic 3D scatter of named sections, XZ view by default.
    Headless: returns the figure, saves to `out` when given."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(projection="3d")
    for name, cloud in sections.items():
        cloud = np.asarray(cloud)
        if not len(cloud):
            continue
        ax.scatter(cloud[:, 0], cloud[:, 1], cloud[:, 2],
                   label=str(name), s=5, alpha=0.7)
    ax.set_xlabel("X", fontsize=12)
    ax.set_ylabel("Y", fontsize=12)
    ax.set_zlabel("Z", fontsize=12)
    ax.legend(prop={"size": 12}, markerscale=4)
    ax.view_init(elev=elev, azim=azim)
    ax.set_box_aspect([1, 1, 1])
    ax.set_proj_type("ortho")
    set_axes_equal(ax)
    ax.grid(True, linestyle="--", alpha=0.5)
    fig.tight_layout()
    if out is not None:
        fig.savefig(out, dpi=200)
    return fig


# -- voxelization ------------------------------------------------------------


@dataclass
class VoxelGrid:
    centers: np.ndarray      # (M, 3) filled-voxel centers
    colors: np.ndarray       # (M, 3) mean color per voxel (0..1)
    counts: np.ndarray       # (M,) points per voxel
    indices: np.ndarray      # (M, 3) int grid indices
    voxel_size: float
    origin: np.ndarray       # (3,) = bb_min


def _voxel_bin(pts: torch.Tensor, cols: torch.Tensor, origin: torch.Tensor,
               voxel_size: torch.Tensor, shape: tuple):
    """(count, colour sum) per voxel of a grid of `shape`; points out of
    it or not finite go to the dump slot prod(shape)."""
    nx, ny, nz = shape
    idx = torch.floor((pts - origin) / voxel_size).to(torch.int64)
    ok = ((idx >= 0).all(1)
          & (idx < torch.as_tensor(shape, device=idx.device)).all(1)
          & torch.isfinite(pts).all(1))
    lin = torch.where(ok, (idx[:, 0] * ny + idx[:, 1]) * nz + idx[:, 2],
                      nx * ny * nz)
    size = nx * ny * nz + 1
    cnt = torch.zeros(size, device=pts.device).index_add_(
        0, lin, ok.to(torch.float32))
    csum = torch.zeros((size, 3), device=pts.device).index_add_(
        0, lin, torch.where(ok[:, None], cols, 0.0))
    return cnt[:-1], csum[:-1]


def voxelize(points: np.ndarray, colors: np.ndarray | None = None,
             voxel_size: float = 0.2, bb_min=None, bb_max=None,
             device=None) -> VoxelGrid:
    """Scatter-bin a cloud into a static voxel grid on `device` (None:
    the card), as open3d's
    ``VoxelGrid.create_from_point_cloud_within_bounds``: one scatter-add
    per cloud; the filled voxels and their mean colours come back
    compacted."""
    dev = resolve_device(device)
    pts = np.asarray(points, np.float32)
    if colors is None:
        colors = np.zeros_like(pts)
    cols = np.asarray(colors, np.float32)
    if cols.max() > 1.0:
        cols = cols / 255.0
    finite = pts[np.isfinite(pts).all(axis=1)]
    if bb_min is None:
        bb_min = np.floor(finite.min(axis=0))
    if bb_max is None:
        bb_max = np.ceil(finite.max(axis=0))
    bb_min = np.asarray(bb_min, np.float32)
    bb_max = np.asarray(bb_max, np.float32)
    shape = tuple(int(max(np.ceil((bb_max[i] - bb_min[i]) / voxel_size), 1))
                  for i in range(3))
    cnt, csum = (t.cpu().numpy() for t in _voxel_bin(
        torch.from_numpy(pts).to(dev), torch.from_numpy(cols).to(dev),
        torch.from_numpy(bb_min).to(dev),
        torch.tensor(voxel_size, dtype=torch.float32, device=dev), shape))
    filled = np.nonzero(cnt > 0)[0]
    nx, ny, nz = shape
    ii = filled // (ny * nz)
    jj = (filled // nz) % ny
    kk = filled % nz
    indices = np.stack([ii, jj, kk], axis=1).astype(np.int32)
    centers = bb_min + (indices + 0.5) * voxel_size
    mean_cols = csum[filled] / cnt[filled][:, None]
    return VoxelGrid(centers=centers.astype(np.float32),
                     colors=mean_cols.astype(np.float32),
                     counts=cnt[filled].astype(np.int32),
                     indices=indices, voxel_size=float(voxel_size),
                     origin=bb_min)


def write_voxel_centers(grid: VoxelGrid, path) -> Path:
    """x,y,z,r,g,b rows for filled voxels."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for c, col in zip(grid.centers, grid.colors):
            f.write(f"{c[0]:.4f},{c[1]:.4f},{c[2]:.4f},"
                    f"{col[0]:.4f},{col[1]:.4f},{col[2]:.4f}\n")
    return path


_CUBE_V = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
                   np.float32)
_CUBE_F = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                    [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
                    [1, 2, 6], [1, 6, 5], [0, 4, 7], [0, 7, 3]],
                   np.int64)


def voxel_mesh(grid: VoxelGrid) -> tuple[np.ndarray, np.ndarray,
                                         np.ndarray]:
    """Cube mesh of the filled voxels (verts, faces, vert_colors), one
    broadcast over all voxels."""
    m = len(grid.centers)
    base = grid.origin + grid.indices * grid.voxel_size
    verts = (base[:, None, :] + _CUBE_V[None] * grid.voxel_size
             ).reshape(m * 8, 3)
    faces = (_CUBE_F[None] + (np.arange(m) * 8)[:, None, None]
             ).reshape(m * 12, 3)
    vcols = np.repeat(grid.colors, 8, axis=0)
    return verts.astype(np.float32), faces, vcols.astype(np.float32)


# -- volume variations workflow ----------------------------------------------


def find_closest_date_idx(dates: list, target: datetime) -> int:
    return int(np.argmin([abs((d - target).total_seconds())
                          for d in dates]))


def make_pairs(pcd_list: list, step: int = 1,
               date_format: str = "%Y_%m_%d") -> tuple[dict, list]:
    """Pair every cloud with the one closest to `step` days later:
    ({i: (path0, path1)}, dates). The window is date based, so seasons
    with gaps or multi-day spacing pair correctly."""
    import re

    pcd_list = [Path(p) for p in pcd_list]
    m = re.search(r"\d{4}", pcd_list[0].stem)
    if m is None:
        raise ValueError(f"no date found in {pcd_list[0].stem}")
    idx = m.start()
    dates = [datetime.strptime(p.stem[idx:], date_format)
             for p in pcd_list]
    pair_dict = {}
    dt = timedelta(step)
    for i in range(len(pcd_list)):
        target = dates[i] + dt
        if target > max(dates):
            break
        j = find_closest_date_idx(dates, target)
        pair_dict[i] = (str(pcd_list[i]), str(pcd_list[j]))
    return pair_dict, dates


def volume_variations(
    pcd_paths: list,
    t_step: int = 5,
    grid_step: float = 0.3,
    direction: str = "x",
    out_dir=None,
    base_name: str = "sampled",
    date_format: str = "%Y_%m_%d",
    make_plots: bool = True,
    device=None,
):
    """The volume-variation workflow: pair clouds `t_step` days apart,
    DEM-of-difference each pair along `direction` on `device` (None:
    the card), write the CSV schema of the upstream scripts, derive
    daily / surface-normalised / cumulative series, and save the two
    plots. Returns the pandas DataFrame.
    """
    import pandas as pd

    from icepy4d_tpu_torch.post_processing.point_clouds import (
        DemOfDifference)

    pairs, _dates = make_pairs(pcd_paths, t_step, date_format)
    rows = []
    for i, (p0, p1) in pairs.items():
        dod = DemOfDifference(p0, p1, dsm_step=grid_step,
                              direction=direction, device=device)
        rep = dod.compute_volume()
        rows.append({
            "pcd0": Path(p0).stem, "pcd1": Path(p1).stem,
            "volume": rep.net, "addedVolume": rep.added,
            "removedVolume": rep.removed, "surface": rep.area,
            "matchingPercent": rep.matching_percent,
            "averageNeighborsPerCell": rep.avg_neighbors_per_cell,
        })
        logger.info("DOD %s -> %s: net %.2f m3 (%.1f%% match)",
                    Path(p0).stem, Path(p1).stem, rep.net,
                    rep.matching_percent)
    df = pd.DataFrame(rows)
    if not len(df):
        return df

    max_match = df["matchingPercent"].max()
    df["date_in"] = pd.to_datetime(
        df["pcd0"].str.replace(f"{base_name}_", "", regex=False),
        format=date_format)
    df.sort_values(by="date_in", inplace=True)
    df["date_fin"] = pd.to_datetime(
        df["pcd1"].str.replace(f"{base_name}_", "", regex=False),
        format=date_format)
    df["dt"] = (df.date_fin - df.date_in) / np.timedelta64(1, "D")
    df["volume_daily"] = df["volume"] / df["dt"].replace(0, np.nan)
    df["volume_daily_normalized"] = (
        df["volume_daily"] / df["matchingPercent"] * max_match)
    df["volume_daily_cumul"] = df["volume_daily"].cumsum()
    df["volume_daily_norm_cumul"] = df["volume_daily_normalized"].cumsum()

    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        fout = (f"{base_name}_dir{direction.upper()}_tstep{t_step}"
                f"_grid{grid_step}")
        cols = ["pcd0", "pcd1", "volume", "addedVolume", "removedVolume",
                "surface", "matchingPercent", "averageNeighborsPerCell"]
        df[cols].to_csv(out_dir / f"{fout}.csv", index=False,
                        header=False)
        df.to_csv(out_dir / f"{fout}_proc.csv", index=False)
        if make_plots:
            _volume_plots(df, out_dir, fout, t_step)
    return df


def _volume_plots(df, out_dir: Path, fout: str, t_step: int) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for col, title, suffix in (
        ("volume_daily_normalized",
         f"Daily volume differences - Step {t_step} days",
         "daily_diff_norm"),
        ("volume_daily_norm_cumul",
         f"Cumulated volume difference - Step {t_step} days",
         "daily_diff_norm_cumulated"),
    ):
        fig, ax = plt.subplots()
        fig.set_layout_engine("tight")
        ax.plot(df["date_in"], -df[col])
        ax.set_xlabel("day")
        ax.set_ylabel("-dV [$m^3$]")
        ax.set_title(title)
        ax.grid(True)
        ax.minorticks_on()
        fig.autofmt_xdate()
        fig.savefig(out_dir / f"{fout}_{suffix}.png", dpi=200)
        plt.close(fig)
