"""DSM gridding, orthophoto sampling and DEM differencing on the device
(counterpart of `icepy4d_tpu/utils/dsm_orthophoto.py`).

- `build_dsm`: a scatter-add binned mean per cell, then an iterative
  masked 3x3 diffusion that fills holes up to `fill_iters` cells from
  data;
- `generate_orthophoto`: every DSM cell projected into a camera and
  its colour sampled bilinearly;
- `dem_of_difference`: the masked grid difference with the added /
  removed volume report (host numpy).

GeoTIFF export works when rasterio is installed; `save_dsm_npz` always
works.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from icepy4d_tpu_torch.device import full_f32_matmul, resolve_device
from icepy4d_tpu_torch.ops.geometry import pad_distortion, project_points
from icepy4d_tpu_torch.ops.image import bilinear_sample

logger = logging.getLogger("icepy4d_tpu_torch")


@dataclass
class DSM:
    """Regular elevation grid."""

    z: np.ndarray        # (H, W) elevation, NaN where empty
    mask: np.ndarray     # (H, W) True where observed/filled
    xx: np.ndarray       # (W,) cell-center x coords
    yy: np.ndarray       # (H,) cell-center y coords
    res: float
    count: np.ndarray | None = None  # (H, W) points binned per cell

    def cell_xyz(self) -> np.ndarray:
        """(H*W, 3) cell centers with elevations (NaN-safe)."""
        gx, gy = np.meshgrid(self.xx, self.yy)
        return np.stack([gx.ravel(), gy.ravel(),
                         np.nan_to_num(self.z).ravel()], -1)


def _grid_points(points: torch.Tensor, x0: float, y0: float, res: float,
                 shape: tuple, fill_iters: int = 0):
    """(z, observed mask, filled mask, count) grids of `shape` (h, w)
    from (N, 3) points: mean z per cell (out-of-range and non-finite
    points go to the dump slot h * w), then `fill_iters` rounds of
    masked 3x3 diffusion into the empty cells next to data."""
    h, w = shape
    dev = points.device
    # divisions by device scalars: a CUDA division by a host scalar is a
    # multiply by its reciprocal, which moves points across cell edges
    x0, y0, res = (torch.tensor(v, dtype=torch.float32, device=dev)
                   for v in (x0, y0, res))
    ix = torch.floor((points[:, 0] - x0) / res).to(torch.int64)
    iy = torch.floor((points[:, 1] - y0) / res).to(torch.int64)
    ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h) \
        & torch.isfinite(points).all(1)
    lin = torch.where(ok, iy * w + ix, h * w)
    zsum = torch.zeros(h * w + 1, device=dev).index_add_(
        0, lin, torch.where(ok, points[:, 2], 0.0))
    cnt = torch.zeros(h * w + 1, device=dev).index_add_(
        0, lin, ok.to(torch.float32))
    z = (zsum[:-1] / cnt[:-1].clamp_min(1.0)).reshape(h, w)
    mask = (cnt[:-1] > 0).reshape(h, w)

    k = torch.ones((1, 1, 3, 3), device=dev)
    m = mask
    with full_f32_matmul():
        for _ in range(fill_iters):
            mf = m.to(z.dtype)
            s = F.conv2d((z * mf)[None, None], k, padding=1)[0, 0]
            n = F.conv2d(mf[None, None], k, padding=1)[0, 0]
            z = torch.where(m, z, s / n.clamp_min(1.0))
            m = m | (n > 0)
    return z, mask, m, cnt[:-1].reshape(h, w)


def build_dsm(
    points: np.ndarray,
    dsm_step: float = 1.0,
    xlim: tuple | None = None,
    ylim: tuple | None = None,
    fill_holes: bool = True,
    fill_iters: int = 10,
    make_dsm_mask: bool = False,
    device=None,
) -> DSM:
    """Bin points (N, 3) into a regular grid of mean elevations on
    `device` (None: the card).

    XY binning at `dsm_step`, the mean z per cell, holes filled up to
    `fill_iters` cells from data. Returns a DSM.
    """
    dev = resolve_device(device)
    points = np.asarray(points, np.float32)
    pts = points[np.isfinite(points).all(axis=1)]
    if xlim is None:
        xlim = (float(np.floor(pts[:, 0].min())),
                float(np.ceil(pts[:, 0].max())))
    if ylim is None:
        ylim = (float(np.floor(pts[:, 1].min())),
                float(np.ceil(pts[:, 1].max())))
    w = max(int(np.ceil((xlim[1] - xlim[0]) / dsm_step)), 1)
    h = max(int(np.ceil((ylim[1] - ylim[0]) / dsm_step)), 1)
    z, mask, filled, cnt = (t.cpu().numpy() for t in _grid_points(
        torch.from_numpy(points).to(dev), xlim[0], ylim[0], dsm_step, (h, w),
        fill_iters=fill_iters if fill_holes else 0))
    mask_out = filled if fill_holes else mask
    z = np.where(mask_out, z, np.nan)
    xx = xlim[0] + (np.arange(w) + 0.5) * dsm_step
    yy = ylim[0] + (np.arange(h) + 0.5) * dsm_step
    logger.info("DSM %dx%d cells at %.2f m, %.1f%% observed",
                h, w, dsm_step, 100.0 * mask.mean())
    return DSM(z=z, mask=mask_out, xx=xx, yy=yy, res=float(dsm_step),
               count=cnt)


def generate_orthophoto(
    image: np.ndarray,
    dsm: DSM,
    camera,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Sample image colors at every DSM cell on `device` (None: the
    card): each cell centre at its elevation, projected through
    `camera` (K, extrinsics, dist).

    Returns (rgb (H, W, C) float in [0,1], valid (H, W))."""
    dev = resolve_device(device)
    img = torch.as_tensor(np.asarray(image), device=dev)
    if img.dtype == torch.uint8:
        img = img.to(torch.float32) / 255.0
    if img.ndim == 2:
        img = img[..., None]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    xy = project_points(f32(dsm.cell_xyz()), f32(camera.K),
                        f32(camera.extrinsics),
                        pad_distortion(camera.dist).to(dev))
    h_img, w_img = img.shape[:2]
    inb = ((xy[:, 0] >= 0) & (xy[:, 0] <= w_img - 1)
           & (xy[:, 1] >= 0) & (xy[:, 1] <= h_img - 1))
    hh, ww = dsm.z.shape
    rgb = bilinear_sample(img, xy).cpu().numpy().reshape(hh, ww, -1)
    valid = inb.cpu().numpy().reshape(hh, ww) & dsm.mask
    return np.where(valid[..., None], rgb, 0.0), valid


@dataclass
class VolumeReport:
    added: float
    removed: float
    net: float
    area: float
    mean_dz: float
    # CloudCompare ReportInfoVol fields
    matching_percent: float = 100.0     # % of observed cells seen by both
    avg_neighbors_per_cell: float = 0.0  # mean points/cell on common area


def dem_of_difference(dsm0: DSM, dsm1: DSM) -> tuple[np.ndarray,
                                                     VolumeReport]:
    """dz grid (dsm1 - dsm0) + volume report on the common valid area.

    Grids must share the same extent/resolution (build both with
    explicit xlim/ylim)."""
    if dsm0.z.shape != dsm1.z.shape:
        raise ValueError("DSM grids must share shape; pass xlim/ylim")
    both = dsm0.mask & dsm1.mask
    dz = np.where(both, dsm1.z - dsm0.z, np.nan)
    cell = dsm0.res * dsm1.res
    add = float(np.nansum(np.where(dz > 0, dz, 0.0)) * cell)
    rem = float(-np.nansum(np.where(dz < 0, dz, 0.0)) * cell)
    area = float(both.sum() * cell)
    mean = float(np.nanmean(dz)) if both.any() else float("nan")
    match_pct, avg_nbr = 100.0, 0.0
    if dsm0.count is not None and dsm1.count is not None:
        obs0 = dsm0.count > 0
        obs1 = dsm1.count > 0
        obs_both = obs0 & obs1
        union = (obs0 | obs1).sum()
        match_pct = float(100.0 * obs_both.sum() / max(union, 1))
        if obs_both.any():
            avg_nbr = float(
                ((dsm0.count + dsm1.count)[obs_both] / 2.0).mean())
    return dz, VolumeReport(added=add, removed=rem, net=add - rem,
                            area=area, mean_dz=mean,
                            matching_percent=match_pct,
                            avg_neighbors_per_cell=avg_nbr)


def save_dsm_npz(dsm: DSM, path) -> None:
    np.savez_compressed(path, z=dsm.z, mask=dsm.mask, xx=dsm.xx,
                        yy=dsm.yy, res=dsm.res)


def save_dsm_geotiff(dsm: DSM, path, crs=None) -> bool:
    """GeoTIFF export when rasterio is available; returns success."""
    try:
        import rasterio
        from rasterio.transform import from_origin
    except ImportError:
        logger.warning("rasterio not available — use save_dsm_npz")
        return False
    tr = from_origin(dsm.xx[0] - dsm.res / 2, dsm.yy[-1] + dsm.res / 2,
                     dsm.res, dsm.res)
    with rasterio.open(
            path, "w", driver="GTiff", height=dsm.z.shape[0],
            width=dsm.z.shape[1], count=1, dtype="float32",
            transform=tr, crs=crs, nodata=np.nan) as dst:
        dst.write(np.flipud(dsm.z).astype(np.float32), 1)
    return True
