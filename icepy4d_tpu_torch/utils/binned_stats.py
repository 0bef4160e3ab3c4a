"""2-D / 3-D spatial binned statistics (counterpart of
`icepy4d_tpu/utils/binned_stats.py`).

Mean, std and count per cell of scattered values, for the velocity
fields of the 4D products: one scatter-add pass on the device
(`index_add_` into prod(shape) + 1 slots, the last one the dump slot of
points outside the grid); the matplotlib helper runs on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.ops.dense import _fma


def _binned(coords: torch.Tensor, values: torch.Tensor, mins: torch.Tensor,
            res: torch.Tensor, shape: tuple):
    """(mean, std, count) grids of `shape` from (N, D) coords and (N,)
    values; mean and std from the first and second sums (the variance's
    s2 / n - mean^2 with one rounding, as XLA contracts it)."""
    idx = torch.floor((coords - mins) / res).to(torch.int64)
    ok = ((idx >= 0) & (idx < torch.as_tensor(shape, device=idx.device))
          ).all(1) & torch.isfinite(values) & torch.isfinite(coords).all(1)
    strides = np.concatenate(
        [np.cumprod(shape[::-1])[:-1][::-1], [1]]).astype(np.int64)
    size = int(np.prod(shape))
    lin = torch.where(ok, (idx * torch.as_tensor(strides, device=idx.device)
                           ).sum(1), size)
    okf = ok.to(torch.float32)
    v = torch.where(ok, values, 0.0)
    cnt = torch.zeros(size + 1, device=coords.device).index_add_(0, lin, okf)
    s1 = torch.zeros(size + 1, device=coords.device).index_add_(0, lin, v)
    s2 = torch.zeros(size + 1, device=coords.device).index_add_(0, lin, v * v)
    cntc = cnt[:-1].clamp_min(1.0)
    mean = s1[:-1] / cntc
    var = _fma(-mean, mean, s2[:-1] / cntc).clamp_min(0.0)
    return (mean.reshape(shape), torch.sqrt(var).reshape(shape),
            cnt[:-1].reshape(shape))


def binned_statistic(
    coords: np.ndarray,
    values: np.ndarray,
    step: float | tuple,
    bounds: list[tuple] | None = None,
    device=None,
) -> dict:
    """Bin scattered `values` at `coords` (N, D) into a D-dim grid on
    `device` (None: the card).

    Returns dict(mean, std, count, edges) with NaN where empty."""
    dev = resolve_device(device)
    coords = np.asarray(coords, np.float32)
    values = np.asarray(values, np.float32).reshape(-1)
    nd = coords.shape[1]
    step = np.broadcast_to(np.asarray(step, np.float32), (nd,))
    if bounds is None:
        bounds = [(float(np.nanmin(coords[:, d])),
                   float(np.nanmax(coords[:, d]))) for d in range(nd)]
    mins = np.asarray([b[0] for b in bounds], np.float32)
    shape = tuple(max(int(np.ceil((b[1] - b[0]) / s)), 1)
                  for b, s in zip(bounds, step))
    mean, std, cnt = (t.cpu().numpy() for t in _binned(
        torch.from_numpy(coords).to(dev), torch.from_numpy(values).to(dev),
        torch.from_numpy(mins).to(dev),
        torch.from_numpy(step.copy()).to(dev), shape))
    mean[cnt == 0] = np.nan
    std[cnt == 0] = np.nan
    edges = [mins[d] + np.arange(shape[d] + 1) * step[d]
             for d in range(nd)]
    return {"mean": mean, "std": std, "count": cnt, "edges": edges}


def plot_binned_stat(stat: dict, ax=None, what: str = "mean",
                     cmap: str = "viridis", **imshow_kw):
    """Show a 2-D binned statistic (host, matplotlib)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    ex, ey = stat["edges"][:2]
    im = ax.imshow(stat[what].T, origin="lower", cmap=cmap,
                   extent=[ex[0], ex[-1], ey[0], ey[-1]], **imshow_kw)
    ax.figure.colorbar(im, ax=ax, label=what)
    return ax
