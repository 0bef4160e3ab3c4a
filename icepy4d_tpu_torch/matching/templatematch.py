"""FFT orientation-correlation (OC) template matching (counterpart of
`icepy4d_tpu/matching/templatematch.py`).

Every point's template and search window are gathered at once and the
batch goes through one batched 2-D FFT cross-correlation with
`torch.fft` on the tensors' device (the JAX package runs the same as an
XLA program):

  * orientation images: f = conv2(img, [[1,0,i],[0,0,0],[-i,0,-1]]),
    normalised to unit magnitude;
  * correlation of the template (rotated 180 degrees) with the
    conjugate search window through a zero-padded FFT;
  * the peak gives the integer displacement; sub-pixel by a thresholded
    weighted centroid over +-min(edge distance, 4);
  * SNR = peak / mean |correlation|; peaks on the domain's edge fail.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from icepy4d_tpu_torch.device import resolve_device


@dataclass
class MatchResult:
    """Tracking results: template centres (pu, pv), displacements
    (du, dv; NaN where tracking failed), peak and mean |correlation|."""

    pu: np.ndarray
    pv: np.ndarray
    du: np.ndarray
    dv: np.ndarray
    peakCorr: np.ndarray
    meanAbsCorr: np.ndarray
    method: str = "OC"

    @property
    def snr(self) -> np.ndarray:
        return self.peakCorr / self.meanAbsCorr


def forient(img: torch.Tensor) -> torch.Tensor:
    """Complex orientation image (complex64) of a 2-D image."""
    img = img.to(torch.float32)
    k = img.new_tensor([[[[1.0, 0.0, 0.0], [0.0, 0.0, 0.0],
                          [0.0, 0.0, -1.0]]],
                        [[[0.0, 0.0, 1.0], [0.0, 0.0, 0.0],
                          [-1.0, 0.0, 0.0]]]])
    ri = F.conv2d(img[None, None], k, padding=1)[0]
    r = torch.complex(ri[0], ri[1])
    m = r.abs()
    return r / torch.where(m == 0, 1.0, m)


def _windows(img: torch.Tensor, origin: torch.Tensor, size: int):
    """(N, size, size) windows of img at the (row, col) origins."""
    off = torch.arange(size, device=img.device)
    rows = origin[:, 0, None, None] + off[None, :, None]
    cols = origin[:, 1, None, None] + off[None, None, :]
    return img[rows, cols]


def _oc_correlate(A_or: torch.Tensor, B_or: torch.Tensor,
                  a_center: torch.Tensor, b_center: torch.Tensor,
                  valid: torch.Tensor, tw: int, sw: int):
    """Batched OC correlation. Centres (N, 2) int [u, v]. Returns (du,
    dv, peak, mean_abs, ok) relative to the window centres."""
    ha, wa = A_or.shape
    hb, wb = B_or.shape
    a0 = torch.stack([a_center[:, 1] - tw // 2, a_center[:, 0] - tw // 2], -1)
    b0 = torch.stack([b_center[:, 1] - sw // 2, b_center[:, 0] - sw // 2], -1)
    in_a = ((a0[:, 0] >= 0) & (a0[:, 1] >= 0)
            & (a0[:, 0] + tw <= ha) & (a0[:, 1] + tw <= wa))
    in_b = ((b0[:, 0] >= 0) & (b0[:, 1] >= 0)
            & (b0[:, 0] + sw <= hb) & (b0[:, 1] + sw <= wb))
    ok = valid & in_a & in_b
    a0c = torch.stack([a0[:, 0].clamp(0, ha - tw), a0[:, 1].clamp(0, wa - tw)],
                      -1)
    b0c = torch.stack([b0[:, 0].clamp(0, hb - sw), b0[:, 1].clamp(0, wb - sw)],
                      -1)
    tmpl = _windows(A_or, a0c, tw)
    srch = _windows(B_or, b0c, sw)

    # zero-padded FFT cross-correlation: rot180(template) * conj(search)
    sz = sw + tw - 1
    fT = torch.fft.fft2(torch.flip(tmpl, (1, 2)), s=(sz, sz))
    fB = torch.fft.fft2(torch.conj(srch), s=(sz, sz))
    CC = torch.fft.ifft2(fB * fT).real                       # (N, sz, sz)

    # the central region, free of edge effects
    wkeep = (sw - tw) // 2
    cc0 = (sz - 1) // 2 - wkeep
    n_keep = 2 * wkeep + 1
    C = CC[:, cc0:cc0 + n_keep, cc0:cc0 + n_keep]

    flat = C.reshape(C.shape[0], -1)
    idx = flat.argmax(1)
    peak = torch.gather(flat, 1, idx[:, None])[:, 0]
    mean_abs = C.abs().mean((1, 2))
    iy = idx // n_keep
    ix = idx % n_keep
    edge = torch.minimum(torch.minimum(iy, ix),
                         torch.minimum(n_keep - 1 - iy, n_keep - 1 - ix))
    ok = ok & (edge > 0)

    # sub-pixel: thresholded weighted centroid over +-ww, ww = min(edge, 4)
    ww = edge.clamp_max(4)
    offs = torch.arange(-4, 5, device=C.device)
    oy = offs[:, None].expand(9, 9)
    ox = offs[None, :].expand(9, 9)
    yy = (iy[:, None, None] + oy).clamp(0, n_keep - 1)
    xx = (ix[:, None, None] + ox).clamp(0, n_keep - 1)
    n = C.shape[0]
    c = C[torch.arange(n, device=C.device)[:, None, None], yy, xx]
    msk = (oy.abs() <= ww[:, None, None]) & (ox.abs() <= ww[:, None, None])
    c = torch.where(msk, c, 0.0)
    nm = msk.sum((1, 2))
    c = c - (c.abs().sum((1, 2)) / nm.clamp_min(1))[:, None, None] * msk
    c = c.clamp_min(0.0)
    ssum = c.sum((1, 2)).clamp_min(1e-12)
    dv = ((iy[:, None, None] + oy - wkeep) * c).sum((1, 2)) / ssum
    du = ((ix[:, None, None] + ox - wkeep) * c).sum((1, 2)) / ssum
    return du, dv, peak, mean_abs, ok


def oc_track(A_or: torch.Tensor, B_or: torch.Tensor, xy: np.ndarray,
             template_width: int = 128, search_width: int = 144,
             initialdu=0.0, initialdv=0.0) -> MatchResult:
    """Batched OC tracking of the `xy` points (n, 2) of image A into B,
    given their orientation images (`forient`, once an image)."""
    xy = np.asarray(xy, np.float64).reshape(-1, 2)
    n = len(xy)
    initdu = np.broadcast_to(np.asarray(initialdu, np.float64), (n,)).copy()
    initdv = np.broadcast_to(np.asarray(initialdv, np.float64), (n,)).copy()
    valid_in = np.isfinite(xy).all(axis=1)
    p = np.where(valid_in[:, None], xy, 0.0)
    a_center = np.round(p).astype(np.int64)
    b_center = np.round(p + np.stack([initdu, initdv], -1)).astype(np.int64)
    act_du = (b_center[:, 0] - a_center[:, 0]).astype(np.float64)
    act_dv = (b_center[:, 1] - a_center[:, 1]).astype(np.float64)

    dev = A_or.device
    du_, dv_, peak, mean_abs, ok = (
        t.cpu().numpy() for t in _oc_correlate(
            A_or, B_or, torch.from_numpy(a_center).to(dev),
            torch.from_numpy(b_center).to(dev),
            torch.from_numpy(valid_in).to(dev),
            int(template_width), int(search_width)))
    return MatchResult(
        pu=a_center[:, 0].astype(np.float64),
        pv=a_center[:, 1].astype(np.float64),
        du=np.where(ok, du_ + act_du, np.nan),
        dv=np.where(ok, dv_ + act_dv, np.nan),
        peakCorr=np.where(ok, peak, np.nan),
        meanAbsCorr=mean_abs)


class TemplateMatch:
    """Track points from image A into image B with OC.

    xy (n, 2) pixel coordinates in A; match() returns a MatchResult with
    du / dv displacements (NaN where tracking failed). Runs on the card
    unless `device="cpu"`.
    """

    available_methods = ["OC"]

    def __init__(self, A: np.ndarray, B: np.ndarray, xy: np.ndarray,
                 method: str = "OC", template_width: int = 128,
                 search_width: int = 128 + 16, initialdu: float = 0.0,
                 initialdv: float = 0.0, single_points: bool = True,
                 device=None) -> None:
        if A.ndim != 2 or B.ndim != 2:
            raise ValueError("Provide grayscale images")
        if method not in self.available_methods:
            raise ValueError(f"Invalid method {method}")
        self.device = resolve_device(device)
        self.A = A
        self.B = B
        self.xy = np.asarray(xy, np.float64).reshape(-1, 2)
        self.method = method
        self.template_width = int(template_width)
        self.search_width = int(search_width)
        self.initialdu = initialdu
        self.initialdv = initialdv
        self.result: MatchResult | None = None

    def match(self) -> MatchResult:
        def orient(img):
            return forient(torch.as_tensor(np.asarray(img, np.float32),
                                           device=self.device))

        self.result = oc_track(
            orient(self.A), orient(self.B), self.xy,
            template_width=self.template_width,
            search_width=self.search_width,
            initialdu=self.initialdu, initialdv=self.initialdv)
        return self.result
