"""Dense stereo: fronto-parallel plane sweep, rectified disparity sweep,
left-right consistency.

Counterpart of `icepy4d_tpu/ops/dense.py`. Both sweeps score every
hypothesis with windowed ZNCC (1 - ZNCC, in [0, 2], lower is better)
and stream over the hypotheses, keeping the best cost, its parabola
neighbours and a second best that is not adjacent to it, so memory stays
O(H * W). The subpixel step comes from a parabola through the best cost
and its neighbours.

`disparity_sweep` is the dispatch of the rectified sweep: a CPU tensor
runs `disparity_sweep_plain`, a CUDA tensor launches the hand-written
kernel (`ops/sweep.py`, `csrc/sweep.cu`) and raises if it cannot. The
homography `plane_sweep` has no kernel: it gathers once per plane, as
the JAX package leaves it to XLA.

Small 3x3 algebra runs in float32 numpy on the host; every per-pixel
map runs on the images' device, written elementwise so that no TF32
matmul setting can reach a pixel coordinate.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from icepy4d_tpu_torch.ops import sweep
from icepy4d_tpu_torch.ops.image import bilinear_sample, map_homography

BIG = 2.0   # the largest cost 1 - ZNCC can take; the fill out of bounds


def relative_motion(E0, E1) -> tuple[np.ndarray, np.ndarray]:
    """R, t with x1 = R @ x0 + t from 4x4 world->cam extrinsics."""
    E0 = np.asarray(E0, np.float32)
    E1 = np.asarray(E1, np.float32)
    R = E1[:3, :3] @ E0[:3, :3].T
    t = E1[:3, 3] - R @ E0[:3, 3]
    return R, t


def plane_homography(K0, K1, R, t, depth) -> np.ndarray:
    """Homography mapping reference pixels to secondary pixels for the
    fronto-parallel plane Z = depth in the reference frame."""
    n = np.array([0.0, 0.0, 1.0], np.float32)
    K0 = np.asarray(K0, np.float32)
    plane = np.asarray(R, np.float32) + np.outer(
        np.asarray(t, np.float32), n) / np.float32(depth)
    return np.asarray(K1, np.float32) @ plane @ np.linalg.inv(K0)


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c in float32 with one rounding (float64 product and sum,
    then float32: exact but for a double rounding at most once in ~1e9)."""
    def f64(x):
        return x.to(torch.float64) if torch.is_tensor(x) else float(x)
    return (f64(a) * f64(b) + f64(c)).to(torch.float32)


def _box_sum(p: torch.Tensor, w: int, q: torch.Tensor | None = None):
    """w * w times the (w x w) zero-padded box mean of X = p (or p * q),
    before its last scaling by 1/w: vertical pass, then horizontal.

    The arithmetic is the one the JAX package runs on XLA: each pass
    sums its w taps in order, ((x_0 + x_1) + ...), the division by w is
    a multiplication by float32(1/w), and the centre tap (the one that
    needs no padding) is fused into the sum with an FMA where it is a
    product: x * y for the products, and the vertical sum times 1/w in
    the horizontal pass. The other taps are rounded values.
    """
    r = w // 2
    h, wd = p.shape
    inv = np.float32(1.0) / np.float32(w)
    x = p if q is None else p * q
    xp = F.pad(x, (0, 0, r, r))
    s = None
    for k in range(w):
        if k != r:
            s = xp[k:k + h] if s is None else s + xp[k:k + h]
        elif q is None:
            s = p if s is None else s + p
        else:
            s = x if s is None else _fma(p, q, s)
    vp = F.pad(s * float(inv), (r, r))
    t = None
    for k in range(w):
        if k != r:
            t = vp[:, k:k + wd] if t is None else t + vp[:, k:k + wd]
        else:
            t = s * float(inv) if t is None else _fma(s, inv, t)
    return t


def _box_filter(x: torch.Tensor, w: int) -> torch.Tensor:
    """(w x w) mean filter on (H, W) with zero padding."""
    return _box_sum(x, w) * float(np.float32(1.0) / np.float32(w))


def _mean_var(x: torch.Tensor, w: int, ref=None):
    """Window mean of x, and its variance box(x * x) - m * m; with `ref`
    = (I0, m0), also the covariance box(I0 * x) - m0 * m."""
    inv = np.float32(1.0) / np.float32(w)
    m = _box_sum(x, w) * float(inv)
    var = _fma(_box_sum(x, w, x), inv, -(m * m))
    if ref is None:
        return m, var
    I0, m0 = ref
    return m, var, _fma(_box_sum(I0, w, x), inv, -(m0 * m))


def _ref_stats(I0: torch.Tensor, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference-image window mean and variance (the same for every
    hypothesis)."""
    return _mean_var(I0, w)


def _zncc_cost(I0: torch.Tensor, I1w: torch.Tensor, w: int,
               eps: float = 1e-6, ref_stats=None) -> torch.Tensor:
    """1 - ZNCC over (w x w) windows; in [0, 2], lower is better."""
    m0, v0 = ref_stats if ref_stats is not None else _ref_stats(I0, w)
    _, v1, cov = _mean_var(I1w, w, ref=(I0, m0))
    zncc = cov / torch.sqrt(torch.clamp_min(v0 * v1, eps))
    return 1.0 - torch.clamp(zncc, -1.0, 1.0)


def _streaming_sweep(cost_at, n_hyps: int, shape: tuple,
                     device: torch.device):
    """Streaming argmin over hypotheses with parabola neighbours and a
    second best that excludes the best's neighbours (a subpixel optimum
    between two hypotheses has near-equal adjacent costs, which must not
    fail the uniqueness test).

    cost_at(k) -> (cost (H, W), inbounds (H, W)).
    Returns (best, best_k, c_prev, c_next, second, best_inb).
    """
    def full(value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=device)

    best, c_m, c_p, prev_c, second = (full(BIG) for _ in range(5))
    best_k = full(-1, torch.int32)
    second_k = full(-99, torch.int32)
    best_inb = full(False, torch.bool)
    for k in range(n_hyps):
        c, inb = cost_at(k)
        is_new = c < best
        # the hypothesis right after the best gives the right neighbour
        c_p = torch.where((best_k == k - 1) & ~is_new, c, c_p)
        # the displaced best becomes the second when far from the new
        # best; a cost that is not the best, when far from the best
        disp_ok = (best_k - k).abs() > 1
        take_best = disp_ok & (best < second)
        take_c = disp_ok & (c < second)
        new_second = torch.where(is_new, torch.where(take_best, best, second),
                                 torch.where(take_c, c, second))
        new_second_k = torch.where(
            is_new, torch.where(take_best, best_k, second_k),
            torch.where(take_c, torch.full_like(second_k, k), second_k))
        c_m = torch.where(is_new, prev_c, c_m)
        c_p = torch.where(is_new, BIG, c_p)
        best_k = torch.where(is_new, torch.full_like(best_k, k), best_k)
        best = torch.where(is_new, c, best)
        best_inb = torch.where(is_new, inb, best_inb)
        prev_c, second, second_k = c, new_second, new_second_k
    # a second that ended up adjacent after the best moved is not trusted
    second = torch.where((second_k - best_k).abs() > 1, second, best)
    return best, best_k, c_m, c_p, second, best_inb


def _subpixel_delta(best, best_k, c_m, c_p, n_hyps: int) -> torch.Tensor:
    """Parabolic refinement over the hypothesis index, in [-0.5, 0.5]."""
    denom = c_m - 2.0 * best + c_p
    ok = denom.abs() > 1e-9
    delta = torch.where(ok, 0.5 * (c_m - c_p) / torch.where(ok, denom, 1.0),
                        0.0)
    delta = torch.clamp(delta, -0.5, 0.5)
    interior = (best_k > 0) & (best_k < n_hyps - 1) & (c_m < BIG) \
        & (c_p < BIG)
    return torch.where(interior, delta, 0.0)


def _inverse_depths(depth_min: float, depth_max: float,
                    n_planes: int) -> np.ndarray:
    """Planes uniform in inverse depth, in float32 as jnp.linspace
    computes them: start * (1 - i/n) + stop * i/n, the last one stop."""
    start = np.float32(1.0) / np.float32(depth_max)
    stop = np.float32(1.0) / np.float32(depth_min)
    if n_planes == 1:
        return np.array([start], np.float32)
    div = np.float32(n_planes - 1)
    s = np.arange(n_planes - 1, dtype=np.float32) / div
    out = start * (np.float32(1.0) - s) + stop * s
    return np.append(out, stop).astype(np.float32)


def plane_sweep(I0: torch.Tensor, I1: torch.Tensor, K0, K1, E0, E1,
                depth_min: float, depth_max: float, n_planes: int = 96,
                window: int = 7) -> dict:
    """Sweep fronto-parallel planes; per-pixel depth and validity.

    I0, I1: (H, W) float32 grayscale (undistorted), on one device. K, E:
    3x3 intrinsics and 4x4 world->cam extrinsics. Returns dict with depth
    (H, W) [subpixel, reference frame], cost (H, W) best 1 - ZNCC,
    uniqueness (H, W) best / second best, inbounds (H, W) (the warp
    landed inside I1 at the best plane).
    """
    h, w = I0.shape
    R, t = relative_motion(E0, E1)
    inv_d = _inverse_depths(depth_min, depth_max, n_planes)
    dev = I0.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    stats0 = _ref_stats(I0, window)

    def cost_at(k):
        Hk = plane_homography(K0, K1, R, t, np.float32(1.0) / inv_d[k])
        qx, qy, qz = map_homography(Hk, xs, ys)
        qz = torch.where(qz.abs() < 1e-9, 1e-9, qz)
        x, y = qx / qz, qy / qz
        inb = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
        I1w = bilinear_sample(I1, torch.stack([x, y], -1).reshape(-1, 2))
        c = _zncc_cost(I0, I1w.reshape(h, w), window, ref_stats=stats0)
        return torch.where(inb, c, BIG), inb

    best, best_k, c_m, c_p, second, best_inb = _streaming_sweep(
        cost_at, n_planes, (h, w), dev)
    delta = _subpixel_delta(best, best_k, c_m, c_p, n_planes)
    step = (inv_d[-1] - inv_d[0]) / np.float32(max(n_planes - 1, 1))
    inv_best = float(inv_d[0]) + (best_k.to(torch.float32) + delta) \
        * float(step)
    return {
        "depth": 1.0 / torch.clamp_min(inv_best, 1e-9),
        "cost": best,
        "uniqueness": best / torch.clamp_min(second, 1e-6),
        "inbounds": best_inb & (best_k >= 0),
    }


def depth_to_points(depth: torch.Tensor, K0, E0, mask=None):
    """Unproject a reference-frame depth map (H, W) to WORLD points.

    Returns (points (H*W, 3), valid (H*W,)), on the depth map's device.
    """
    h, w = depth.shape
    dev = depth.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    rays = map_homography(np.linalg.inv(np.asarray(K0, np.float32)), xs, ys)
    Xc = [r * depth for r in rays]
    E0 = np.asarray(E0, np.float32)
    Rcw = E0[:3, :3].T
    C = -Rcw @ E0[:3, 3]
    Xw = torch.stack([Xc[0] * float(Rcw[i, 0]) + Xc[1] * float(Rcw[i, 1])
                      + Xc[2] * float(Rcw[i, 2]) + float(C[i])
                      for i in range(3)], -1).reshape(-1, 3)
    valid = torch.ones((h * w,), dtype=torch.bool, device=dev) \
        if mask is None else mask.reshape(-1)
    return Xw, valid


def sweep_hypotheses(disp_min: float, disp_max: float,
                     n_disp: int) -> tuple[np.float32, np.float32]:
    """(disp_min, step) in float32, step = (disp_max - disp_min) times
    float32(1 / (n_disp - 1)); hypothesis k is fma(k, step, disp_min)."""
    lo = np.float32(disp_min)
    inv = np.float32(1.0) / np.float32(max(n_disp - 1, 1))
    return lo, (np.float32(disp_max) - lo) * inv


def _pad_bucket(disp_min: float, disp_max: float) -> int:
    """Zero padding of the plain sweep's secondary image: every
    |disparity| plus 2, rounded up to a multiple of 64 as the JAX package
    buckets it."""
    raw = int(np.ceil(max(abs(float(disp_max)), abs(float(disp_min))))) + 2
    return ((raw + 63) // 64) * 64


def _shift_costs(I0r: torch.Tensor, I1r: torch.Tensor, disp_min: float,
                 disp_max: float, pad: int, n_disp: int, window: int):
    """cost_at(k) -> (cost, inbounds) of the rectified sweep's hypothesis
    k: I1r shifted by d_k (two slices of the zero-padded image and a
    lerp) scored against I0r, BIG where x - d_k leaves the image."""
    h, w = I0r.shape
    I1p = F.pad(I1r, (pad, pad))
    lo, step = sweep_hypotheses(disp_min, disp_max, n_disp)
    disps = _fma(torch.arange(n_disp, dtype=torch.float32), step,
                 lo).numpy()
    xs = torch.arange(w, dtype=torch.float32, device=I0r.device)[None, :]
    stats0 = _ref_stats(I0r, window)

    def cost_at(k):
        d = disps[k]
        off = int(np.floor(d))
        frac = d - np.float32(off)
        base = pad - off   # I1p column of I1r's x = 0, shifted by floor(d)
        a = I1p[:, base - 1:base - 1 + w]
        b = I1p[:, base:base + w]
        I1s = _fma(a, frac, b * float(np.float32(1.0) - frac))
        dx = xs - float(d)
        inb = ((dx >= 0) & (dx <= w - 1)).expand(h, w)
        c = _zncc_cost(I0r, I1s, window, ref_stats=stats0)
        return torch.where(inb, c, BIG), inb

    return cost_at


def disparity_sweep_plain(I0r: torch.Tensor, I1r: torch.Tensor,
                          disp_min: float, disp_max: float, pad: int,
                          n_disp: int = 96, window: int = 7) -> dict:
    """Plain version of the sweep kernel (`csrc/sweep.cu`).

    Every hypothesis is an x-shift of I1r (`_shift_costs`); `pad` must
    exceed every |disparity| by 2.
    """
    h, w = I0r.shape
    lo, step = sweep_hypotheses(disp_min, disp_max, n_disp)
    best, best_k, c_m, c_p, second, best_inb = _streaming_sweep(
        _shift_costs(I0r, I1r, disp_min, disp_max, pad, n_disp, window),
        n_disp, (h, w), I0r.device)
    delta = _subpixel_delta(best, best_k, c_m, c_p, n_disp)
    return {
        "disparity": _fma(best_k.to(torch.float32) + delta, step, lo),
        "cost": best,
        "uniqueness": best / torch.clamp_min(second, 1e-6),
        "inbounds": best_inb & (best_k >= 0),
    }


def runner_up_gap(I0r: torch.Tensor, I1r: torch.Tensor, disp_min: float,
                  disp_max: float, n_disp: int = 96,
                  window: int = 7) -> torch.Tensor:
    """Per pixel, the second smallest of the plain version's costs over
    all hypotheses minus the smallest. Where the gap is within a few
    ulps, a cost that rounds differently in its last bit can flip the
    argmin, so comparisons of two sweeps exclude such near ties."""
    cost_at = _shift_costs(I0r, I1r, disp_min, disp_max,
                           _pad_bucket(disp_min, disp_max), n_disp, window)
    first = torch.full(I0r.shape, BIG, device=I0r.device)
    second = first.clone()
    for k in range(n_disp):
        c, _ = cost_at(k)
        second = torch.minimum(second, torch.maximum(first, c))
        first = torch.minimum(first, c)
    return second - first


def disparity_sweep(I0r: torch.Tensor, I1r: torch.Tensor, disp_min: float,
                    disp_max: float, n_disp: int = 96,
                    window: int = 7) -> dict:
    """Dense matching of a RECTIFIED pair by disparity sweep.

    Disparity d means I0r(x) corresponds to I1r(x - d). Hypotheses are
    disp_min + k * (disp_max - disp_min) / (n_disp - 1). Returns dict of
    (H, W) disparity (subpixel), cost, uniqueness and inbounds.

    A CPU tensor runs `disparity_sweep_plain` (with the JAX package's
    64-px pad bucket), a CUDA tensor launches the sweep kernel.
    """
    if I0r.device.type == "cpu":
        return disparity_sweep_plain(I0r, I1r, disp_min, disp_max,
                                     _pad_bucket(disp_min, disp_max),
                                     n_disp=n_disp, window=window)
    if I0r.device.type != "cuda":
        raise ValueError(f"unsupported device {I0r.device}")
    lo, step = sweep_hypotheses(disp_min, disp_max, n_disp)
    return sweep.disparity_sweep_kernel(I0r, I1r, lo, step, n_disp, window)


def lr_consistency_mask(disp0: torch.Tensor, disp1: torch.Tensor,
                        tau: float = 1.0) -> torch.Tensor:
    """Left-right consistency: x in view 0 with disparity d must map to a
    view-1 pixel whose reverse disparity agrees, |d0(x) + d1(x - d0)| <=
    tau. disp1 is the sweep of the swapped pair over the negated range.
    Returns an (H, W) bool mask for view 0."""
    h, w = disp0.shape
    xs = torch.arange(w, dtype=torch.float32, device=disp0.device)[None, :]
    x1 = xs - disp0                      # where each pixel lands in view 1
    x1c = torch.clamp(x1, 0.0, w - 1.0)
    i0 = torch.floor(x1c).to(torch.int64)
    f = x1c - i0.to(torch.float32)
    d1 = (disp1.gather(1, i0) * (1.0 - f)
          + disp1.gather(1, torch.clamp_max(i0 + 1, w - 1)) * f)
    inb = (x1 >= 0) & (x1 <= w - 1)
    return inb & ((disp0 + d1).abs() <= tau)
