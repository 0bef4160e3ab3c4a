"""Two-view triangulation and bilinear sampling, batched over points.

Counterpart of `icepy4d_tpu/ops/triangulation.py`. P are 3x4 projection
matrices K [R | t]; image points are (N, 2) tensors. Each point's small
system is one entry of a batch: the 4x4 homogeneous systems go through
batched `torch.linalg.eigh` (in chunks, `epipolar.EIGH_CHUNK`), the 3x3
normal equations of the iterative solver through one batched
`torch.linalg.solve` (LU with partial pivoting, as the JAX package's
`jnp.linalg.solve`) per iteration.
"""

from __future__ import annotations

import torch

from icepy4d_tpu_torch.ops.epipolar import smallest_eigenvector


def _dlt_system_two_view(u0: torch.Tensor, u1: torch.Tensor,
                         P0: torch.Tensor, P1: torch.Tensor) -> torch.Tensor:
    """(N, 4, 4) homogeneous DLT rows, one system per correspondence."""
    return torch.stack([u0[:, 0, None] * P0[2] - P0[0],
                        u0[:, 1, None] * P0[2] - P0[1],
                        u1[:, 0, None] * P1[2] - P1[0],
                        u1[:, 1, None] * P1[2] - P1[1]], 1)


def _safe(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v.abs() < 1e-12, 1e-12, v)


def linear_eigen_triangulation(u0, u1, P0, P1) -> torch.Tensor:
    """Homogeneous DLT: smallest eigenvector of A^T A per point.
    Returns (N, 3)."""
    A = _dlt_system_two_view(u0, u1, P0, P1)
    X = smallest_eigenvector(A.mT @ A)
    return X[:, :3] / _safe(X[:, 3:])


def linear_ls_triangulation(u0, u1, P0, P1) -> torch.Tensor:
    """Inhomogeneous linear LS triangulation: the first three columns of
    the DLT rows against minus the fourth, solved through the 3x3 normal
    equations per point. Returns (N, 3)."""
    S = _dlt_system_two_view(u0, u1, P0, P1)
    A, rhs = S[..., :3], -S[..., 3]
    AtA = A.mT @ A + 1e-12 * torch.eye(3, dtype=S.dtype, device=S.device)
    return torch.linalg.solve(AtA, A.mT @ rhs[..., None])[..., 0]


def triangulate_nview(us: torch.Tensor, Ps: torch.Tensor,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """N-view DLT: us (V, N, 2) observations, Ps (V, 3, 4), mask (V, N)
    (False: the view does not see the point, its rows are zero). The
    smallest eigenvector of each point's 4x4 normal matrix (in chunks,
    `epipolar.EIGH_CHUNK`). Returns (N, 3)."""
    if mask is None:
        mask = torch.ones(us.shape[:2], dtype=torch.bool, device=us.device)
    w = mask.to(us.dtype)[..., None]                            # (V, N, 1)
    r0 = (us[..., 0, None] * Ps[:, None, 2] - Ps[:, None, 0]) * w
    r1 = (us[..., 1, None] * Ps[:, None, 2] - Ps[:, None, 1]) * w
    # rows in the JAX package's order: view 0's two rows, view 1's, ...
    A = torch.stack([r0, r1], 1).permute(2, 0, 1, 3).reshape(
        us.shape[1], -1, 4)                                     # (N, 2V, 4)
    X = smallest_eigenvector(A.mT @ A)
    return X[:, :3] / _safe(X[:, 3:])


def iterative_ls_triangulation(u0, u1, P0, P1, iters: int = 10,
                               tolerance: float = 1.0e-4):
    """Hartley-Sturm iteratively reweighted linear LS triangulation.

    Each of the `iters` fixed iterations reweights the DLT rows by the
    inverse projective depths of the current estimate, so the residual
    approximates image-plane error. A point converged when both depths
    moved by at most `tolerance` of their value in the last iteration;
    status = 1 iff it converged and lies in front of both cameras.
    Returns (points (N, 3), status (N,) int32).
    """
    S = _dlt_system_two_view(u0, u1, P0, P1)
    A0, b0 = S[..., :3], -S[..., 3]
    reg = 1e-12 * torch.eye(3, dtype=S.dtype, device=S.device)

    def solve(A, b):
        return torch.linalg.solve(A.mT @ A + reg,
                                  (A.mT @ b[..., None]))[..., 0]

    def depths(x):
        return x @ P0[2, :3] + P0[2, 3], x @ P1[2, :3] + P1[2, 3]

    x = solve(A0, b0)
    w0 = w1 = torch.ones_like(x[:, 0])
    conv = torch.zeros_like(w0, dtype=torch.bool)
    for _ in range(iters):
        d0, d1 = depths(x)
        conv = ((w0 - d0).abs() <= tolerance * d0.abs()) \
            & ((w1 - d1).abs() <= tolerance * d1.abs())
        w0, w1 = _safe(d0), _safe(d1)
        w = torch.stack([1.0 / w0, 1.0 / w0, 1.0 / w1, 1.0 / w1], -1)
        x = solve(A0 * w[..., None], b0 * w)
    d0, d1 = depths(x)
    return x, (conv & (d0 > 0) & (d1 > 0)).to(torch.int32)


def interpolate_bilinear(image: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample `image` (H, W[, C]) at pixel coords xy (N, 2);
    coordinates outside the image clamp to the border."""
    chan = image.ndim == 3
    img = image if chan else image[..., None]
    H, W = img.shape[:2]
    x = xy[..., 0].clamp(0.0, W - 1.000001)
    y = xy[..., 1].clamp(0.0, H - 1.000001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = (x0 + 1).clamp_max(W - 1)
    y1 = (y0 + 1).clamp_max(H - 1)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    out = (img[y0, x0] * (1 - wx) * (1 - wy) + img[y0, x1] * wx * (1 - wy)
           + img[y1, x0] * (1 - wx) * wy + img[y1, x1] * wx * wy)
    return out if chan else out[..., 0]
