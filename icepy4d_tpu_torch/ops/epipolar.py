"""Two-view epipolar estimators for RANSAC, batched over leading dims
(counterpart of `icepy4d_tpu/ops/epipolar.py`): the fundamental and
essential 8-point solvers, Sampson scoring, homographies and the
plane-and-parallax recovery of DEGENSAC, and the essential matrix's
decomposition with its cheirality vote.

Point sets are (..., N, 2) with weights (..., N); a model batch (H, 3, 3)
scores a shared (N, 2) point set by broadcasting, giving (H, N).
"""

from __future__ import annotations

import math

import torch


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def _safe(v: torch.Tensor) -> torch.Tensor:
    """v with values of magnitude under 1e-12 replaced by 1e-12."""
    return torch.where(v.abs() < 1e-12, torch.full_like(v, 1e-12), v)


def hartley_normalization(x: torch.Tensor, w: torch.Tensor):
    """Weighted Hartley normalisation: similarity T with T x of zero mean
    and mean distance sqrt(2). x (..., N, 2), w (..., N) in [0, 1].
    Returns (x normalised (..., N, 2), T (..., 3, 3))."""
    wsum = w.sum(-1).clamp_min(1e-12)[..., None]
    mu = (x * w[..., None]).sum(-2) / wsum                      # (..., 2)
    d = ((x - mu[..., None, :]) ** 2).sum(-1).sqrt()
    mean_d = (d * w).sum(-1) / wsum[..., 0]
    s = math.sqrt(2.0) / mean_d.clamp_min(1e-12)                # (...)
    T = torch.zeros(s.shape + (3, 3), dtype=x.dtype, device=x.device)
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., 0, 2] = -s * mu[..., 0]
    T[..., 1, 2] = -s * mu[..., 1]
    T[..., 2, 2] = 1.0
    return (x - mu[..., None, :]) * s[..., None, None], T


def eight_point(x0: torch.Tensor, x1: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """Weighted normalised 8-point algorithm -> F (..., 3, 3), rank 2,
    scaled to F[2, 2] = 1. w = 0 masks a row."""
    x0n, T0 = hartley_normalization(x0, w)
    x1n, T1 = hartley_normalization(x1, w)
    u0, v0 = x0n[..., 0], x0n[..., 1]
    u1, v1 = x1n[..., 0], x1n[..., 1]
    # constraint rows: x1^T F x0 = 0
    A = torch.stack([u1 * u0, u1 * v0, u1, v1 * u0, v1 * v0, v1, u0, v0,
                     torch.ones_like(u0)], -1) * w[..., None]
    _, V = torch.linalg.eigh(A.mT @ A)          # smallest eigenvector first
    F = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    F = T1.mT @ (U @ torch.diag_embed(S) @ Vh) @ T0
    return F / _safe(F[..., 2, 2])[..., None, None]


def essential_eight_point(x0n: torch.Tensor, x1n: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """8-point on K-normalised coords, projected onto the essential
    manifold (singular values (1, 1, 0))."""
    U, _, Vh = torch.linalg.svd(eight_point(x0n, x1n, w))
    s = torch.tensor([1.0, 1.0, 0.0], dtype=U.dtype, device=U.device)
    return (U * s) @ Vh


def sampson_distance(F: torch.Tensor, x0: torch.Tensor,
                     x1: torch.Tensor) -> torch.Tensor:
    """Squared first-order geometric (Sampson) distance, px^2."""
    x0h, x1h = _homog(x0), _homog(x1)
    Fx0 = x0h @ F.mT
    Ftx1 = x1h @ F
    num = (x1h * Fx0).sum(-1) ** 2
    den = Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 \
        + Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2
    return num / den.clamp_min(1e-12)


def symmetric_epipolar_distance(F: torch.Tensor, x0: torch.Tensor,
                                x1: torch.Tensor) -> torch.Tensor:
    """Symmetric squared point-to-epipolar-line distance, px^2: the
    distance of x1 to F x0 plus that of x0 to F^T x1."""
    x0h, x1h = _homog(x0), _homog(x1)
    Fx0 = x0h @ F.mT
    Ftx1 = x1h @ F
    e2 = (x1h * Fx0).sum(-1) ** 2
    d1 = e2 / (Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2).clamp_min(1e-12)
    d0 = e2 / (Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2).clamp_min(1e-12)
    return d0 + d1


def homography_dlt(x0: torch.Tensor, x1: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Weighted normalised DLT -> H (..., 3, 3) with x1 ~ H x0."""
    x0n, T0 = hartley_normalization(x0, w)
    x1n, T1 = hartley_normalization(x1, w)
    u0, v0 = x0n[..., 0], x0n[..., 1]
    u1, v1 = x1n[..., 0], x1n[..., 1]
    one, zero = torch.ones_like(u0), torch.zeros_like(u0)
    # two constraint rows per point from x1 x (H x0) = 0
    rows_a = torch.stack([u0, v0, one, zero, zero, zero,
                          -u1 * u0, -u1 * v0, -u1], -1)
    rows_b = torch.stack([zero, zero, zero, u0, v0, one,
                          -v1 * u0, -v1 * v0, -v1], -1)
    A = torch.cat([rows_a * w[..., None], rows_b * w[..., None]], -2)
    _, V = torch.linalg.eigh(A.mT @ A)
    H = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    H = torch.linalg.solve(T1, H @ T0)
    return H / _safe(H[..., 2, 2])[..., None, None]


def homography_sym_transfer(H: torch.Tensor, x0: torch.Tensor,
                            x1: torch.Tensor) -> torch.Tensor:
    """Symmetric transfer squared error (px^2) for x1 ~ H x0."""
    x0h, x1h = _homog(x0), _homog(x1)
    Hx0 = x0h @ H.mT
    fwd = Hx0[..., :2] / _safe(Hx0[..., 2:3])
    # a singular hypothesis (a degenerate minimal sample) gives non-finite
    # errors, so no inliers, as jnp.linalg.solve gives them; solve would
    # raise and end the whole match
    Hinv_x1 = torch.linalg.solve_ex(H, x1h.mT)[0].mT
    bwd = Hinv_x1[..., :2] / _safe(Hinv_x1[..., 2:3])
    return ((fwd - x1) ** 2).sum(-1) + ((bwd - x0) ** 2).sum(-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix [v]_x of (..., 3) -> (..., 3, 3)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def parallax_lines(H: torch.Tensor, x0: torch.Tensor,
                   x1: torch.Tensor) -> torch.Tensor:
    """Lines (H x0) x x1 through the epipole e', normalised so |l . e|
    is a point-line distance."""
    lines = torch.linalg.cross(_homog(x0) @ H.mT, _homog(x1), dim=-1)
    return lines / lines[..., :2].norm(dim=-1, keepdim=True).clamp_min(1e-12)


def parallax_sq(H: torch.Tensor, x0: torch.Tensor,
                x1: torch.Tensor) -> torch.Tensor:
    """Squared plane parallax |H x0 - x1|^2 in pixels per point."""
    Hx0 = _homog(x0) @ H.mT
    return ((Hx0[..., :2] / _safe(Hx0[..., 2:3]) - x1) ** 2).sum(-1)


def epipole_from_lines(H: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Weighted least-squares intersection of the parallax line bundle
    (smallest eigenvector of sum w l l^T). With two points of weight 1
    it is their lines' exact intersection, the minimal solver of the
    epipole RANSAC."""
    lines = parallax_lines(H, x0, x1)
    M = torch.einsum("...ni,...nj,...n->...ij", lines, lines, weights)
    return torch.linalg.eigh(M)[1][..., :, 0]


def fundamental_from_homography(H: torch.Tensor, x0: torch.Tensor,
                                x1: torch.Tensor,
                                w_offplane: torch.Tensor) -> torch.Tensor:
    """Plane and parallax: F = [e']_x H, with e' the IRLS intersection of
    the off-plane correspondences' lines (H x0) x x1.

    Lines are weighted by squared parallax, saturated at ~20 px so one
    gross mismatch cannot dominate; two reweighting passes then demote
    lines far from the epipole."""
    lines = parallax_lines(H, x0, x1)
    par2 = parallax_sq(H, x0, x1)
    sat = 20.0 ** 2
    w_offplane = w_offplane * par2 / (1.0 + par2 / sat)

    def solve(w):
        M = torch.einsum("ni,nj,n->ij", lines, lines, w)
        return torch.linalg.eigh(M)[1][:, 0]

    e1 = solve(w_offplane)
    for _ in range(2):
        d = (lines @ e1).abs() / e1[:2].norm().clamp_min(1e-12)
        scale = (d * w_offplane).sum() / w_offplane.sum().clamp_min(1e-12)
        e1 = solve(w_offplane / (1.0 + (d / scale.clamp_min(1e-12)) ** 2))
    F = skew(e1) @ H
    return F / F.abs().max().clamp_min(1e-12)


def decompose_essential(E: torch.Tensor):
    """E (3, 3) -> the 4 candidate poses (Rs (4, 3, 3), ts (4, 3))."""
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))            # proper rotations
    Vh = Vh * torch.sign(torch.linalg.det(Vh))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vh
    R2 = U @ W.mT @ Vh
    t = U[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


# cuSOLVER's batched eigh refuses batches of tens of thousands of 4x4
# matrices (CUSOLVER_STATUS_INVALID_VALUE: chip_smoke.py's SIFT season,
# 4 x ~15000 in the cheirality test, hit it on an H100): point-batched
# systems go through in chunks of this many
EIGH_CHUNK = 16384


def smallest_eigenvector(M: torch.Tensor, chunk: int = EIGH_CHUNK):
    """Eigenvector of the smallest eigenvalue of each symmetric matrix in
    the batch M (..., n, n), in chunks of `chunk` matrices (each
    matrix's eigenvectors do not depend on the chunking)."""
    flat = M.reshape((-1,) + M.shape[-2:])
    vecs = [torch.linalg.eigh(c)[1][..., :, 0] for c in flat.split(chunk)]
    return torch.cat(vecs).reshape(M.shape[:-1])


def _normalise_3d(X: torch.Tensor, w: torch.Tensor):
    """Weighted similarity T (..., 4, 4) taking X (..., N, 3) to zero
    mean and mean distance sqrt(3)."""
    wsum = w.sum(-1).clamp_min(1e-12)[..., None]
    mu = (X * w[..., None]).sum(-2) / wsum                      # (..., 3)
    d = ((X - mu[..., None, :]) ** 2).sum(-1).sqrt()
    s = math.sqrt(3.0) / ((d * w).sum(-1) / wsum[..., 0]).clamp_min(1e-12)
    T = torch.zeros(s.shape + (4, 4), dtype=X.dtype, device=X.device)
    for i in range(3):
        T[..., i, i] = s
        T[..., i, 3] = -s * mu[..., i]
    T[..., 3, 3] = 1.0
    return T


def pnp_dlt(pts3d: torch.Tensor, pts2d_n: torch.Tensor,
            w: torch.Tensor):
    """Weighted DLT PnP from >= 6 points, batched over leading dims.

    pts3d (..., N, 3) world points, pts2d_n (..., N, 2) K-normalised
    observations, w (..., N) row weights (w = 0 drops a row). Both point
    sets are first normalised by weighted similarities (zero mean, mean
    distance sqrt(3) and sqrt(2)); P = [R | t] up to scale is then the
    smallest eigenvector of the 2N x 12 system's normal matrix, mapped
    back through the two similarities. Its sign makes the weighted mean
    depth positive, its scale gives the left 3x3 block the Frobenius
    norm of a rotation, and that block is projected onto SO(3) by SVD.
    (The JAX package solves the system on the raw coordinates: in
    float32 at tens of metres that loses the pose, ROADMAP section 3.)
    Returns (R (..., 3, 3), t (..., 3)) with x_cam = R X + t.
    """
    T3 = _normalise_3d(pts3d, w)
    xn, T2 = hartley_normalization(pts2d_n, w)
    X = _homog(pts3d) @ T3.mT                                  # (..., N, 4)
    zeros = torch.zeros_like(X)
    u, v = xn[..., 0:1], xn[..., 1:2]
    rows_u = torch.cat([X, zeros, -u * X], -1)                 # (..., N, 12)
    rows_v = torch.cat([zeros, X, -v * X], -1)
    A = torch.cat([rows_u * w[..., None], rows_v * w[..., None]], -2)
    _, V = torch.linalg.eigh(A.mT @ A)
    P = torch.linalg.solve(T2, V[..., :, 0].reshape(V.shape[:-2] + (3, 4))
                           @ T3)
    depths = _homog(pts3d) @ P[..., 2, :, None]                 # (..., N, 1)
    sgn = torch.sign((depths[..., 0] * w).sum(-1) + 1e-12)
    P = P * sgn[..., None, None]
    M = P[..., :3]
    scale = math.sqrt(3.0) / torch.linalg.matrix_norm(M).clamp_min(1e-12)
    M = M * scale[..., None, None]
    t = P[..., 3] * scale[..., None]
    U, _, Vh = torch.linalg.svd(M)
    d = torch.ones(U.shape[:-1], dtype=U.dtype, device=U.device)
    d[..., 2] = torch.linalg.det(U @ Vh)
    return (U * d[..., None, :]) @ Vh, t


def _cheirality_depths(R: torch.Tensor, t: torch.Tensor, x0n: torch.Tensor,
                       x1n: torch.Tensor):
    """Depths (z0, z1) of the homogeneous DLT triangulation of each
    correspondence for P0 = [I | 0], P1 = [R | t] (batched over leading
    dims of R and t); x*n are K-normalised (N, 2) coords."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    P0 = torch.cat([eye, torch.zeros_like(t)[..., None]], -1)
    P1 = torch.cat([R, t[..., None]], -1)
    P0, P1 = P0[..., None, :, :], P1[..., None, :, :]   # (..., 1, 3, 4)
    A = torch.stack([x0n[..., 0, None] * P0[..., 2, :] - P0[..., 0, :],
                     x0n[..., 1, None] * P0[..., 2, :] - P0[..., 1, :],
                     x1n[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
                     x1n[..., 1, None] * P1[..., 2, :] - P1[..., 1, :]], -2)
    X = smallest_eigenvector(A.mT @ A)                   # (..., N, 4)
    X = X / _safe(X[..., 3:])
    z1 = (X[..., :3] * R[..., None, 2, :]).sum(-1) + t[..., None, 2]
    return X[..., 2], z1


def recover_pose(E: torch.Tensor, x0n: torch.Tensor, x1n: torch.Tensor,
                 w: torch.Tensor):
    """The (R, t) of E with the best weighted cheirality vote (both
    depths positive). Returns (R, t, front mask of the winner)."""
    Rs, ts = decompose_essential(E)
    z0, z1 = _cheirality_depths(Rs, ts, x0n, x1n)      # (4, N)
    front = (z0 > 0) & (z1 > 0)
    best = torch.argmax((front.to(torch.float32) * w).sum(-1))
    return Rs[best], ts[best], front[best]
