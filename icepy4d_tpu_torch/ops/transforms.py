"""Rigid and similarity transform math on tensors.

Counterpart of `icepy4d_tpu/ops/transforms.py`: static-xyz Euler angles
(omega, phi, kappa), quaternions (w, x, y, z), Rodrigues vectors, the
Umeyama similarity, and the 7-parameter Helmert refinement by
Gauss-Newton. Functions are batched over leading dimensions where the
JAX package's are, and written without in-place updates so that
`torch.func` transforms (vmap, jacfwd) run through them.
"""

from __future__ import annotations

import torch


def _mat3(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


# -- Euler angles ('sxyz') ---------------------------------------------------

def euler_matrix(ai, aj, ak) -> torch.Tensor:
    """R = Rz(ak) @ Ry(aj) @ Rx(ai) from static-xyz Euler angles."""
    si, sj, sk = torch.sin(ai), torch.sin(aj), torch.sin(ak)
    ci, cj, ck = torch.cos(ai), torch.cos(aj), torch.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    return _mat3([[cj * ck, sj * sc - cs, sj * cc + ss],
                  [cj * sk, sj * ss + cc, sj * cs - sc],
                  [-sj, cj * si, cj * ci]])


def euler_from_matrix(R: torch.Tensor, eps: float = 1e-8):
    """Static-xyz Euler angles (ax, ay, az) of R (inverse of above)."""
    cy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    safe = cy > eps
    ax = torch.where(safe, torch.atan2(R[..., 2, 1], R[..., 2, 2]),
                     torch.atan2(-R[..., 1, 2], R[..., 1, 1]))
    ay = torch.atan2(-R[..., 2, 0], cy)
    az = torch.where(safe, torch.atan2(R[..., 1, 0], R[..., 0, 0]),
                     torch.zeros_like(cy))
    return ax, ay, az


# -- quaternions (w, x, y, z) ------------------------------------------------

def quaternion_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion, branch-free: the four
    candidate square roots, selected by the largest diagonal
    combination."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw0 = torch.sqrt((1.0 + tr).clamp_min(1e-12)) / 2.0
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], -1)
    s1 = torch.sqrt((1.0 + m00 - m11 - m22).clamp_min(1e-12)) * 2
    q1 = torch.stack([(m21 - m12) / s1, s1 / 4, (m01 + m10) / s1,
                      (m02 + m20) / s1], -1)
    s2 = torch.sqrt((1.0 - m00 + m11 - m22).clamp_min(1e-12)) * 2
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, s2 / 4,
                      (m12 + m21) / s2], -1)
    s3 = torch.sqrt((1.0 - m00 - m11 + m22).clamp_min(1e-12)) * 2
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      s3 / 4], -1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1,
                                           torch.where(cond2, q2, q3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def matrix_from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q.unbind(-1)
    return _mat3([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


# -- Rodrigues (axis-angle) --------------------------------------------------

def rodrigues_to_matrix(rvec: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3); identity below
    `eps` radians."""
    theta = torch.linalg.norm(rvec, dim=-1, keepdim=True)
    k = rvec / torch.where(theta < eps, torch.ones_like(theta), theta)
    kx, ky, kz = k.unbind(-1)
    zero = torch.zeros_like(kx)
    K = _mat3([[zero, -kz, ky], [kz, zero, -kx], [-ky, kx, zero]])
    th = theta[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    R = eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)
    return torch.where(th < eps, eye, R)


def matrix_to_rodrigues(R: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rotation matrix -> axis-angle through the quaternion, exact for
    all angles (the antisymmetric-part formula collapses at pi)."""
    q = quaternion_from_matrix(R)
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)    # w >= 0: theta in [0, pi]
    w, xyz = q[..., 0], q[..., 1:]
    n = torch.linalg.norm(xyz, dim=-1)
    theta = 2.0 * torch.atan2(n, w)
    scale = torch.where(n < eps, 2.0,
                        theta / torch.where(n < eps, torch.ones_like(n), n))
    return xyz * scale[..., None]


# -- Umeyama similarity ------------------------------------------------------

def similarity_from_points(v0: torch.Tensor, v1: torch.Tensor,
                           with_scale: bool = True,
                           weights: torch.Tensor | None = None) -> torch.Tensor:
    """Least-squares similarity T (4x4) with v1 ~= T @ v0 (Umeyama's SVD
    method). v0, v1: (N, 3)."""
    w = torch.ones_like(v0[:, 0]) if weights is None else weights.to(v0.dtype)
    wsum = w.sum().clamp_min(1e-12)
    mu0 = (v0 * w[:, None]).sum(0) / wsum
    mu1 = (v1 * w[:, None]).sum(0) / wsum
    x0, x1 = v0 - mu0, v1 - mu1
    cov = (x1 * w[:, None]).mT @ x0 / wsum
    U, S, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    R = U @ D @ Vt
    var0 = (w[:, None] * x0 * x0).sum() / wsum
    s = (S[0] + S[1] + S[2] * d) / var0.clamp_min(1e-12) if with_scale \
        else torch.ones_like(d)
    t = mu1 - s * (R @ mu0)
    top = torch.cat([s * R, t[:, None]], 1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=v0.dtype,
                          device=v0.device)
    return torch.cat([top, bottom], 0)


def apply_transform(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to (N, 3) points."""
    return points @ T[:3, :3].mT + T[:3, 3]


# -- Helmert -----------------------------------------------------------------

def helmert_params_to_matrix(params: torch.Tensor) -> torch.Tensor:
    """7-parameter Helmert (rx, ry, rz, tx, ty, tz, m) -> T = [m R | t]."""
    R = euler_matrix(params[0], params[1], params[2])
    top = torch.cat([params[6] * R, params[3:6, None]], 1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=params.dtype,
                          device=params.device)
    return torch.cat([top, bottom], 0)


def helmert_residuals(params: torch.Tensor, v0: torch.Tensor,
                      v1: torch.Tensor,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted residuals v1 - T(params) @ v0, flattened."""
    r = v1 - apply_transform(helmert_params_to_matrix(params), v0)
    if weights is not None:
        r = r * weights
    return r.reshape(-1)


def refine_similarity_gauss_newton(T0: torch.Tensor, v0: torch.Tensor,
                                   v1: torch.Tensor, iters: int = 10,
                                   weights: torch.Tensor | None = None
                                   ) -> torch.Tensor:
    """Refine a similarity by `iters` Gauss-Newton steps on the 7
    Helmert parameters (Jacobians by forward-mode differentiation, a 7x7
    normal system)."""
    R0 = T0[:3, :3]
    s0 = torch.linalg.det(R0).clamp_min(1e-12) ** (1.0 / 3.0)
    ax, ay, az = euler_from_matrix(R0 / s0)
    p = torch.stack([ax, ay, az, T0[0, 3], T0[1, 3], T0[2, 3], s0])
    jac = torch.func.jacfwd(helmert_residuals)
    eye = 1e-9 * torch.eye(7, dtype=p.dtype, device=p.device)
    for _ in range(iters):
        r = helmert_residuals(p, v0, v1, weights)
        J = jac(p, v0, v1, weights)
        p = p - torch.linalg.solve(J.mT @ J + eye, J.mT @ r)
    return helmert_params_to_matrix(p)
