"""Sparse Levenberg-Marquardt bundle adjustment with Schur elimination.

Counterpart of `icepy4d_tpu/ops/ba.py`: `lm_solve`, `lm_solve_batched`
and `point_covariances`. Observations live on a
dense (P points x C cameras) grid with validity weights. The Jacobian
of each observation's residual comes from `torch.func.jacfwd` of the
full OpenCV projection (rational distortion), vmapped over the
flattened grid. Point blocks are eliminated through the Schur
complement, the reduced camera system (C * B unknowns, B = 6 + free
intrinsics) is solved densely, and point updates are back-substituted.

The JAX package runs the LM loop as one `lax.while_loop`; here it is a
Python loop on the device that reads its stop flag once per iteration.
Products run in full float32 (TF32 off) whatever the caller set.

Weighting follows Metashape's accuracy semantics: projections weighted
by 1/sigma_px, marker world locations by 1/sigma_m (point priors),
camera centres by 1/sigma_m (pose priors); a Huber band turns on IRLS
reweighting of the observations.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from icepy4d_tpu_torch.device import full_f32_matmul
from icepy4d_tpu_torch.ops.geometry import distort_normalized
from icepy4d_tpu_torch.ops.transforms import rodrigues_to_matrix

# the intrinsic vector: [fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, k5, k6]
N_INTR = 12


class BAProblem(NamedTuple):
    """BA problem on a (P, C) observation grid, as tensors."""

    cam_theta: torch.Tensor    # (C, 6) [rvec, tvec] world -> camera
    intrinsics: torch.Tensor   # (C, 12) [fx, fy, cx, cy, dist8]
    points: torch.Tensor       # (P, 3)
    obs_xy: torch.Tensor       # (P, C, 2) pixel observations
    obs_w: torch.Tensor        # (P, C) 1/sigma_px; 0 = missing
    pt_prior: torch.Tensor     # (P, 3) world priors (markers)
    pt_prior_w: torch.Tensor   # (P,) 1/sigma_m; 0 = no prior
    cam_prior: torch.Tensor    # (C, 3) camera-centre priors
    cam_prior_w: torch.Tensor  # (C,) 1/sigma_m; 0 = no prior
    cam_fixed: torch.Tensor    # (C,) bool: freeze these cameras' poses

    @classmethod
    def from_numpy(cls, device, **leaves) -> "BAProblem":
        """A problem from numpy leaves named as the fields (the leaves of
        a JAX `BAProblem` carry across as they are)."""
        out = {}
        for name in cls._fields:
            a = np.asarray(leaves[name])
            out[name] = torch.from_numpy(
                a.astype(bool if name == "cam_fixed" else np.float32)
            ).to(device)
        return cls(**out)


class BAResult(NamedTuple):
    cam_theta: torch.Tensor
    intrinsics: torch.Tensor
    points: torch.Tensor
    cost: torch.Tensor          # 0.5 * sum of weighted r^2 (Huber objective
    initial_cost: torch.Tensor  # with a robust band)
    iterations: int
    lam: torch.Tensor


def _intrinsics(theta, intr_base, free_intr: tuple):
    """The intrinsic vector with the free entries taken from the packed
    parameters theta[6:] (a new tensor; nothing is written in place)."""
    if not free_intr:
        return intr_base
    return torch.stack([theta[6 + free_intr.index(i)] if i in free_intr
                        else intr_base[i] for i in range(N_INTR)])


def _project_resid(theta, X, intr_base, xy, w, free_intr: tuple):
    """Weighted 2-vector reprojection residual of one observation.

    xn is clamped to |xn| <= 32: a point near a non-observing camera's
    principal plane would overflow the distortion polynomial, and
    0 * inf poisons the normal equations; masked rows are exactly 0."""
    intr = _intrinsics(theta, intr_base, free_intr)
    Xc = rodrigues_to_matrix(theta[:3]) @ X + theta[3:6]
    # no 0-d intermediates: under forward-mode differentiation, Python
    # scalars combined with 0-d tensors give tangents of the default
    # (double) dtype, so z and the distortion terms keep a length-1 axis
    z = Xc[2:3]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    xn = (Xc[:2] / z).clamp(-32.0, 32.0)
    xd = distort_normalized(xn[None], intr[None, 4:])[0]
    px = intr[:2] * xd + intr[2:4]
    return torch.where(w > 0, (px - xy) * w, torch.zeros_like(xy))


def _center_resid(theta, prior, w):
    """Weighted camera-centre prior residual (3,)."""
    center = -rodrigues_to_matrix(theta[:3]).mT @ theta[3:6]
    return (center - prior) * w


def _huber_rho(sq_norm, delta: float):
    """Huber loss of a squared residual norm."""
    n = sq_norm.clamp_min(1e-24).sqrt()
    return torch.where(n <= delta, sq_norm, 2.0 * delta * n - delta ** 2)


def _huber_irls_weight(sq_norm, delta: float):
    """sqrt(rho'(r)): 1 inside the band, sqrt(delta / |r|) outside."""
    n = sq_norm.clamp_min(1e-24).sqrt()
    return (delta / n).clamp_max(1.0).sqrt()


def _grid(prob: BAProblem, theta, intr, points):
    """Per-observation operands of the flattened (P * C) grid."""
    p, c = prob.obs_w.shape
    return (theta.expand(p, c, theta.shape[-1]).reshape(p * c, -1),
            points[:, None, :].expand(p, c, 3).reshape(p * c, 3),
            intr.expand(p, c, N_INTR).reshape(p * c, N_INTR),
            prob.obs_xy.reshape(p * c, 2), prob.obs_w.reshape(p * c))


def _obs_jac(free_intr: tuple):
    """vmapped forward-mode Jacobians (w.r.t. the packed camera
    parameters and the point) of every observation's residual, with the
    residual itself as the auxiliary output."""
    def resid_pair(theta, X, intr_b, xy, w):
        r = _project_resid(theta, X, intr_b, xy, w, free_intr)
        return r, r

    return vmap(jacfwd(resid_pair, argnums=(0, 1), has_aux=True))


def _observation_jacobians(prob: BAProblem, theta, intr, points,
                           free_intr: tuple, robust_delta, obs_jac):
    """(r_obs (P, C, 2), J_t (P, C, 2, B), J_x (P, C, 2, 3)) of the grid,
    IRLS-reweighted by sqrt(rho') with a Huber band."""
    p, c = prob.obs_w.shape
    (J_t, J_x), r_obs = obs_jac(*_grid(prob, theta[None], intr[None],
                                       points))
    r_obs = r_obs.reshape(p, c, 2)
    J_t = J_t.reshape(p, c, 2, -1)
    J_x = J_x.reshape(p, c, 2, 3)
    if robust_delta is not None:
        rw = _huber_irls_weight((r_obs ** 2).sum(-1), robust_delta)
        r_obs = r_obs * rw[..., None]
        J_t = J_t * rw[..., None, None]
        J_x = J_x * rw[..., None, None]
    return r_obs, J_t, J_x


def _blocks(J_t, J_x):
    """Normal-equation blocks U (C, B, B), V (P, 3, 3), W (P, C, B, 3)."""
    return (torch.einsum("pcib,pcid->cbd", J_t, J_t),
            torch.einsum("pcib,pcid->pbd", J_x, J_x),
            torch.einsum("pcib,pcid->pcbd", J_t, J_x))


def _center_jacobian(prob: BAProblem, cam_theta, ni: int, cc_jac):
    """Jacobian (C, 3, B) of the camera-centre priors (zero on the free
    intrinsics)."""
    J_cc = cc_jac(cam_theta, prob.cam_prior, prob.cam_prior_w)  # (C, 3, 6)
    if ni:
        J_cc = torch.cat([J_cc, J_cc.new_zeros(J_cc.shape[:2] + (ni,))], 2)
    return J_cc


def _point_prior_information(prob: BAProblem):
    """w^2 I of the point priors, (P, 3, 3)."""
    eye3 = torch.eye(3, dtype=prob.points.dtype, device=prob.points.device)
    return (prob.pt_prior_w[:, None] ** 2)[..., None] * eye3


def _free_params(prob: BAProblem, ni: int):
    """(C * B,) 1 for a free parameter, 0 for a fixed camera's pose
    parameter (a fixed camera's free intrinsics stay adjustable)."""
    c = prob.cam_fixed.shape[0]
    pose_fixed = prob.cam_fixed[:, None].expand(c, 6)
    if ni:
        pose_fixed = torch.cat([pose_fixed, torch.zeros(
            (c, ni), dtype=torch.bool, device=pose_fixed.device)], 1)
    return 1.0 - pose_fixed.reshape(-1).to(prob.points.dtype)


def _freeze(Sd, freef):
    """The reduced system with fixed parameters' rows and columns
    replaced by identity ones."""
    return Sd * freef[:, None] * freef[None, :] + torch.diag(1.0 - freef)


def lm_solve(prob: BAProblem, free_intr: tuple = (), max_iters: int = 50,
             lam0: float = 1e-3, rtol: float = 1e-8,
             robust_delta: float | None = None) -> BAResult:
    """Levenberg-Marquardt until the cost stops falling (relative change
    <= rtol on an accepted step), lambda passes 1e10, or max_iters.

    free_intr: indices into the 12-entry intrinsic vector refined per
    camera; robust_delta: Huber band in weighted-residual units (None:
    least squares).
    """
    free_intr = tuple(int(i) for i in free_intr)
    c = prob.cam_theta.shape[0]
    p = prob.points.shape[0]
    ni = len(free_intr)
    b = 6 + ni
    dev = prob.points.device
    free_idx = torch.tensor(free_intr, dtype=torch.int64, device=dev)

    def pack(cam_theta, intr):
        return torch.cat([cam_theta, intr[:, free_idx]], 1) if ni \
            else cam_theta

    def unpack(theta):
        intr = prob.intrinsics
        if ni:
            intr = intr.clone()
            intr[:, free_idx] = theta[:, 6:]
        return theta[:, :6], intr

    def resid(theta, X, intr_b, xy, w):
        return _project_resid(theta, X, intr_b, xy, w, free_intr)

    obs_resid = vmap(resid)
    obs_jac = _obs_jac(free_intr)
    cc_resid = vmap(_center_resid)
    cc_jac = vmap(jacfwd(_center_resid))

    def obs_sq(r_obs):
        return (r_obs ** 2).sum(-1)

    def cost_fn(theta, points):
        cam_theta, intr = unpack(theta)
        r_obs = obs_resid(*_grid(prob, theta[None], intr[None], points))
        if robust_delta is None:
            obs_cost = (r_obs ** 2).sum()
        else:
            obs_cost = _huber_rho(obs_sq(r_obs), robust_delta).sum()
        r_cc = cc_resid(cam_theta, prob.cam_prior, prob.cam_prior_w)
        r_pt = (points - prob.pt_prior) * prob.pt_prior_w[:, None]
        return 0.5 * (obs_cost + (r_cc ** 2).sum() + (r_pt ** 2).sum())

    def normal_system(theta, points):
        cam_theta, intr = unpack(theta)
        r_obs, J_t, J_x = _observation_jacobians(
            prob, theta, intr, points, free_intr, robust_delta, obs_jac)
        U, V, W = _blocks(J_t, J_x)
        g_c = -torch.einsum("pcib,pci->cb", J_t, r_obs)
        g_x = -torch.einsum("pcib,pci->pb", J_x, r_obs)

        # camera-centre priors
        r_cc = cc_resid(cam_theta, prob.cam_prior, prob.cam_prior_w)
        J_cc = _center_jacobian(prob, cam_theta, ni, cc_jac)
        U = U + torch.einsum("cib,cid->cbd", J_cc, J_cc)
        g_c = g_c - torch.einsum("cib,ci->cb", J_cc, r_cc)

        # point priors: the Jacobian is w * I
        V = V + _point_prior_information(prob)
        r_pt = (points - prob.pt_prior) * prob.pt_prior_w[:, None]
        g_x = g_x - prob.pt_prior_w[:, None] * r_pt
        return U, V, W, g_c, g_x

    # fixed cameras freeze their pose parameters only (their free
    # intrinsics stay adjustable): identity rows and columns, zero rhs
    freef = _free_params(prob, ni)
    eye_b = torch.eye(b, device=dev)
    eye3 = torch.eye(3, device=dev)
    cam = torch.arange(c, device=dev)

    def lm_step(theta, points, lam):
        U, V, W, g_c, g_x = normal_system(theta, points)
        # Marquardt (scale-invariant) damping
        U = U + lam * (torch.diagonal(U, dim1=1, dim2=2) + 1e-6)[..., None] \
            * eye_b
        V = V + lam * (torch.diagonal(V, dim1=1, dim2=2) + 1e-6)[..., None] \
            * eye3
        Vinv = torch.linalg.inv(V)                                # (P, 3, 3)
        Y = torch.einsum("pcbj,pjk->pcbk", W, Vinv)
        S = -torch.einsum("pcbk,pdek->cdbe", Y, W)
        S = S.index_put((cam, cam), U, accumulate=True)
        rhs = g_c - torch.einsum("pcbk,pk->cb", Y, g_x)
        Sd = _freeze(S.permute(0, 2, 1, 3).reshape(c * b, c * b), freef)
        d_theta = torch.linalg.solve(Sd, rhs.reshape(-1) * freef).reshape(c, b)
        d_x = torch.einsum("pjk,pk->pj", Vinv,
                           g_x - torch.einsum("pcbj,cb->pj", W, d_theta))
        new_theta, new_points = theta + d_theta, points + d_x
        return new_theta, new_points, cost_fn(new_theta, new_points)

    with torch.no_grad(), full_f32_matmul():
        theta = pack(prob.cam_theta, prob.intrinsics)
        points = prob.points
        cost0 = cost_fn(theta, points)
        cost = cost0
        lam = torch.tensor(lam0, dtype=torch.float32, device=dev)
        it = 0
        while it < max_iters:
            new_theta, new_points, new_cost = lm_step(theta, points, lam)
            accept = new_cost < cost
            theta = torch.where(accept, new_theta, theta)
            points = torch.where(accept, new_points, points)
            converged = accept & ((cost - new_cost).abs()
                                  <= rtol * cost.clamp_min(1e-12))
            lam = torch.where(accept, (lam * 0.3).clamp_min(1e-9), lam * 4.0)
            cost = torch.where(accept, new_cost, cost)
            it += 1
            if bool(converged | (lam > 1e10)):      # one sync an iteration
                break
        cam_theta, intr = unpack(theta)
    return BAResult(cam_theta=cam_theta, intrinsics=intr, points=points,
                    cost=cost, initial_cost=cost0, iterations=it, lam=lam)


def lm_solve_batched(probs: list, free_intr: tuple = (), max_iters: int = 50,
                     lam0: float = 1e-3, rtol: float = 1e-8,
                     robust_delta: float | None = None) -> BAResult:
    """Solve a batch of bundle adjustments of one shape (P, C): `probs`
    is a list of BAProblems (the JAX package stacks them on a leading
    axis and vmaps its LM). The problems are solved one after another by
    `lm_solve`, so each result is what `lm_solve` gives on that problem
    alone. Returns a BAResult whose tensors are stacked on a leading
    batch axis; `iterations` is the list of per-problem counts."""
    outs = [lm_solve(p, free_intr=free_intr, max_iters=max_iters, lam0=lam0,
                     rtol=rtol, robust_delta=robust_delta) for p in probs]
    return BAResult(*([o.iterations for o in outs] if f == "iterations"
                      else torch.stack([getattr(o, f) for o in outs])
                      for f in BAResult._fields))


def point_covariances(prob: BAProblem, cam_theta: torch.Tensor,
                      intrinsics: torch.Tensor, points: torch.Tensor,
                      free_intr: tuple = (),
                      robust_delta: float | None = None) -> torch.Tensor:
    """Marginal 3x3 covariance of every point at a BA solution.

    Residuals are whitened by the 1/sigma weights, so J^T J is the
    information matrix in physical units, and
    Cov_X = V^-1 + V^-1 W^T S^-1 W V^-1, S the reduced camera system
    (fixed cameras' poses contribute nothing). With a Huber band the
    observations carry the IRLS weights of the solution, as in the
    solve. The Jacobians are taken in the problem's dtype; the blocks,
    the Schur complement and both inverses run in float64 (in float32 the
    complement cancels: with "metashape" intrinsics, or a far scene on a
    short baseline, the JAX package's float32 covariances are 5-10% off
    a float64 run). Returns (P, 3, 3) in the problem's dtype.
    """
    free_intr = tuple(int(i) for i in free_intr)
    c = cam_theta.shape[0]
    ni = len(free_intr)
    b = 6 + ni
    dt, dev = points.dtype, points.device
    f64 = torch.float64
    theta = cam_theta
    if ni:
        theta = torch.cat([cam_theta, intrinsics[:, list(free_intr)]], 1)
    with torch.no_grad(), full_f32_matmul():
        _, J_t, J_x = _observation_jacobians(
            prob, theta, intrinsics, points, free_intr, robust_delta,
            _obs_jac(free_intr))
        U, V, W = _blocks(J_t.to(f64), J_x.to(f64))
        J_cc = _center_jacobian(prob, cam_theta, ni,
                                vmap(jacfwd(_center_resid))).to(f64)
        U = U + torch.einsum("cib,cid->cbd", J_cc, J_cc)
        V = V + _point_prior_information(prob).to(f64) \
            + 1e-8 * torch.eye(3, dtype=f64, device=dev)
        Vinv = torch.linalg.inv(V)
        Y = torch.einsum("pcbj,pjk->pcbk", W, Vinv)
        S = -torch.einsum("pcbk,pdek->cdbe", Y, W)
        cam = torch.arange(c, device=dev)
        S = S.index_put((cam, cam), U, accumulate=True)
        freef = _free_params(prob, ni).to(f64)
        Sd = _freeze(S.permute(0, 2, 1, 3).reshape(c * b, c * b), freef)
        cov_theta = torch.linalg.inv(Sd) * freef[:, None] * freef[None, :]
        # W_p^T as (3, C * B) in the (camera-major, parameter-minor) order
        G = W.permute(0, 3, 1, 2).reshape(-1, 3, c * b)
        A = Vinv @ G                                        # (P, 3, C * B)
        return (Vinv + A @ cov_theta @ A.mT).to(dt)
