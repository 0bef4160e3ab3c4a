"""Hypothesis-parallel RANSAC in plain batched PyTorch (counterpart of
`icepy4d_tpu/ops/ransac.py`; the JAX package runs it through XLA with
no Pallas kernel): fundamental matrices (plain, DEGENSAC and MAGSAC
scoring), homographies, the essential matrix with its pose, and PnP.

Sampling is Gumbel-top-k over the validity mask (one (H, N) tensor op)
from an explicit `torch.Generator`; the minimal solvers run batched
over hypotheses on the gathered sample rows (the same math as the JAX
package's one-hot (H, N) weight rows, without an (H, N, 9) design
tensor); scoring is one (H, N) residual matrix. Every sampling entry
point also takes precomputed index sets `idx`, so a caller can replay
the draws of another generator.
"""

from __future__ import annotations

from typing import Callable

import torch

from icepy4d_tpu_torch.ops import epipolar


def sample_minimal_sets(gen: torch.Generator, mask: torch.Tensor,
                        n_hypotheses: int, sample_size: int,
                        guidance: torch.Tensor | None = None) -> torch.Tensor:
    """(H, S) index sets drawn from valid rows without replacement.

    With `guidance` (N,) match scores, rows are weighted
    exp(-rank / tau) (PROSAC-style, see rank_weights)."""
    n = mask.shape[0]
    logits = torch.where(mask, 0.0, float("-inf"))
    if guidance is not None:
        logits = logits + rank_weights(mask, guidance).clamp_min(1e-30).log()
    u = torch.rand((n_hypotheses, n), generator=gen, device=mask.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.topk(logits[None, :] + gumbel, sample_size, dim=-1).indices


def rank_weights(mask: torch.Tensor, guidance: torch.Tensor) -> torch.Tensor:
    """exp(-rank / tau) quality weights, tau ~ 2% of the valid count."""
    n = mask.shape[0]
    order = torch.argsort(torch.where(mask, -guidance, float("inf")),
                          stable=True)
    rank = torch.empty(n, dtype=torch.float32, device=mask.device)
    rank[order] = torch.arange(n, dtype=torch.float32, device=mask.device)
    tau = torch.clamp(0.02 * mask.sum(), min=32.0)
    return torch.exp(-rank / tau) * mask


def _one_hot_weights(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Index sets (..., S) -> weight rows (..., N) with ones at the
    indices: the JAX package's form of a minimal sample."""
    w = torch.zeros(idx.shape[:-1] + (n,), device=idx.device)
    return w.scatter_(-1, idx, 1.0)


def _gathered(solver: Callable, x0: torch.Tensor, x1: torch.Tensor):
    """Minimal solver on the gathered rows of (H, S) index sets."""
    def run(idx):
        return solver(x0[idx], x1[idx], torch.ones(idx.shape, device=idx.device))
    return run


def ransac(gen, solver: Callable, residual: Callable, mask: torch.Tensor, *,
           sample_size: int, n_hypotheses: int, threshold: float,
           guidance: torch.Tensor | None = None, idx=None):
    """Generic engine -> (best_model, inlier_mask, score).

    solver(idx (H, S)) -> models with leading H;
    residual(models) -> (H, N) squared residuals in threshold units."""
    if idx is None:
        idx = sample_minimal_sets(gen, mask, n_hypotheses, sample_size,
                                  guidance)
    models = solver(idx)
    inl = (residual(models) < threshold ** 2) & mask[None, :]
    if guidance is not None:
        # blended consensus: a 0.1/row count term plus quality mass
        w = 0.1 + rank_weights(mask, guidance)
        scores = torch.where(inl, w[None, :], 0.0).sum(1)
    else:
        scores = inl.sum(1).float()
    best = torch.argmax(scores)
    return models[best], inl[best], scores[best]


def ransac_fundamental(gen, x0, x1, mask, threshold: float = 1.5,
                       n_hypotheses: int = 512, refit_iters: int = 2,
                       guidance=None, idx=None):
    """F-matrix RANSAC with Sampson scoring + iterated inlier refit.
    Returns (F (3, 3), inlier mask (N,))."""
    F, inliers, _ = ransac(
        gen, _gathered(epipolar.eight_point, x0, x1),
        lambda Fs: epipolar.sampson_distance(Fs, x0, x1), mask,
        sample_size=8, n_hypotheses=n_hypotheses, threshold=threshold,
        guidance=guidance, idx=idx)

    # quality-weighted refits with guidance; candidates are accepted by
    # (weighted) hard inlier count
    rw = None if guidance is None else 0.1 + rank_weights(mask, guidance)
    sel_w = torch.ones_like(x0[:, 0]) if rw is None else rw
    cand_F, cand_inl = [F], [inliers]
    inlc = inliers
    for _ in range(max(refit_iters, 1)):
        w = inlc.float() if rw is None else inlc * rw
        Fc = epipolar.eight_point(x0, x1, w)
        inlc = (epipolar.sampson_distance(Fc, x0, x1) < threshold ** 2) & mask
        cand_F.append(Fc)
        cand_inl.append(inlc)
    scores = torch.stack([torch.where(i, sel_w, 0.0).sum() for i in cand_inl])
    bi = torch.argmax(scores + 1e-3 * torch.arange(
        len(cand_inl), device=scores.device))
    return torch.stack(cand_F)[bi], torch.stack(cand_inl)[bi]


def ransac_homography(gen, x0, x1, mask, threshold: float = 3.0,
                      n_hypotheses: int = 256, idx=None):
    """Homography RANSAC (4-point DLT, symmetric transfer error) with one
    refit. Returns (H (3, 3), inlier mask (N,))."""
    H, inliers, _ = ransac(
        gen, _gathered(epipolar.homography_dlt, x0, x1),
        lambda Hs: epipolar.homography_sym_transfer(Hs, x0, x1), mask,
        sample_size=4, n_hypotheses=n_hypotheses, threshold=threshold,
        idx=idx)
    H = epipolar.homography_dlt(x0, x1, inliers.float())
    d = epipolar.homography_sym_transfer(H, x0, x1)
    return H, (d < threshold ** 2) & mask


def ransac_fundamental_degensac(gen, x0, x1, mask, threshold: float = 1.5,
                                n_hypotheses: int = 512,
                                h_hypotheses: int = 256,
                                degeneracy_frac: float = 0.8,
                                refit_iters: int = 2, guidance=None):
    """F-matrix RANSAC with DEGENSAC plane-degeneracy handling.

      1. plain hypothesis-parallel F-RANSAC (ransac_fundamental);
      2. H-RANSAC on F's consensus set; if H explains more than
         degeneracy_frac of it, the configuration is degenerate;
      3. plane-and-parallax recovery: F' = [e']_x H with the epipole
         found by RANSAC over 2-line samples of the off-plane
         correspondences, then IRLS-polished and refit;
      4. keep the candidate that explains the most parallax-weighted
         off-plane support (the plain F wins ties and is the only
         candidate when the scene is not degenerate).

    Returns (F (3, 3), inlier mask (N,), degenerate flag ()).
    """
    F, inlF = ransac_fundamental(gen, x0, x1, mask, threshold, n_hypotheses,
                                 refit_iters, guidance=guidance)
    nF = inlF.sum()

    # symmetric transfer sums four noisy coordinates against Sampson's
    # one point-line distance: the H threshold is 3x the F threshold
    H, inlH = ransac_homography(gen, x0, x1, inlF, threshold=threshold * 3.0,
                                n_hypotheses=h_hypotheses)
    degenerate = inlH.sum() > degeneracy_frac * nF.clamp_min(1)

    # only points with real parallax constrain the epipole; scores are
    # parallax-weighted, capped at 50 px
    par2 = epipolar.parallax_sq(H, x0, x1)
    off_b = mask & ~inlH & (par2 > (3.0 * threshold) ** 2)
    w_par = torch.where(off_b, par2.sqrt().clamp(0.0, 50.0), 0.0)

    idxE = sample_minimal_sets(gen, off_b, h_hypotheses, 2)
    e1 = epipolar.epipole_from_lines(
        H, x0[idxE], x1[idxE], torch.ones(idxE.shape, device=x0.device))
    Fs = epipolar.skew(e1) @ H
    Fs = Fs / Fs.abs().amax((-2, -1), keepdim=True).clamp_min(1e-12)
    inE = epipolar.sampson_distance(Fs, x0, x1) < threshold ** 2
    bestE = torch.argmax(torch.where(inE, w_par[None, :], 0.0).sum(1))
    Fpp = Fs[bestE]
    Fpp2 = epipolar.fundamental_from_homography(
        H, x0, x1, (inE[bestE] & off_b).float())

    def inliers(Fc):
        return (epipolar.sampson_distance(Fc, x0, x1) < threshold ** 2) & mask

    inl_pp, inl_pp2 = inliers(Fpp), inliers(Fpp2)
    # a refit can drag the recovered model back onto the plane, so the
    # raw plane-and-parallax models stay candidates too
    Fpp_r, inl_pp_r = Fpp2, inl_pp2
    for _ in range(refit_iters):
        Fpp_r = epipolar.eight_point(x0, x1, inl_pp_r.float())
        inl_pp_r = inliers(Fpp_r)

    cand_F = torch.stack([F, Fpp, Fpp2, Fpp_r])
    cand_inl = torch.stack([inlF, inl_pp, inl_pp2, inl_pp_r])
    scores = torch.where(
        epipolar.sampson_distance(cand_F, x0, x1) < threshold ** 2,
        w_par[None, :], 0.0).sum(1)
    ok_pp = degenerate & (off_b.sum() >= 2)
    allow = torch.stack([torch.ones_like(ok_pp), ok_pp, ok_pp, ok_pp])
    best = torch.argmax(torch.where(allow, scores, -1.0))
    return cand_F[best], cand_inl[best], degenerate


def ransac_essential_pose(gen, x0, x1, K0, K1, mask, threshold_px: float = 1.0,
                          n_hypotheses: int = 512, guidance=None,
                          F_hint=None, idx=None):
    """Essential-matrix RANSAC with cheirality pose recovery.

    Pixel coords in, pose out: Sampson distances are scored in
    K-normalised units against `threshold_px` over the mean focal.
    Hypotheses are 8-point solutions on the gathered minimal samples,
    plus, with `F_hint` (a verified F), K1^T F K0 projected onto the
    essential manifold. Selection is by the (rank-weighted with
    `guidance`) consensus; two weighted refits are candidates accepted
    by hard count, a 1e-3 bonus preferring refits on ties.
    Returns (R, t, E, inlier mask): x1 = R x0 + t, t unit norm.
    """
    f_mean = (K0[0, 0] + K0[1, 1] + K1[0, 0] + K1[1, 1]) / 4.0
    th2 = (threshold_px / f_mean) ** 2

    def norm(x, K):
        return torch.stack([(x[..., 0] - K[0, 2]) / K[0, 0],
                            (x[..., 1] - K[1, 2]) / K[1, 1]], -1)

    x0n, x1n = norm(x0, K0), norm(x1, K1)
    if idx is None:
        idx = sample_minimal_sets(gen, mask, n_hypotheses, 8, guidance)
    models = _gathered(epipolar.essential_eight_point, x0n, x1n)(idx)
    if F_hint is not None:
        U, _, Vh = torch.linalg.svd(K1.mT @ F_hint @ K0)
        s = torch.tensor([1.0, 1.0, 0.0], device=U.device)
        models = torch.cat([models, ((U * s) @ Vh)[None]], 0)
    inl_all = (epipolar.sampson_distance(models, x0n, x1n) < th2) \
        & mask[None, :]
    fmask = mask.to(torch.float32)
    rw = fmask if guidance is None else 0.1 + rank_weights(mask, guidance)
    qw = rw * fmask
    best = torch.argmax(torch.where(inl_all, qw[None, :], 0.0).sum(1))
    E, inliers = models[best], inl_all[best]

    # refits are candidates accepted by hard (weighted) count: a weighted
    # refit that shrinks to the top-ranked rows must not win
    cand_E, cand_inl = [E], [inliers]
    inlc = inliers
    for _ in range(2):
        Ec = epipolar.essential_eight_point(x0n, x1n, inlc * rw)
        inlc = (epipolar.sampson_distance(Ec, x0n, x1n) < th2) & mask
        cand_E.append(Ec)
        cand_inl.append(inlc)
    scores = torch.stack([torch.where(i, qw, 0.0).sum() for i in cand_inl])
    bi = torch.argmax(scores + 1e-3 * torch.arange(
        len(cand_inl), device=scores.device))
    E, inliers = torch.stack(cand_E)[bi], torch.stack(cand_inl)[bi]
    R, t, front = epipolar.recover_pose(E, x0n, x1n, inliers.to(torch.float32))
    return R, t, E, inliers & front


def ransac_fundamental_magsac(gen, x0, x1, mask, sigma_max: float = 2.0,
                              n_hypotheses: int = 512, polish_iters: int = 3,
                              guidance=None, idx=None):
    """F-matrix RANSAC with sigma-consensus scoring (MAGSAC semantics).

    A hard threshold marginalised uniformly over noise scales in
    (0, sigma_max] gives the hypothesis quality
    q = sum_i max(0, 1 - r_i / sigma_max) (r_i the Sampson distance in
    px, rank-weighted with `guidance`). The best hypothesis is polished
    by `polish_iters` rounds of the 8-point solver weighted by the same
    per-row quality. The returned mask flags r < sigma_max.
    Returns (F (3, 3), inlier mask (N,))."""
    if idx is None:
        idx = sample_minimal_sets(gen, mask, n_hypotheses, 8, guidance)
    models = _gathered(epipolar.eight_point, x0, x1)(idx)
    fmask = mask.to(torch.float32)
    qw = fmask if guidance is None \
        else (0.1 + rank_weights(mask, guidance)) * fmask

    def quality(F):
        r = epipolar.sampson_distance(F, x0, x1).clamp_min(0.0).sqrt()
        return (1.0 - r / sigma_max).clamp_min(0.0) * qw

    F = models[torch.argmax(quality(models).sum(1))]
    for _ in range(polish_iters):
        F = epipolar.eight_point(x0, x1, quality(F))
    return F, (epipolar.sampson_distance(F, x0, x1) < sigma_max ** 2) & mask


def ransac_pnp(gen, pts3d, pts2d, K, mask, threshold_px: float = 3.0,
               n_hypotheses: int = 256, idx=None):
    """DLT-PnP RANSAC: 6-point minimal samples, reprojection error in
    K-normalised units against `threshold_px` over the mean focal (a
    point behind the camera is never an inlier), then one refit on the
    consensus. Returns (R (3, 3), t (3,), inlier mask (N,)) with
    x_cam = R X + t."""
    x2n = torch.stack([(pts2d[..., 0] - K[0, 2]) / K[0, 0],
                       (pts2d[..., 1] - K[1, 2]) / K[1, 1]], -1)
    th_n = threshold_px / ((K[0, 0] + K[1, 1]) / 2.0)

    def solver(idx):
        R, t = epipolar.pnp_dlt(pts3d[idx], x2n[idx],
                                torch.ones(idx.shape, device=idx.device))
        return torch.cat([R, t[..., None]], -1)                 # (H, 3, 4)

    def residual(P):
        pc = pts3d @ P[..., :3].mT + P[..., None, :, 3]
        z = pc[..., 2]
        z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        r2 = ((pc[..., :2] / z[..., None] - x2n) ** 2).sum(-1)
        return torch.where(pc[..., 2] <= 0, float("inf"), r2)

    _, inliers, _ = ransac(gen, solver, residual, mask, sample_size=6,
                           n_hypotheses=n_hypotheses, threshold=th_n, idx=idx)
    R, t = epipolar.pnp_dlt(pts3d, x2n, inliers.to(torch.float32))
    P = torch.cat([R, t[:, None]], 1)
    return R, t, (residual(P) < th_n ** 2) & mask
