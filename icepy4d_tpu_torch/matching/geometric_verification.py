"""Geometric verification of putative matches (counterpart of
`icepy4d_tpu/matching/geometric_verification.py`).

  PYDEGENSAC -> F-RANSAC + H-degeneracy test + plane-and-parallax recovery
  JAX_RANSAC -> plain fixed-threshold Sampson RANSAC
  MAGSAC     -> sigma-consensus scoring with no fixed inlier threshold
                (`threshold` is sigma_max)
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.matching.enums import GeometricVerification
from icepy4d_tpu_torch.ops.buckets import pad_bucket
from icepy4d_tpu_torch.ops.ransac import (ransac_fundamental,
                                          ransac_fundamental_degensac,
                                          ransac_fundamental_magsac)

logger = logging.getLogger("icepy4d_tpu_torch")

MIN_MATCHES = 8


def hypothesis_budget(confidence: float, max_iters: int) -> int:
    """Hypotheses for one all-inlier sample with probability
    `confidence` at an assumed inlier ratio of 0.5:
    n >= log(1 - conf) / log(1 - 0.5^8), rounded up to a power of two,
    at least 512 and at most max_iters."""
    conf = float(np.clip(confidence, 0.5, 1.0 - 1e-12))
    n_conf = int(np.ceil(np.log(1.0 - conf) / np.log(1.0 - 0.5 ** 8)))
    return int(min(max_iters,
                   max(512, 1 << (max(n_conf, 1) - 1).bit_length())))


def geometric_verification(
    mkpts0: np.ndarray,
    mkpts1: np.ndarray,
    method: GeometricVerification = GeometricVerification.PYDEGENSAC,
    threshold: float = 1.0,
    confidence: float = 0.9999,
    max_iters: int = 10000,
    seed: int = 0,
    quiet: bool = False,
    scores: np.ndarray | None = None,
    device=None,
):
    """(mkpts0, mkpts1) -> (F (3,3) float64 | None, inlier mask (N,) bool).

    `scores` (N,) turn on quality-guided sampling. Hypotheses run in
    parallel on `device`, so the whole budget is always spent. For
    MAGSAC, `threshold` is sigma_max.
    """
    mkpts0 = np.asarray(mkpts0, np.float32)
    mkpts1 = np.asarray(mkpts1, np.float32)
    n = mkpts0.shape[0]
    if method is GeometricVerification.NONE:
        return None, np.ones(n, bool)
    if n < MIN_MATCHES:
        if not quiet:
            logger.warning(
                "Not enough matches for geometric verification (%d < %d)",
                n, MIN_MATCHES)
        return None, np.ones(n, bool)

    dev = resolve_device(device)
    n_hyp = hypothesis_budget(confidence, max_iters)
    gen = torch.Generator(device=dev).manual_seed(seed)
    # pad to the JAX package's power-of-4 bucket so both see one shape
    cap = pad_bucket(n)
    pk0 = np.zeros((cap, 2), np.float32)
    pk1 = np.zeros((cap, 2), np.float32)
    pk0[:n] = mkpts0
    pk1[:n] = mkpts1
    x0 = torch.from_numpy(pk0).to(dev)
    x1 = torch.from_numpy(pk1).to(dev)
    mask = torch.arange(cap, device=dev) < n
    guidance = None
    if scores is not None and len(scores) == n:
        g = np.zeros((cap,), np.float32)
        g[:n] = np.asarray(scores, np.float32)
        guidance = torch.from_numpy(g).to(dev)

    with torch.inference_mode():
        if method is GeometricVerification.PYDEGENSAC:
            F, inl, degenerate = ransac_fundamental_degensac(
                gen, x0, x1, mask, threshold=float(threshold),
                n_hypotheses=n_hyp, guidance=guidance)
            if not quiet and bool(degenerate):
                logger.info(
                    "Geometric verification: dominant-plane degeneracy "
                    "detected, plane-and-parallax recovery applied")
        elif method is GeometricVerification.MAGSAC:
            F, inl = ransac_fundamental_magsac(
                gen, x0, x1, mask, sigma_max=float(threshold),
                n_hypotheses=n_hyp, guidance=guidance)
        else:  # JAX_RANSAC: plain fixed-threshold Sampson RANSAC
            F, inl = ransac_fundamental(
                gen, x0, x1, mask, threshold=float(threshold),
                n_hypotheses=n_hyp, guidance=guidance)
    F = F.cpu().numpy().astype(np.float64)
    inl = inl.cpu().numpy().astype(bool)[:n]
    if not quiet:
        logger.info("Geometric verification: %d / %d inliers (%.1f%%)",
                    int(inl.sum()), n, 100.0 * inl.sum() / max(n, 1))
    return F, inl
