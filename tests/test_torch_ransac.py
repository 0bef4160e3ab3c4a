"""Port epipolar primitives and RANSAC against icepy4d_tpu's: primitives
to 1e-5; F-RANSAC fed the JAX side's minimal samples gives the same
model; DEGENSAC compared by outcome (its draws come from another
generator)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.ops import epipolar as jep
from icepy4d_tpu.ops import ransac as jr
from icepy4d_tpu_torch.ops import epipolar as ep
from icepy4d_tpu_torch.ops import ransac as pr
from torch_port_inputs import epipolar_pair, jaccard, plane_scene, sampson_np


def _pts(seed=0, n=60):
    x0, x1, _ = epipolar_pair(n=n, n_out=5, seed=seed)
    w = np.random.default_rng(seed).uniform(0.2, 1.0, n).astype(np.float32)
    return x0, x1, w


def _t(*a):
    return [torch.tensor(np.asarray(x)) for x in a]


def _j(*a):
    return [jnp.asarray(x) for x in a]


def _unit(F):
    F = np.asarray(F, np.float64)
    return F / np.linalg.norm(F)


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())


# Models solved as the smallest eigenvector of a normal matrix move by
# ~f32 eps * lambda_max / (lambda_2 - lambda_1) of their unit norm from
# one LAPACK to another. On the near-degenerate scenes below (a line
# bundle of 8 off-plane points, a pure-translation pair) that ratio is
# ~1e5, so both frameworks land ~1e-3 from the float64 solution.
EIG_TOL = 3e-3


def _close_up_to_scale(a, b, tol):
    """Unit-norm forms of two homogeneous matrices agree up to sign."""
    a, b = _unit(a), _unit(b)
    b = b if np.abs(a - b).max() <= np.abs(a + b).max() else -b
    np.testing.assert_allclose(a, b, atol=tol)


def test_hartley_sampson_skew():
    x0, x1, w = _pts()
    for got, ref in zip(ep.hartley_normalization(*_t(x0, w)),
                        jep.hartley_normalization(*_j(x0, w))):
        _close(got, ref)
    F = np.asarray(jep.eight_point(*_j(x0, x1, w)))
    _close(ep.sampson_distance(*_t(F, x0, x1)),
           jep.sampson_distance(*_j(F, x0, x1)))
    v = np.array([0.3, -1.2, 2.0], np.float32)
    _close(ep.skew(*_t(v)), jep.skew(*_j(v)))


@pytest.mark.parametrize("seed", [0, 1])
def test_eight_point_and_homography(seed):
    x0, x1, w = _pts(seed)
    # F and H are defined up to scale: compare unit-norm forms
    _close_up_to_scale(ep.eight_point(*_t(x0, x1, w)),
                       jep.eight_point(*_j(x0, x1, w)), 1e-5)
    H = np.asarray(jep.homography_dlt(*_j(x0, x1, w)))
    _close_up_to_scale(ep.homography_dlt(*_t(x0, x1, w)), H, 1e-5)
    _close(ep.homography_sym_transfer(*_t(H, x0, x1)),
           jep.homography_sym_transfer(*_j(H, x0, x1)))


def test_plane_parallax_primitives():
    # forward motion: the epipole lies in the image, so the line-bundle
    # intersection is well conditioned in f32 pixel coordinates (an
    # epipole near infinity leaves its third coordinate to rounding)
    x0, x1, _ = plane_scene(1, n_off=30, t=(0.2, 0.1, 1.0))
    H = np.asarray(jr.ransac_homography(
        jax.random.PRNGKey(0), *_j(x0, x1, np.ones(len(x0), bool)))[0])
    par2 = np.asarray(jep.parallax_sq(*_j(H, x0, x1)))
    off = (np.arange(len(x0)) >= 120) & (par2 > 5.0 ** 2)
    assert off.sum() >= 10
    w = off.astype(np.float32)
    # lines of points with little parallax are ill-conditioned cross
    # products; hold those with real parallax, which define e'
    _close(ep.parallax_lines(*_t(H, x0[off], x1[off])),
           jep.parallax_lines(*_j(H, x0[off], x1[off])))
    _close(ep.parallax_sq(*_t(H, x0, x1)), jep.parallax_sq(*_j(H, x0, x1)))
    _close_up_to_scale(ep.epipole_from_lines(*_t(H, x0, x1, w))[:, None],
                       jep.epipole_from_lines(*_j(H, x0, x1, w))[:, None],
                       EIG_TOL)
    # three eigen-solves in an IRLS chain: held against the same chain in
    # float64, which the port's f32 meets within EIG_TOL and the JAX
    # package's f32 (XLA's eigh) within ~7e-3
    f64 = ep.fundamental_from_homography(
        *[torch.tensor(a, dtype=torch.float64) for a in (H, x0, x1, w)])
    _close_up_to_scale(ep.fundamental_from_homography(*_t(H, x0, x1, w)),
                       f64, EIG_TOL)
    _close_up_to_scale(jep.fundamental_from_homography(*_j(H, x0, x1, w)),
                       f64, 1e-2)


def test_gathered_solver_equals_one_hot_weights():
    x0, x1, _ = _pts()
    idx = torch.tensor([[0, 3, 7, 11, 20, 31, 40, 55],
                        [1, 2, 5, 8, 13, 21, 34, 59]])
    X0, X1 = _t(x0, x1)
    gathered = ep.eight_point(X0[idx], X1[idx], torch.ones(idx.shape))
    weighted = ep.eight_point(X0, X1, pr._one_hot_weights(idx, len(x0)))
    for a, b in zip(gathered, weighted):
        # the same solver in one framework; the summation order differs
        _close_up_to_scale(a, b, 1e-4)


@pytest.mark.parametrize("guided", [False, True])
def test_ransac_fundamental_with_jax_samples(guided):
    x0, x1, _ = epipolar_pair()
    n = 256
    pk0 = np.zeros((n, 2), np.float32)
    pk1 = np.zeros((n, 2), np.float32)
    pk0[:200], pk1[:200] = x0, x1
    mask = np.arange(n) < 200
    g = np.random.default_rng(0).uniform(size=n).astype(np.float32) \
        if guided else None
    key = jax.random.PRNGKey(7)
    F_j, inl_j = jr.ransac_fundamental(key, *_j(pk0, pk1, mask),
                                       threshold=1.0, n_hypotheses=512,
                                       guidance=None if g is None
                                       else jnp.asarray(g))
    idx = jr.sample_minimal_sets(key, jnp.asarray(mask), 512, 8,
                                 None if g is None else jnp.asarray(g))
    F_p, inl_p = pr.ransac_fundamental(
        None, *_t(pk0, pk1, mask), threshold=1.0, n_hypotheses=512,
        guidance=None if g is None else torch.from_numpy(g),
        idx=torch.from_numpy(np.asarray(idx, np.int64)))
    np.testing.assert_array_equal(inl_p.numpy(), np.asarray(inl_j))
    _close_up_to_scale(F_p, F_j, EIG_TOL)


def test_rank_weights_equal():
    mask = np.arange(100) < 80
    g = np.random.default_rng(1).uniform(size=100).astype(np.float32)
    g[5] = g[6]                      # a tie, ordered by index on both sides
    _close(pr.rank_weights(*_t(mask, g)), jr.rank_weights(*_j(mask, g)))


@pytest.mark.parametrize("scene", ["planar", "general"])
def test_degensac_outcome(scene):
    if scene == "planar":
        x0, x1, F_true = plane_scene(3)
        truth = sampson_np(F_true, x0, x1) < 2.0 ** 2
    else:
        x0, x1, truth = epipolar_pair(seed=5)
    mask = np.ones(len(x0), bool)
    th = 2.0
    F_j, inl_j, deg_j = jr.ransac_fundamental_degensac(
        jax.random.PRNGKey(0), *_j(x0, x1, mask), threshold=th,
        n_hypotheses=1024)
    gen = torch.Generator().manual_seed(0)
    F_p, inl_p, deg_p = pr.ransac_fundamental_degensac(
        gen, *_t(x0, x1, mask), threshold=th, n_hypotheses=1024)
    assert bool(deg_p) == bool(deg_j)
    assert jaccard(inl_p.numpy(), np.asarray(inl_j)) >= 0.95
    assert np.median(sampson_np(F_p.numpy(), x0[truth], x1[truth])) < th ** 2
