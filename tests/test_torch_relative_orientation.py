"""The port's essential RANSAC and relative orientation against
icepy4d_tpu's.

Fed the JAX side's own minimal samples (`sample_minimal_sets` with the
same key), `ransac_essential_pose` gives the same consensus (Jaccard >=
0.99: borderline points may flip with the last bits of E), R within
1e-4 rad and the unit t within 1e-4, with and without match-score
guidance and an F hint. `RelativeOrientation` draws from its own
generator and agrees by outcome."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.core.camera import Camera as JCamera
from icepy4d_tpu.ops import ransac as jr
from icepy4d_tpu.ops.buckets import pad_bucket
from icepy4d_tpu.sfm import RelativeOrientation as JRelativeOrientation
from icepy4d_tpu.sfm import estimate_pose as j_estimate_pose
from icepy4d_tpu_torch.core import Camera
from icepy4d_tpu_torch.ops import ransac as pr
from icepy4d_tpu_torch.sfm import RelativeOrientation, estimate_pose
from torch_port_inputs import jaccard, rotation_zyx

K0 = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]], np.float32)
K1 = np.array([[820.0, 0, 316], [0, 815.0, 244], [0, 0, 1]], np.float32)
R_TRUE = rotation_zyx(-0.12, 0.03, 0.01).astype(np.float64)
T_TRUE = np.array([1.0, 0.05, 0.1])


def _scene(n=400, n_out=80, noise=0.15, seed=0):
    """Pixel correspondences of a general scene seen by (K0, I) and
    (K1, [R | t]), the first n_out replaced by gross outliers; match
    scores rank the inliers higher on the whole."""
    rng = np.random.default_rng(seed)
    X = np.c_[rng.uniform(-5, 5, (n, 2)), rng.uniform(6, 16, n)]

    def proj(K, P):
        x = P @ K.T
        return x[:, :2] / x[:, 2:]

    x0 = proj(K0.astype(np.float64), X) + rng.normal(0, noise, (n, 2))
    x1 = proj(K1.astype(np.float64), X @ R_TRUE.T + T_TRUE) \
        + rng.normal(0, noise, (n, 2))
    x1[:n_out] = rng.uniform([0, 0], [640, 480], (n_out, 2))
    scores = rng.uniform(0.2, 1.0, n)
    scores[:n_out] *= 0.5
    tx = np.array([[0, -T_TRUE[2], T_TRUE[1]], [T_TRUE[2], 0, -T_TRUE[0]],
                   [-T_TRUE[1], T_TRUE[0], 0]])
    F = np.linalg.inv(K1).T @ tx @ R_TRUE @ np.linalg.inv(K0)
    return (x0.astype(np.float32), x1.astype(np.float32),
            scores.astype(np.float32), (F / np.abs(F).max()).astype(np.float32))


def _angle(Ra, Rb) -> float:
    """Angle of Ra^T Rb, from its antisymmetric part and its trace (an
    arccos of the trace alone loses small angles of float32 matrices)."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    s = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                        M[1, 0] - M[0, 1]]) / 2
    return float(np.arctan2(s, (np.trace(M) - 1) / 2))


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("hint", [False, True])
def test_essential_ransac_replayed_samples(guided, hint):
    x0, x1, scores, F = _scene(seed=1 + 2 * guided + hint)
    n = len(x0)
    mask = np.ones(n, bool)
    guidance = scores if guided else None
    F_hint = F if hint else None
    key = jax.random.PRNGKey(3)
    jg = None if guidance is None else jnp.asarray(guidance)
    idx = np.asarray(jr.sample_minimal_sets(key, jnp.asarray(mask), 1024,
                                            8, jg))
    jR, jt, _jE, jinl = jr.ransac_essential_pose(
        key, jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(K0),
        jnp.asarray(K1), jnp.asarray(mask), threshold_px=1.0,
        n_hypotheses=1024, guidance=jg,
        F_hint=None if F_hint is None else jnp.asarray(F_hint))
    R, t, _E, inl = pr.ransac_essential_pose(
        None, _t(x0), _t(x1), _t(K0), _t(K1), _t(mask), threshold_px=1.0,
        n_hypotheses=1024,
        guidance=None if guidance is None else _t(guidance),
        F_hint=None if F_hint is None else _t(F_hint), idx=_t(idx))
    assert jaccard(inl.numpy(), np.asarray(jinl)) >= 0.99
    assert _angle(R.numpy(), jR) <= 1e-4
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-4)
    assert _angle(R.numpy(), R_TRUE) <= 2e-3


def test_estimate_pose_replays_padded_reference():
    """The JAX entry point pads to a bucket and masks the rows; the port
    runs at the exact count on the same draws. The padding alone moves
    the reference: its zero rows change the order of the f32 sums, a
    borderline point of an intermediate consensus can flip, and the
    rank-weighted refit that follows leans on few points. The port is
    held to the padded reference within 1e-4 plus twice the distance
    between the reference's padded and unpadded runs."""
    x0, x1, scores, F = _scene(n=300, n_out=60, seed=7)
    n = len(x0)
    cap = pad_bucket(n)
    mask = np.arange(cap) < n
    g = np.zeros(cap, np.float32)
    g[:n] = scores
    idx = np.asarray(jr.sample_minimal_sets(
        jax.random.PRNGKey(0), jnp.asarray(mask), 1024, 8, jnp.asarray(g)))
    assert idx.max() < n
    jR, jt, jvalid = j_estimate_pose(x0, x1, K0, K1, scores=scores,
                                     F_hint=F)
    R, t, valid = estimate_pose(x0, x1, K0, K1, scores=scores, F_hint=F,
                                idx=idx, device="cpu")
    uR, ut, _uE, _uinl = jr.ransac_essential_pose(
        jax.random.PRNGKey(0), *map(jnp.asarray, (x0, x1, K0, K1,
                                                   np.ones(n, bool))),
        threshold_px=1.0, n_hypotheses=1024, guidance=jnp.asarray(scores),
        F_hint=jnp.asarray(F))
    tol_R = 1e-4 + 2 * _angle(uR, jR)
    tol_t = 1e-4 + 2 * float(np.abs(np.asarray(ut).ravel() - jt.ravel()).max())
    assert valid.shape == jvalid.shape == (n,)
    assert jaccard(valid, jvalid) >= 0.99
    assert _angle(R, jR) <= tol_R
    np.testing.assert_allclose(t, jt, atol=tol_t)
    assert tol_R < 5e-3 and tol_t < 5e-2


def test_relative_orientation_outcome():
    x0, x1, scores, F = _scene(n=300, n_out=60, seed=11)
    C0 = np.array([10.0, -2.0, 3.0])
    E0 = np.eye(4, dtype=np.float32)
    E0[:3, :3] = rotation_zyx(0.2, 0.0, 0.1)
    E0[:3, 3] = -E0[:3, :3] @ C0
    baseline = float(np.linalg.norm(T_TRUE))
    cams = [Camera.create(width=640, height=480, K=K, extrinsics=E)
            for K, E in ((K0, E0), (K1, np.eye(4)))]
    jcams = [JCamera.create(width=640, height=480, K=K, extrinsics=E)
             for K, E in ((K0, E0), (K1, np.eye(4)))]
    ro = RelativeOrientation(cams, [x0, x1], device="cpu")
    jro = JRelativeOrientation(jcams, [x0, x1])
    valid = ro.estimate_pose(threshold=1.0, scale_factor=baseline,
                             scores=scores)
    jvalid = jro.estimate_pose(threshold=1.0, scale_factor=baseline,
                               scores=scores)
    assert jaccard(valid, jvalid) >= 0.97
    assert abs(int(valid.sum()) - int(jvalid.sum())) <= 0.03 * jvalid.sum()
    # cam1's world pose = cam0's pose chained with the relative pose
    E1 = ro.cameras[1].extrinsics
    jE1 = np.asarray(jro.cameras[1].extrinsics)
    assert _angle(E1[:3, :3], jE1[:3, :3]) <= 2e-3
    np.testing.assert_allclose(ro.cameras[1].C, np.asarray(jro.cameras[1].C),
                               atol=0.02 * baseline)
    rel = E1[:3, :3] @ E0[:3, :3].T
    assert _angle(rel, R_TRUE) <= 5e-3
    assert np.isclose(np.linalg.norm(ro.cameras[1].C - C0), baseline,
                      rtol=1e-5)
    assert ro.get_scale_factor_from_baseline(baseline) == pytest.approx(
        1.0, rel=1e-5)
