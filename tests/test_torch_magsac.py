"""The port's MAGSAC verification against icepy4d_tpu's.

`symmetric_epipolar_distance` agrees within 1e-5 relative. MAGSAC on the
same putatives: with the JAX package's own draws replayed, the same
inlier mask, and Sampson distances of the inliers under the two Fs
within 0.01 px; with each
package's own generator, by outcome: inlier counts within 3% and every
planted outlier rejected by both, also through `geometric_verification`
and the matcher on the shifted pair (>= 90% of the inliers within
1.5 px of the known shift)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.matching import GeometricVerification as JGV
from icepy4d_tpu.matching.geometric_verification import \
    geometric_verification as j_geometric_verification
from icepy4d_tpu.ops import epipolar as jep
from icepy4d_tpu.ops import ransac as jr
from icepy4d_tpu_torch.matching import (GeometricVerification,
                                        LightGlueMatcher, Quality,
                                        TileSelection)
from icepy4d_tpu_torch.matching.geometric_verification import \
    geometric_verification
from icepy4d_tpu_torch.ops import epipolar as ep
from icepy4d_tpu_torch.ops import ransac as rs
from torch_port_inputs import DX, DY, epipolar_pair, plane_scene, \
    shifted_pair


@pytest.mark.parametrize("batched", [False, True])
def test_symmetric_epipolar_distance(batched):
    """Random rank-2 F (a scene's own F would leave the residual to
    cancellation in the last bits of both)."""
    x0, x1, _ = plane_scene(2)
    rng = np.random.default_rng(0)
    Fs = []
    for _ in range(3 if batched else 1):
        U, _, Vt = np.linalg.svd(rng.normal(size=(3, 3)))
        Fs.append((U @ np.diag([1.0, 0.3, 0.0]) @ Vt
                   * [[1e-6, 1e-6, 1e-3], [1e-6, 1e-6, 1e-3],
                      [1e-3, 1e-3, 1.0]]).astype(np.float32))
    ref = np.stack([np.asarray(jep.symmetric_epipolar_distance(
        jnp.asarray(F), jnp.asarray(x0), jnp.asarray(x1))) for F in Fs])
    got = ep.symmetric_epipolar_distance(
        torch.from_numpy(np.stack(Fs) if batched else Fs[0]),
        torch.from_numpy(x0), torch.from_numpy(x1)).numpy()
    # (plus 1e-3 px^2 for points near a line, where the product cancels)
    np.testing.assert_allclose(got.reshape(ref.shape), ref, rtol=1e-5,
                               atol=1e-3)


def _padded(n_pad=256, seed=3):
    x0, x1, truth = epipolar_pair(seed=seed)
    pk0 = np.zeros((n_pad, 2), np.float32)
    pk1 = np.zeros((n_pad, 2), np.float32)
    pk0[:len(x0)], pk1[:len(x0)] = x0, x1
    return pk0, pk1, np.arange(n_pad) < len(x0), truth


@pytest.mark.parametrize("guided", [False, True])
def test_magsac_with_jax_samples(guided):
    pk0, pk1, mask, _ = _padded()
    g = np.random.default_rng(0).uniform(size=len(mask)).astype(np.float32) \
        if guided else None
    key = jax.random.PRNGKey(7)
    jg = None if g is None else jnp.asarray(g)
    F_j, inl_j = jr.ransac_fundamental_magsac(
        key, *(jnp.asarray(a) for a in (pk0, pk1, mask)), sigma_max=1.0,
        n_hypotheses=512, guidance=jg)
    idx = jr.sample_minimal_sets(key, jnp.asarray(mask), 512, 8, jg)
    F_p, inl_p = rs.ransac_fundamental_magsac(
        None, *(torch.from_numpy(a) for a in (pk0, pk1, mask)),
        sigma_max=1.0, n_hypotheses=512,
        guidance=None if g is None else torch.from_numpy(g),
        idx=torch.from_numpy(np.asarray(idx, np.int64)))
    np.testing.assert_array_equal(inl_p.numpy(), np.asarray(inl_j))
    # the polish weights are continuous in the residuals: F is held by
    # the distances it gives the inliers
    inl = np.asarray(inl_j)
    d = [np.sqrt(np.asarray(jep.sampson_distance(
        jnp.asarray(np.asarray(F, np.float32)), jnp.asarray(pk0[inl]),
        jnp.asarray(pk1[inl])))) for F in (F_p.numpy(), F_j)]
    assert np.abs(d[0] - d[1]).max() <= 0.01


@pytest.mark.parametrize("seed", [3, 5])
def test_magsac_by_outcome(seed):
    pk0, pk1, mask, truth = _padded(seed=seed)
    n = len(truth)
    _, inl_j = jr.ransac_fundamental_magsac(
        jax.random.PRNGKey(0), *(jnp.asarray(a) for a in (pk0, pk1, mask)),
        sigma_max=1.0)
    _, inl_p = rs.ransac_fundamental_magsac(
        torch.Generator().manual_seed(0),
        *(torch.from_numpy(a) for a in (pk0, pk1, mask)), sigma_max=1.0)
    inl_j, inl_p = np.asarray(inl_j)[:n], inl_p.numpy()[:n]
    assert not inl_j[~truth].any() and not inl_p[~truth].any()
    assert abs(int(inl_p.sum()) - int(inl_j.sum())) <= 0.03 * inl_j.sum()
    assert inl_j.sum() >= 0.9 * truth.sum()


def test_geometric_verification_magsac():
    x0, x1, truth = epipolar_pair(seed=5)
    F_p, inl_p = geometric_verification(
        x0, x1, method=GeometricVerification.MAGSAC, threshold=1.0,
        device="cpu")
    F_j, inl_j = j_geometric_verification(x0, x1, method=JGV.MAGSAC,
                                          threshold=1.0)
    assert F_p.dtype == np.float64 and F_p.shape == (3, 3)
    assert not inl_j[~truth].any() and not inl_p[~truth].any()
    assert abs(int(inl_p.sum()) - int(inl_j.sum())) <= 0.03 * inl_j.sum()


def test_matcher_with_magsac():
    """sigma_max 1 px on the shifted pair (a pure translation of a
    plane: F is degenerate, and matches slid along the shift stay
    consistent with it, so at 1.5 px both packages keep 83%)."""
    img0, img1 = shifted_pair()
    m = LightGlueMatcher({"max_keypoints": 512,
                          "activation_dtype": "float32"}, device="cpu")
    m.match(img0, img1, quality=Quality.HIGH,
            tile_selection=TileSelection.NONE,
            geometric_verification=GeometricVerification.NONE)
    put0, put1, conf = m.mkpts0, m.mkpts1, m.mconf
    m.match(img0, img1, quality=Quality.HIGH,
            tile_selection=TileSelection.NONE,
            geometric_verification=GeometricVerification.MAGSAC,
            threshold=1.0)
    assert len(m.mkpts0) > 50 and m.F is not None
    err = np.linalg.norm(m.mkpts0 - m.mkpts1 - [DX, DY], axis=1)
    assert (err < 1.5).mean() >= 0.9
    _, inl_j = j_geometric_verification(put0, put1, method=JGV.MAGSAC,
                                        threshold=1.0, scores=conf)
    assert abs(len(m.mkpts0) - int(inl_j.sum())) <= 0.03 * inl_j.sum()
