"""The port's NearestNeighborMatcher and SIFTMatcher == icepy4d_tpu's.

`_nn` (mutual cosine NN with the similarity floor and optional ratio;
SIFT's Lowe ratio on 1 - s, with and without the mutual check) and
`_nn_epipolar` (the point-line band in both images, the lone in-band
candidate rule, mutual and the floor) give equal matches0 on every row
whose best and runner-up similarities are more than 1e-6 apart; the
float32 products of two libraries round differently inside that gap.
`SIFTMatcher.match` on a pair shifted by (16, 8) px, with and without a
fundamental prior: putatives within 1%, verified counts within 3% (the
two packages draw their RANSAC samples from different generators)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.matching import GeometricVerification as JGV
from icepy4d_tpu.matching import NearestNeighborMatcher as JNN
from icepy4d_tpu.matching import Quality as JQuality
from icepy4d_tpu.matching import SIFTMatcher as JSIFT
from icepy4d_tpu.matching import TileSelection as JTS
from icepy4d_tpu_torch.matching import (GeometricVerification,
                                        NearestNeighborMatcher, Quality,
                                        SIFTMatcher, TileSelection)
from torch_port_inputs import DX, DY, shifted_pair, superpoint_tree


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for the port: the suite runs several test
    files at once on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TIE = 1e-6


def _descriptors(b, m, n, d, seed):
    """Unit descriptors; the first half of side 1 are noisy copies of
    side 0's rows, so that matches exist; a few padded slots masked."""
    rng = np.random.default_rng(seed)
    d0 = rng.normal(size=(b, m, d)).astype(np.float32)
    d1 = rng.normal(size=(b, n, d)).astype(np.float32)
    d1[:, : n // 2] = d0[:, : n // 2] + 0.4 * rng.normal(
        size=(b, n // 2, d)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    mask0 = np.ones((b, m), bool)
    mask1 = np.ones((b, n), bool)
    mask0[:, -5:] = False
    mask1[:, -7:] = False
    return d0, d1, mask0, mask1


def _tie_rows(sim: np.ndarray) -> np.ndarray:
    """Rows whose top two similarities, or whose best column's top two
    rows, are within TIE."""
    srt = np.sort(sim, axis=-1)
    rows = srt[..., -1] - srt[..., -2] < TIE
    col = np.sort(sim, axis=1)
    cols = col[:, -1] - col[:, -2] < TIE                 # (B, N)
    best = sim.argmax(-1)
    return rows | np.take_along_axis(cols, best, 1)


def _check(got, ref, sim):
    m_p, s_p = (a.numpy() for a in got)
    m_j, s_j = (np.asarray(a) for a in ref)
    keep = ~_tie_rows(sim)
    assert (m_j > -1).sum() > 20
    np.testing.assert_array_equal(m_p[keep], m_j[keep])
    np.testing.assert_allclose(s_p[keep], s_j[keep], atol=1e-6)


def _masked_sim(d0, d1, mask0, mask1, extra=None):
    sim = np.einsum("bmd,bnd->bmn", d0.astype(np.float64),
                    d1.astype(np.float64))
    ok = mask0[:, :, None] & mask1[:, None, :]
    if extra is not None:
        ok &= extra
    return np.where(ok, sim, -1e30)


@pytest.fixture(scope="module")
def sp_opt():
    return {"superpoint_params": superpoint_tree(seed=2),
            "max_keypoints": 256}


@pytest.mark.parametrize("ratio", [None, 0.9])
def test_nn_matches_jax(sp_opt, ratio):
    opt = dict(sp_opt, distance_threshold=0.5)
    if ratio is not None:
        opt["ratio_threshold"] = ratio
    d0, d1, m0, m1 = _descriptors(2, 300, 280, 256, seed=1)
    ref = JNN(opt)._nn(*(jnp.asarray(a) for a in (d0, d1, m0, m1)))
    got = NearestNeighborMatcher(opt, device="cpu")._nn(
        *(torch.from_numpy(a) for a in (d0, d1, m0, m1)))
    _check(got, ref, _masked_sim(d0, d1, m0, m1))


@pytest.mark.parametrize("mutual", [False, True])
def test_sift_nn_matches_jax(mutual):
    opt = {"max_keypoints": 512, "mutual": mutual}
    d0, d1, m0, m1 = _descriptors(2, 300, 280, 128, seed=2)
    ref = JSIFT(opt)._nn(*(jnp.asarray(a) for a in (d0, d1, m0, m1)))
    got = SIFTMatcher(opt, device="cpu")._nn(
        *(torch.from_numpy(a) for a in (d0, d1, m0, m1)))
    _check(got, ref, _masked_sim(d0, d1, m0, m1))


def test_nn_epipolar_matches_jax():
    opt = {"max_keypoints": 512, "guided_band_px": 6.0}
    d0, d1, m0, m1 = _descriptors(1, 400, 380, 128, seed=3)
    rng = np.random.default_rng(4)
    k0 = rng.uniform(0, 400, size=(1, 400, 2)).astype(np.float32)
    k1 = k0[:, :380] - np.float32([DX, DY]) + rng.normal(
        scale=2.0, size=(1, 380, 2)).astype(np.float32)
    # pure image translation: F = [e]_x with e = (DX, DY, 0)
    F = np.array([[0, 0, DY], [0, 0, -DX], [-DY, DX, 0]], np.float32)
    band = np.float32(6.0)
    ref = JSIFT(opt)._nn_epipolar(*(jnp.asarray(a) for a in (
        d0, d1, k0, k1, m0, m1, F)), jnp.float32(band))
    got = SIFTMatcher(opt, device="cpu")._nn_epipolar(
        *(torch.from_numpy(a) for a in (d0, d1, k0, k1, m0, m1)), F,
        float(band))
    h0 = np.concatenate([k0, np.ones_like(k0[..., :1])], -1)
    h1 = np.concatenate([k1, np.ones_like(k1[..., :1])], -1)
    l1 = h0 @ F.T.astype(np.float64)
    l0 = h1 @ F.astype(np.float64)
    num = np.abs(np.einsum("bir,bjr->bij", l1, h1))
    inband = (num / np.linalg.norm(l1[..., :2], axis=-1)[:, :, None] < band) \
        & (num / np.linalg.norm(l0[..., :2], axis=-1)[:, None, :] < band)
    # rows with a candidate at the band's edge are ties of the band test
    edge = np.abs(num / np.linalg.norm(l1[..., :2], axis=-1)[:, :, None]
                  - band) < 1e-4
    sim = _masked_sim(d0, d1, m0, m1, inband)
    sim[edge.any(-1)] = 0.0        # forces those rows into the tie set
    assert inband.sum() > 400
    _check(got, ref, sim)


def _run(m, images, enums, **kw):
    GV, Q, TS = enums
    m.match(*images, quality=Q.HIGH, tile_selection=TS.NONE,
            geometric_verification=GV.PYDEGENSAC, threshold=2.0, **kw)
    return len(m.inlier_mask), len(m.mkpts0)


@pytest.mark.parametrize("prior", [False, True])
def test_sift_matcher_match_agrees(prior):
    a, b = shifted_pair(240, 320)
    opt = {"max_keypoints": 1024, "dual_orientation": False}
    F = np.array([[0, 0, DY], [0, 0, -DX], [-DY, DX, 0]], np.float32)
    kw = {"F_prior": F} if prior else {}
    jm = JSIFT(opt)
    pm = SIFTMatcher(opt, device="cpu")
    j_put, j_ver = _run(jm, (a, b), (JGV, JQuality, JTS), **kw)
    p_put, p_ver = _run(pm, (a, b), (GeometricVerification, Quality,
                                     TileSelection), **kw)
    assert j_ver > 100
    assert abs(p_put - j_put) <= 0.01 * j_put, (p_put, j_put)
    assert abs(p_ver - j_ver) <= 0.03 * j_ver, (p_ver, j_ver)
    err = np.linalg.norm(pm.mkpts0 - pm.mkpts1 - [DX, DY], axis=1)
    assert np.median(err) < 0.5
