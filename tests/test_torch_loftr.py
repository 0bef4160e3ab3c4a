"""The port's LoFTR (`models/loftr.py`) and `LoFTRMatcher` ==
icepy4d_tpu's, on seeded inputs (random weights at the published
architecture).

The backbone's coarse and fine maps within 2e-4 (the JAX package's own
bar against its torch oracle), the position encoding within 1e-6, the
coarse confidences within 1e-6 abs (measured 1.1e-6 relative to their
1e-4 scale), the coarse match indices equal and the fine keypoints
within 1e-3 px (measured 9.5e-6). The match cap is a top-k over the
confidences, so match sets are compared, never slots. A kornia-layout
checkpoint (tests/oracle_loftr.py) goes through the port's loader and
the JAX converter alike; a frame past MAX_COARSE_TOKENS raises the JAX
package's error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.matching import GeometricVerification as JGV
from icepy4d_tpu.matching import LoFTRMatcher as JLoFTRMatcher
from icepy4d_tpu.matching import TileSelection as JTS
from icepy4d_tpu.models import loftr as J
from icepy4d_tpu.models.convert import loftr_params_from_torch
from icepy4d_tpu_torch.matching import (GeometricVerification, LOFTRMatcher,
                                        LoFTRMatcher, TileSelection)
from icepy4d_tpu_torch.models import loftr as P
from icepy4d_tpu_torch.models.convert import load_torch_loftr, loftr_params
from oracle_loftr import LoFTR as OracleLoFTR
from torch_port_inputs import shifted_pair

THR = 1e-8      # random weights: the dual-softmax confidences are tiny


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    t = P.loftr_tree(seed=0)
    rng = np.random.default_rng(5)

    def stats(node):
        if isinstance(node, dict):
            if "mean" in node:
                c = node["mean"].shape[0]
                node["mean"] = (0.1 * rng.normal(size=c)).astype(np.float32)
                node["var"] = rng.uniform(0.75, 1.25, c).astype(np.float32)
            for v in node.values():
                stats(v)
        elif isinstance(node, list):
            for v in node:
                stats(v)

    stats(t["backbone"])
    return t


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(3)
    img0 = rng.uniform(0, 1, (64, 96)).astype(np.float32)
    img1 = np.roll(img0, (8, 16), axis=(0, 1))
    img1 = np.clip(img1 + rng.normal(0, 0.05, img1.shape), 0,
                   1).astype(np.float32)
    return img0, img1


def _models(tree, **kw):
    j = J.LoFTR(thr=THR, max_matches=128, precision="highest", **kw)
    p = P.LoFTR(thr=THR, max_matches=128, device="cpu", **kw)
    p.load_state_dict(loftr_params(tree))
    return j, p


def test_pos_encoding():
    for fix in (False, True):
        np.testing.assert_allclose(P.sine_pos_encoding(256, 12, 20, fix),
                                   J.sine_pos_encoding(256, 12, 20, fix),
                                   atol=1e-6)


def test_backbone(tree, pair):
    _, p = _models(tree)
    with jax.default_matmul_precision("highest"):
        fc_j, ff_j = J.backbone_apply(
            jax.tree.map(jnp.asarray, tree["backbone"]),
            jnp.asarray(pair[0])[None, ..., None])
    with torch.no_grad():
        fc_p, ff_p = p.net.backbone(torch.from_numpy(pair[0])[None, None])
    np.testing.assert_allclose(fc_p[0].numpy().transpose(1, 2, 0),
                               np.asarray(fc_j[0]), atol=2e-4)
    np.testing.assert_allclose(ff_p[0].numpy().transpose(1, 2, 0),
                               np.asarray(ff_j[0]), atol=2e-4)


def test_coarse_and_fine_match(tree, pair):
    """The coarse transformer's confidences, the coarse matches and the
    fine stage, step by step against the JAX functions."""
    _, p = _models(tree)
    img0, img1 = (torch.from_numpy(a)[None] for a in pair)
    cells = torch.ones((1, 8 * 12), dtype=torch.bool)
    with torch.no_grad():
        c0, c1, ff0, ff1, hw0, hw1 = p.coarse_features(img0, img1, cells,
                                                       cells)
        conf = p.coarse_confidence(c0, c1, cells, cells)
    # the JAX dual softmax on the port's own coarse features
    n0 = jnp.asarray(c0[0].numpy()) / 16.0
    n1 = jnp.asarray(c1[0].numpy()) / 16.0
    sim = jnp.einsum("lc,sc->ls", n0, n1,
                     precision="highest") / 0.1
    ref = jax.nn.softmax(sim, 0) * jax.nn.softmax(sim, 1)
    np.testing.assert_allclose(conf[0].numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-4)
    m = jnp.ones(96, bool)
    ri, rj, rv, rvalid = J.coarse_match(jnp.asarray(conf[0].numpy()), m, m,
                                        hw0, hw1, THR, 2, 64)
    gi, gj, gv, gvalid = P.coarse_match(conf, cells, cells, hw0, hw1, THR,
                                        2, 64)
    valid = np.asarray(rvalid)
    assert valid.sum() >= 3
    np.testing.assert_array_equal(gvalid[0].numpy(), valid)
    assert set(zip(gi[0].numpy()[valid], gj[0].numpy()[valid])) \
        == set(zip(np.asarray(ri)[valid], np.asarray(rj)[valid]))
    # fine: windows, then the centre-against-window expectation
    win_j = J._gather_windows(jnp.asarray(ff0[0].numpy()), ri, 12, 5, 4)
    win_p = P.gather_windows(ff0, torch.from_numpy(np.asarray(ri))[None],
                             12, 5, 4)
    np.testing.assert_array_equal(win_p[0].numpy(), np.asarray(win_j))
    f1 = P.gather_windows(ff1, torch.from_numpy(np.asarray(rj))[None], 12,
                          5, 4)
    coords_j, std_j = J.fine_match(win_j, jnp.asarray(f1[0].numpy()), 5)
    coords_p, std_p = P.fine_match(win_p, f1, 5)
    np.testing.assert_allclose(coords_p[0].numpy(), np.asarray(coords_j),
                               atol=1e-5)
    np.testing.assert_allclose(std_p[0].numpy(), np.asarray(std_j),
                               atol=1e-5)


def _match_sets(out_p, out_j, b=0):
    vj = np.asarray(out_j["valid"])
    vp = out_p["valid"].numpy()
    if vj.ndim == 1:
        vj = vj[None]
        out_j = {k: np.asarray(v)[None] for k, v in out_j.items()}
    assert vj[b].sum() >= 3
    np.testing.assert_array_equal(vp[b].sum(), vj[b].sum())

    def table(out, valid):
        k0 = np.asarray(out["keypoints0"])[b][valid]
        k1 = np.asarray(out["keypoints1"])[b][valid]
        cf = np.asarray(out["confidence"])[b][valid]
        return {tuple(a): (c, d) for a, c, d in zip(k0.tolist(), k1, cf)}

    tj = table(out_j, vj[b])
    tp = table({k: v.numpy() for k, v in out_p.items()}, vp[b])
    assert tj.keys() == tp.keys()
    for key, (k1, cf) in tj.items():
        np.testing.assert_allclose(tp[key][0], k1, atol=1e-3)
        np.testing.assert_allclose(tp[key][1], cf, rtol=1e-4, atol=1e-9)


def test_match_pair_and_batch(tree, pair):
    j, p = _models(tree)
    jt = jax.tree.map(jnp.asarray, tree)
    _match_sets(p.match_pair(*pair), j.match_pair(jt, *pair))
    # an odd size: padded to the 8-px grid, pad cells masked
    odd = [a[:61, :90] for a in pair]
    _match_sets(p.match_pair(*odd), j.match_pair(jt, *odd))
    ims0 = np.stack([pair[0], pair[1]])
    ims1 = np.stack([pair[1], pair[0]])
    pv = np.array([True, True])
    out_j = j.match_batch(jt, jnp.asarray(ims0), jnp.asarray(ims1),
                          jnp.asarray(pv))
    out_p = p.match_batch(ims0, ims1, pv)
    for b in range(2):
        _match_sets(out_p, out_j, b)
    assert not p.match_batch(ims0, ims1, np.array([True, False]))[
        "valid"][1].any()


def test_load_torch_loftr(pair):
    """kornia's key layout (with the official "matcher." prefix) through
    the port's loader and the JAX converter."""
    torch.manual_seed(0)
    oracle = OracleLoFTR(temp_bug_fix=False, thr=THR).eval()
    sd = {f"matcher.{k}": v for k, v in oracle.state_dict().items()}
    j = J.LoFTR(thr=THR, max_matches=128, precision="highest")
    p = P.LoFTR(thr=THR, max_matches=128, device="cpu")
    p.load_state_dict(load_torch_loftr({"state_dict": sd}))
    jt = jax.tree.map(jnp.asarray, loftr_params_from_torch(sd))
    _match_sets(p.match_pair(*pair), j.match_pair(jt, *pair))


def test_oversized_frame_raises(tree):
    _, p = _models(tree)
    big = np.zeros((8 * 182, 8 * 182), np.float32)      # 33124 tokens
    with pytest.raises(ValueError, match="MAX_COARSE_TOKENS|tokens") as e:
        p.match_pair(big, big)
    with pytest.raises(ValueError) as ej:
        J.LoFTR().match_pair({}, big, big)
    assert str(e.value) == str(ej.value)


@pytest.mark.parametrize("tiled", [False, True])
def test_loftr_matcher_agrees(tree, tiled):
    a, b = shifted_pair(160, 224)
    opt = {"confidence_threshold": 1e-5, "max_matches": 256,
           "precision": "highest"}
    kw = {"geometric_verification": GeometricVerification.NONE}
    jkw = {"geometric_verification": JGV.NONE}
    if tiled:
        kw.update(tile_selection=TileSelection.GRID, grid=[2, 2], overlap=40)
        jkw.update(tile_selection=JTS.GRID, grid=[2, 2], overlap=40)
    jm = JLoFTRMatcher(dict(opt, matcher_params=jax.tree.map(jnp.asarray,
                                                             tree)))
    jm.match(a, b, **jkw)
    pm = LoFTRMatcher(dict(opt, matcher_params=tree), device="cpu")
    pm.match(a, b, **kw)
    assert len(jm.mkpts0) >= 20
    got = {tuple(k): v for k, v in zip(np.round(pm.mkpts0, 2).tolist(),
                                       pm.mkpts1)}
    ref = {tuple(k): v for k, v in zip(np.round(jm.mkpts0, 2).tolist(),
                                       jm.mkpts1)}
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, atol=1e-3)
    assert pm.descriptors0.shape[0] == 128
    with pytest.raises(NotImplementedError, match="detector-free"):
        pm._extract(None, 0)
    assert LOFTRMatcher is LoFTRMatcher
