"""The port's SuperGlue (`icepy4d_tpu_torch/models/superglue.py`) and
`SuperGlueMatcher` == icepy4d_tpu's, on seeded numpy inputs.

The keypoint encoder, one attentional-propagation layer and the whole
forward (padded and unpadded keypoint sets) agree within 1e-4 abs on
the log assignment (measured 3.4e-5 over 4 layers and 20 Sinkhorn
iterations: two libraries' logsumexp and matmul orders); matches are
equal except on rows whose best assignment probability lies within
1e-5 of the threshold. The port keeps q / k / v and the merge in a
head-major channel order, so the kernel reads unit-stride heads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.matching import GeometricVerification as JGV
from icepy4d_tpu.matching import SuperGlueMatcher as JSGM
from icepy4d_tpu.matching import TileSelection as JTS
from icepy4d_tpu.models import superglue as J
from icepy4d_tpu.models.convert import superglue_params_from_torch
from icepy4d_tpu_torch.matching import (GeometricVerification,
                                        SuperGlueMatcher, TileSelection)
from icepy4d_tpu_torch.models import superglue as P
from icepy4d_tpu_torch.models.convert import (load_torch_superglue,
                                              superglue_params)
from torch_port_inputs import shifted_pair, superpoint_tree

LAYERS = 4
ITERS = 20
TH = 0.02   # random weights: the best probabilities lie at 0.01-0.05
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    """Random weights with non-trivial batch-norm statistics."""
    t = P.superglue_tree(gnn_layers=LAYERS, seed=3)
    rng = np.random.default_rng(4)
    mlps = t["kenc"][:-1] + [m for g in t["gnn"] for m in g["mlp"][:-1]]
    for layer in mlps:
        c = layer["bn"]["mean"].shape[0]
        layer["bn"]["mean"] = (0.1 * rng.normal(size=c)).astype(np.float32)
        layer["bn"]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        layer["bn"]["scale"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
        layer["bn"]["bias"] = (0.1 * rng.normal(size=c)).astype(np.float32)
    t["bin_score"] = np.float32(0.7)
    return t


def _model(tree, iters=ITERS, th=TH):
    m = P.SuperGlue(gnn_layers=len(tree["gnn"]), sinkhorn_iterations=iters,
                    match_threshold=th, device="cpu")
    m.load_state_dict(superglue_params(tree))
    return m


def _jmodel(n_layers, iters=ITERS, th=TH):
    return J.SuperGlue(gnn_layers=n_layers, sinkhorn_iterations=iters,
                       match_threshold=th, precision="highest")


def _data(b=2, m=48, n=56, seed=0):
    """Two keypoint sets; side 1's first 30 are noisy copies of side 0's;
    a few slots of each side padded (masked)."""
    rng = np.random.default_rng(seed)
    d = {"kpts0": rng.uniform(0, 300, (b, m, 2)),
         "kpts1": rng.uniform(0, 300, (b, n, 2)),
         "desc0": rng.normal(size=(b, m, 256)),
         "desc1": rng.normal(size=(b, n, 256)),
         "scores0": rng.uniform(size=(b, m)),
         "scores1": rng.uniform(size=(b, n)),
         "size0": np.full((b, 2), [320, 300]),
         "size1": np.full((b, 2), [320, 300])}
    d["desc1"][:, :30] = d["desc0"][:, :30] + 0.2 * rng.normal(
        size=(b, 30, 256))
    d["kpts1"][:, :30] = d["kpts0"][:, :30] + 3.0
    for k in ("desc0", "desc1"):
        d[k] /= np.linalg.norm(d[k], axis=-1, keepdims=True)
    d = {k: v.astype(np.float32) for k, v in d.items()}
    d["mask0"] = np.ones((b, m), bool)
    d["mask1"] = np.ones((b, n), bool)
    d["mask0"][:, -5:] = False
    d["mask1"][0, -9:] = False
    return d


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def test_random_init_matches_jax_init():
    """Seeded random weights are the JAX package's own draws."""
    a = jax.tree.map(np.asarray, _jmodel(LAYERS).init(5))
    b = P.superglue_tree(gnn_layers=LAYERS, seed=5)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x, np.float32), y)


def test_keypoint_encoder(tree):
    d = _data()
    m = _model(tree)
    kn = J.normalize_keypoints(jnp.asarray(d["kpts0"]),
                               jnp.asarray(d["size0"]))
    ref = J.keypoint_encoder(jax.tree.map(jnp.asarray, tree["kenc"]), kn,
                             jnp.asarray(d["scores0"]))
    knp = P.normalize_keypoints(torch.from_numpy(d["kpts0"]),
                                torch.from_numpy(d["size0"]))
    np.testing.assert_allclose(knp.numpy(), np.asarray(kn), atol=1e-6)
    with torch.no_grad():
        got = P.keypoint_encoder(m.kenc, knp, torch.from_numpy(d["scores0"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("cross", [False, True])
def test_one_layer(tree, cross):
    """A self (source = x) or cross layer of the permuted module equals
    the JAX layer in the checkpoint's c = d * H + h order."""
    d = _data()
    m = _model(tree)
    x = d["desc0"]
    src, mask = (d["desc1"], d["mask1"]) if cross else (x, d["mask0"])
    with jax.default_matmul_precision("highest"):
        ref = J._attn_propagation(
            jax.tree.map(jnp.asarray, tree["gnn"][int(cross)]),
            jnp.asarray(x), jnp.asarray(src), jnp.asarray(mask), 4)
    with torch.no_grad():
        got = P.attn_propagation(m.gnn[int(cross)], torch.from_numpy(x),
                                 torch.from_numpy(src),
                                 torch.from_numpy(mask), 4)
    valid = d["mask0"]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(ref)[valid],
                               atol=ATOL)


def test_head_order_gives_unit_stride_heads(tree):
    """head_order is a permutation, and the heads the layers hand to the
    attention are (B, N, H, hd) views with unit stride in hd and every
    other stride a multiple of 8 elements: the kernel's tensor maps take
    them without a copy."""
    perm = P.head_order(256, 4)
    assert sorted(perm.tolist()) == list(range(256))
    assert perm[1] == 4 and perm[64] == 1            # c' = h*64 + d
    seen = []

    def spy(q, k, v, mask):
        seen.extend([q, k, v])
        return P.masked_attention(q, k, v, mask)

    d = _data()
    _model(tree).match(_torch(d), attn=spy)
    assert len(seen) == 3 * 2 * LAYERS
    for t in seen:
        assert t.stride(-1) == 1
        assert all(s % 8 == 0 for s in t.stride()[:3])


def _close_to_threshold(la: np.ndarray, th: float) -> np.ndarray:
    """Rows whose best match probability is within 1e-5 of th."""
    best = np.exp(la[:, :-1, :-1].max(-1))
    return np.abs(best - th) < 1e-5


def _check_forward(got, ref, mask0, mask1, th):
    la_j = np.asarray(ref["log_assignment"])
    la_p = got["log_assignment"].numpy()
    pair = np.zeros_like(la_j, bool)
    pair[:, :-1, :-1] = mask0[:, :, None] & mask1[:, None, :]
    pair[:, :-1, -1] = mask0
    pair[:, -1, :-1] = mask1
    np.testing.assert_allclose(la_p[pair], la_j[pair], atol=ATOL)
    keep = ~_close_to_threshold(la_j, th) & mask0
    m_j = np.asarray(ref["matches0"])
    assert (m_j[keep] > -1).sum() >= 10
    np.testing.assert_array_equal(got["matches0"].numpy()[keep], m_j[keep])


def test_forward_padded_and_unpadded(tree):
    """The whole forward against JAX, and the runtime-marginal
    invariance: extra masked slots change nothing on the valid block."""
    d = _data()
    m = _model(tree)
    got = m.match(_torch(d))
    ref = _jmodel(LAYERS).match(jax.tree.map(jnp.asarray, tree), _jax(d))
    _check_forward(got, ref, d["mask0"], d["mask1"], TH)

    padded = dict(d)
    for side, extra in (("0", 20), ("1", 12)):
        for k in (f"kpts{side}", f"desc{side}", f"scores{side}"):
            a = d[k]
            fill = np.random.default_rng(9).normal(
                size=(a.shape[0], extra) + a.shape[2:]).astype(np.float32)
            padded[k] = np.concatenate([a, fill], 1)
        padded[f"mask{side}"] = np.concatenate(
            [d[f"mask{side}"], np.zeros((2, extra), bool)], 1)
    gp = m.match(_torch(padded))
    la = got["log_assignment"].numpy()
    lp = gp["log_assignment"].numpy()
    m0, m1 = d["mask0"], d["mask1"]
    block = m0[:, :, None] & m1[:, None, :]
    np.testing.assert_allclose(lp[:, :48, :56][block], la[:, :-1, :-1][block],
                               atol=ATOL)
    np.testing.assert_array_equal(gp["matches0"].numpy()[:, :48],
                                  got["matches0"].numpy())


def _official_state_dict(tree) -> dict:
    """The JAX-layout tree written out under the official checkpoint's
    names and shapes (Conv1d weights (O, I, 1), BN running stats)."""
    sd = {}

    def conv(name, lin):
        sd[f"{name}.weight"] = torch.from_numpy(lin["kernel"].T[..., None]
                                                .copy())
        sd[f"{name}.bias"] = torch.from_numpy(lin["bias"].copy())

    def bn(name, p):
        sd[f"{name}.weight"] = torch.from_numpy(p["scale"])
        sd[f"{name}.bias"] = torch.from_numpy(p["bias"])
        sd[f"{name}.running_mean"] = torch.from_numpy(p["mean"])
        sd[f"{name}.running_var"] = torch.from_numpy(p["var"])
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    def mlp(prefix, layers):
        i = 0
        for layer in layers:
            conv(f"{prefix}.{i}", layer["dense"])
            if "bn" in layer:
                bn(f"{prefix}.{i + 1}", layer["bn"])
                i += 3
            else:
                i += 2

    mlp("kenc.encoder", tree["kenc"])
    for li, g in enumerate(tree["gnn"]):
        for j, n in enumerate("qkv"):
            conv(f"gnn.layers.{li}.attn.proj.{j}", g[n])
        conv(f"gnn.layers.{li}.attn.merge", g["merge"])
        mlp(f"gnn.layers.{li}.mlp", g["mlp"])
    conv("final_proj", tree["final_proj"])
    sd["bin_score"] = torch.tensor(float(tree["bin_score"]))
    return sd


def test_load_torch_superglue(tree):
    """The official key layout through the port's loader and the JAX
    package's converter gives the same forward."""
    sd = _official_state_dict(tree)
    m = P.SuperGlue(gnn_layers=LAYERS, sinkhorn_iterations=ITERS,
                    match_threshold=TH, device="cpu")
    m.load_state_dict(load_torch_superglue(sd, n_layers=LAYERS))
    jtree = superglue_params_from_torch(sd, n_layers=LAYERS)
    d = _data(seed=1)
    _check_forward(m.match(_torch(d)),
                   _jmodel(LAYERS).match(jax.tree.map(jnp.asarray, jtree),
                                         _jax(d)),
                   d["mask0"], d["mask1"], TH)


@pytest.mark.parametrize("tiled", [False, True])
def test_superglue_matcher_agrees(tiled):
    """SuperGlueMatcher (SuperPoint at r = 3, scores into the matcher)
    on a shifted pair: the same putative matches as the JAX matcher,
    full frame and on 2x2 exhaustive tiles. The JAX defaults (18 layers,
    random weights from seed 0) with a 0.01 match threshold, under which
    random weights still match."""
    a, b = shifted_pair(160, 200)
    sp = superpoint_tree(seed=2)
    opt = {"max_keypoints": 128, "match_threshold": 0.01}
    kw = {"geometric_verification": GeometricVerification.NONE}
    jkw = {"geometric_verification": JGV.NONE}
    if tiled:
        kw.update(tile_selection=TileSelection.EXHAUSTIVE, grid=[2, 2],
                  overlap=40)
        jkw.update(tile_selection=JTS.EXHAUSTIVE, grid=[2, 2], overlap=40)
    ref = JSGM(dict(opt, superpoint_params=jax.tree.map(jnp.asarray, sp)))
    ref.match(a, b, **jkw)
    got = SuperGlueMatcher(dict(opt, superpoint_params=sp), device="cpu")
    got.match(a, b, **kw)
    assert len(ref.mkpts0) >= 10
    assert len(got.mkpts0) == len(ref.mkpts0)
    np.testing.assert_allclose(got.mkpts0, ref.mkpts0, atol=1e-3)
    np.testing.assert_allclose(got.mkpts1, ref.mkpts1, atol=1e-3)
    np.testing.assert_allclose(got.mconf, ref.mconf, atol=1e-4)
