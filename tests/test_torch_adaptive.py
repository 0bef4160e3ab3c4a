"""The port's adaptive LightGlue (early exit and point pruning) against
icepy4d_tpu's `match_adaptive`, mirroring tests/test_lightglue_adaptive.py
on the same random weights (6 layers, d = 256, 4 heads, f32): with no
trigger it equals the static forward; a forced early exit runs the same
number of layers and equals a truncated static forward; forced pruning
keeps the same capacity, and the match indices equal the JAX package's
exactly, as tests/test_torch_lightglue.py holds the static forward;
`LightGlueMatcher(adaptive=True)` gives the JAX matcher's matches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.matching import (GeometricVerification as JGV,
                                  LightGlueMatcher as JLightGlueMatcher,
                                  Quality as JQuality,
                                  TileSelection as JTileSelection)
from icepy4d_tpu.models.lightglue import LightGlue as JLightGlue
from icepy4d_tpu_torch.matching import (GeometricVerification,
                                        LightGlueMatcher, Quality,
                                        TileSelection)
from icepy4d_tpu_torch.models.convert import lightglue_params
from icepy4d_tpu_torch.models.lightglue import LightGlue
from test_lightglue_adaptive import _force_confidence, _make_data
from torch_port_inputs import REPO_WEIGHTS, lightglue_tree, shifted_pair


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    """The JAX package's own initial weights, as its test uses them
    (their matchability straddles 0.5, so pruning at 0.5 halves a
    side)."""
    return jax.tree.map(np.asarray, JLightGlue(n_layers=6).init(
        jax.random.PRNGKey(0)))


def _models(tree, n_layers=6):
    jlg = JLightGlue(n_layers=n_layers, filter_threshold=0.0,
                     precision="highest")
    lg = LightGlue(n_layers=n_layers, filter_threshold=0.0, device="cpu")
    lg.load_state_dict(lightglue_params(tree))
    return jlg, jax.tree.map(jnp.asarray, tree), lg


def _both(tree, data, **kw):
    jlg, jparams, lg = _models(tree)
    ref = jlg.match_adaptive(jparams, data, **kw)
    out = lg.match_adaptive({k: torch.from_numpy(np.ascontiguousarray(v))
                             for k, v in data.items()}, **kw)
    return out, ref, lg


def _equal_matches(out, ref):
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(out[k].numpy(), ref[k])
    np.testing.assert_allclose(out["mscores0"].numpy(), ref["mscores0"],
                               atol=1e-5)


def test_no_trigger_equals_static(tree):
    data, _ = _make_data(np.random.default_rng(0))
    out, ref, lg = _both(tree, data, check_every=2)
    assert out["layers_run"] == ref["layers_run"] == 6
    assert out["capacity"] == ref["capacity"] == 96
    _equal_matches(out, ref)
    static = lg.match({k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in data.items()})
    np.testing.assert_array_equal(out["matches0"].numpy(),
                                  static["matches0"].numpy())


def test_forced_early_exit(tree):
    forced = _force_confidence(tree, +10.0)
    data, _ = _make_data(np.random.default_rng(1))
    out, ref, _ = _both(forced, data, check_every=2)
    assert out["layers_run"] == ref["layers_run"] == 2
    _equal_matches(out, ref)
    # a static forward truncated at layer 2 with that layer's head
    short = {"input_proj": tree["input_proj"], "posenc": tree["posenc"],
             "layers": tree["layers"][:2], "assign": tree["assign"][:2],
             "confidence": tree["confidence"][:1]}
    lg2 = LightGlue(n_layers=2, filter_threshold=0.0, device="cpu")
    lg2.load_state_dict(lightglue_params(short))
    static = lg2.match({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in data.items()})
    np.testing.assert_array_equal(out["matches0"].numpy(),
                                  static["matches0"].numpy())


@pytest.mark.parametrize("padded", [False, True])
def test_forced_pruning(tree, padded):
    """Half the tokens pruned into a 64-slot capacity at the first
    checkpoint; with `padded` a quarter of each side's slots are masked
    padding before it."""
    forced = _force_confidence(tree, +10.0)
    data, perm = _make_data(np.random.default_rng(2), m=128, n=128)
    if padded:
        data["mask0"] = data["mask0"].copy()
        data["mask1"] = data["mask1"].copy()
        data["mask0"][:, 96:] = False
        data["mask1"][0, 100:] = False
    out, ref, _ = _both(forced, data, depth_confidence=0.0,
                        width_confidence=0.5, check_every=2, min_capacity=16)
    assert out["capacity"] == ref["capacity"] <= 64
    assert out["layers_run"] == ref["layers_run"] == 6
    _equal_matches(out, ref)
    m0 = out["matches0"].numpy()
    b_idx, s_idx = np.nonzero(m0 > -1)
    assert len(s_idx) > 0
    if not padded:          # (padding masks some true partners)
        assert (m0[b_idx, s_idx] == np.argsort(perm)[s_idx]).mean() > 0.9


def test_gather_side_keeps_index_order():
    """Kept tokens first and each group in index order: the order of the
    JAX package's top-k on 0/1 scores (torch.topk promises none)."""
    keep = torch.tensor([[False, True, False, True, True, False]])
    d = torch.arange(6.0).reshape(1, 6, 1)
    *_, mask, idx = LightGlue._gather_side(d, d, d, keep, 4)
    assert idx.tolist() == [[1, 3, 4, 0]]
    assert mask.tolist() == [[True, True, True, False]]


def _same_rows(a0, a1, b0, b1):
    """The same matches, in any order (as tests/test_torch_matcher.py
    holds the static matcher)."""
    p, r = np.c_[a0, a1], np.c_[b0, b1]
    np.testing.assert_array_equal(p[np.lexsort(p.T)], r[np.lexsort(r.T)])


def _matcher_opts(params):
    return {"max_keypoints": 256, "filter_threshold": 0.0, "n_layers": 4,
            "adaptive": True, "matcher_params": params,
            "superpoint_weights": str(REPO_WEIGHTS
                                      / "superpoint_synthetic.npz"),
            "activation_dtype": "float32"}


def test_adaptive_via_matcher_surface():
    """As tests/test_lightglue_adaptive.py drives the JAX matcher: an
    8-px shifted pair, 4 random-weight layers; both packages give the
    same matches, and they recover the shift."""
    import cv2

    rng = np.random.default_rng(5)
    lo = rng.uniform(size=(30, 41)).astype(np.float32)
    base = cv2.resize(lo, (328, 240), interpolation=cv2.INTER_CUBIC)
    base = np.clip(base * 255, 0, 255).astype(np.uint8)
    img0, img1 = base[:, :320], base[:, 8:]
    params = lightglue_tree(4, 256, 4, seed=1)
    m = LightGlueMatcher(_matcher_opts(params), device="cpu")
    jm = JLightGlueMatcher(_matcher_opts(jax.tree.map(jnp.asarray, params)))
    m.match(img0, img1, quality=Quality.HIGH,
            tile_selection=TileSelection.NONE,
            geometric_verification=GeometricVerification.NONE)
    jm.match(img0, img1, quality=JQuality.HIGH,
             tile_selection=JTileSelection.NONE,
             geometric_verification=JGV.NONE)
    assert len(m.mkpts0) > 20 and m.adaptive_runs == [(4, 256)]
    _same_rows(m.mkpts0, m.mkpts1, jm.mkpts0, jm.mkpts1)
    assert abs(np.median(m.mkpts0[:, 0] - m.mkpts1[:, 0]) - 8.0) < 1.0


def test_adaptive_matcher_bundled_weights():
    """The bundled 9-layer checkpoint at the default confidences on the
    shifted pair: it exits early, with the same putatives as the JAX
    package's adaptive matcher."""
    img0, img1 = shifted_pair()
    opts = {"max_keypoints": 512, "adaptive": True,
            "activation_dtype": "float32",
            "superpoint_weights": str(REPO_WEIGHTS / "superpoint_synthetic.npz"),
            "lightglue_weights": str(REPO_WEIGHTS / "lightglue_synthetic.npz")}
    m = LightGlueMatcher(opts, device="cpu")
    jm = JLightGlueMatcher(opts)
    m.match(img0, img1, quality=Quality.HIGH,
            tile_selection=TileSelection.NONE,
            geometric_verification=GeometricVerification.NONE)
    jm.match(img0, img1, quality=JQuality.HIGH,
             tile_selection=JTileSelection.NONE,
             geometric_verification=JGV.NONE)
    assert len(m.mkpts0) > 100
    _same_rows(m.mkpts0, m.mkpts1, jm.mkpts0, jm.mkpts1)
    assert m.adaptive_runs[0][0] < 9
