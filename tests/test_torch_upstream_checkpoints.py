"""Published SuperPoint and LightGlue checkpoints load in the port.

No published file is in the repository, so the bundled
`weights/superpoint_synthetic.npz` and `lightglue_synthetic.npz` trees
stand in for them: renamed to the upstream state-dict keys (conv1a.weight
..., transformers.{i}..., log_assignment.{i}..., token_confidence.{i}
.token.0) and written with torch.save. The port's loaders give the JAX
loaders' trees exactly, and a matcher built from the .pth files matches
exactly as one built from the .npz files."""

import numpy as np
import pytest
import torch

from icepy4d_tpu.matching import GeometricVerification as JGV
from icepy4d_tpu.matching import LightGlueMatcher as JMatcher
from icepy4d_tpu.matching import Quality as JQuality
from icepy4d_tpu.matching import TileSelection as JTileSelection
from icepy4d_tpu.models import convert as jconvert
from icepy4d_tpu_torch.matching import (GeometricVerification,
                                        LightGlueMatcher,
                                        NearestNeighborMatcher, Quality,
                                        SuperGlueMatcher, TileSelection)
from icepy4d_tpu_torch.models import convert
from torch_port_inputs import REPO_WEIGHTS, shifted_pair

SP_NPZ = REPO_WEIGHTS / "superpoint_synthetic.npz"
LG_NPZ = REPO_WEIGHTS / "lightglue_synthetic.npz"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs several test files at once
    on a few cores, and full-width thread pools in each of them slow
    every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def upstream_superpoint(tree: dict) -> dict:
    """JAX-layout SuperPoint tree -> the published state dict."""
    return {f"{n}.{k}": _t(p["kernel"].transpose(3, 2, 0, 1) if k == "weight"
                           else p["bias"])
            for n, p in tree["params"].items() for k in ("weight", "bias")}


def upstream_lightglue(tree: dict, identity_input: bool = False) -> dict:
    """JAX-layout LightGlue tree -> the published state dict (the inverse
    of `lightglue_params_from_torch`'s key map); identity_input drops
    input_proj, as a published 256-d checkpoint has none."""
    sd = {}

    def dense(name, p):
        sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
        if "bias" in p:
            sd[f"{name}.bias"] = _t(p["bias"])

    def ffn(prefix, p):
        dense(f"{prefix}.0", p["dense1"])
        sd[f"{prefix}.1.weight"] = _t(p["norm"]["scale"])
        sd[f"{prefix}.1.bias"] = _t(p["norm"]["bias"])
        dense(f"{prefix}.3", p["dense2"])

    if not identity_input:
        dense("input_proj", tree["input_proj"])
    sd["posenc.Wr.weight"] = _t(np.asarray(tree["posenc"]["Wr"]["kernel"]).T)
    for i, layer in enumerate(tree["layers"]):
        s, c = f"transformers.{i}.self_attn", f"transformers.{i}.cross_attn"
        dense(f"{s}.Wqkv", layer["self_attn"]["Wqkv"])
        dense(f"{s}.out_proj", layer["self_attn"]["out"])
        ffn(f"{s}.ffn", layer["self_attn"]["ffn"])
        dense(f"{c}.to_qk", layer["cross_attn"]["to_qk"])
        dense(f"{c}.to_v", layer["cross_attn"]["to_v"])
        dense(f"{c}.to_out", layer["cross_attn"]["out"])
        ffn(f"{c}.ffn", layer["cross_attn"]["ffn"])
    for i, a in enumerate(tree["assign"]):
        dense(f"log_assignment.{i}.matchability", a["matchability"])
        dense(f"log_assignment.{i}.final_proj", a["final_proj"])
    for i, c in enumerate(tree["confidence"]):
        dense(f"token_confidence.{i}.token.0", c["token"])
    return sd


def assert_trees_equal(a, b, path="") -> None:
    """Same structure, leaves equal bit for bit (dtype included)."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, (list, tuple)):
        assert isinstance(a, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}/{i}")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=path)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("upstream")
    sp_tree, lg_tree = (convert.load_params(p) for p in (SP_NPZ, LG_NPZ))
    paths = {"sp": root / "superpoint_v1.pth",
             "lg": root / "superpoint_lightglue.pth",
             "lg_identity": root / "lightglue_identity.pth"}
    torch.save(upstream_superpoint(sp_tree), paths["sp"])
    torch.save(upstream_lightglue(lg_tree), paths["lg"])
    torch.save(upstream_lightglue(lg_tree, identity_input=True),
               paths["lg_identity"])
    return paths, sp_tree, lg_tree


def test_superpoint_tree_equals_jax_and_npz(checkpoints):
    paths, sp_tree, _ = checkpoints
    tree = convert.load_torch_superpoint(paths["sp"])
    assert_trees_equal(tree, jconvert.load_torch_superpoint(paths["sp"]))
    assert_trees_equal(tree, sp_tree)


@pytest.mark.parametrize("identity", [False, True])
def test_lightglue_tree_equals_jax(checkpoints, identity):
    paths, _, lg_tree = checkpoints
    path = paths["lg_identity" if identity else "lg"]
    tree = convert.load_torch_lightglue(path, n_layers=9)
    assert_trees_equal(tree, jconvert.load_torch_lightglue(path, n_layers=9))
    if identity:
        assert tree["input_proj"] == {}
        assert len(tree["confidence"]) == 8
    else:
        assert_trees_equal(tree, lg_tree)


def _putatives(m, enums, pair):
    GV, Q, TS = enums
    m.match(*pair, quality=Q.HIGH, tile_selection=TS.NONE,
            geometric_verification=GV.NONE)
    return m.mkpts0, m.mkpts1, m.mconf


PORT = (GeometricVerification, Quality, TileSelection)


def test_pth_matcher_equals_npz_matcher(checkpoints):
    paths, _, _ = checkpoints
    base = {"max_keypoints": 256, "activation_dtype": "float32"}
    pth = LightGlueMatcher(dict(base, superpoint_weights=str(paths["sp"]),
                                lightglue_weights=str(paths["lg"])),
                           device="cpu")
    npz = LightGlueMatcher(dict(base, superpoint_weights=str(SP_NPZ),
                                lightglue_weights=str(LG_NPZ)), device="cpu")
    pair = shifted_pair()
    got, want = _putatives(pth, PORT, pair), _putatives(npz, PORT, pair)
    assert len(want[0]) > 50
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_identity_projection_matches_jax(checkpoints):
    """A published 256-d LightGlue has no input_proj: both packages run
    it as the identity and find the same putative matches (f32)."""
    paths, _, _ = checkpoints
    opt = {"max_keypoints": 128, "activation_dtype": "float32",
           "filter_threshold": 0.0, "precision": "highest", "superpoint_weights": str(paths["sp"]),
           "lightglue_weights": str(paths["lg_identity"])}
    port = LightGlueMatcher(opt, device="cpu")
    assert isinstance(port.matcher.input_proj, torch.nn.Identity)
    # and back: the trained-model writer keeps the empty projection
    assert convert.lightglue_tree_from_state_dict(
        port.matcher.state_dict())["input_proj"] == {}
    pair = shifted_pair()
    p = np.c_[_putatives(port, PORT, pair)[:2]]
    r = np.c_[_putatives(JMatcher(opt), (JGV, JQuality, JTileSelection),
                         pair)[:2]]
    assert len(r) > 20
    np.testing.assert_array_equal(p[np.lexsort(p.T)], r[np.lexsort(r.T)])


@pytest.mark.parametrize("cls", [LightGlueMatcher, SuperGlueMatcher,
                                 NearestNeighborMatcher])
def test_every_superpoint_matcher_takes_a_pth(checkpoints, cls):
    paths, _, _ = checkpoints
    got = cls({"superpoint_weights": str(paths["sp"]), "seed": 0},
              device="cpu")._sp_state
    want = cls({"superpoint_weights": str(SP_NPZ), "seed": 0},
               device="cpu")._sp_state
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_aliked_still_needs_an_npz(tmp_path):
    path = tmp_path / "aliked.pth"
    torch.save({}, path)
    with pytest.raises(ValueError, match="npz"):
        LightGlueMatcher({"extractor": "aliked",
                          "superpoint_weights": str(path)}, device="cpu")
