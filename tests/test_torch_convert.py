"""The bundled checkpoints load through the port's loader, convert, and
give the JAX package's SuperPoint and LightGlue outputs on a 128x160
input, f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.models.convert import load_params as j_load_params
from icepy4d_tpu.models.lightglue import LightGlue as JLightGlue
from icepy4d_tpu.models.superpoint import SuperPoint as JSuperPoint
from icepy4d_tpu_torch.models.convert import (bundled_checkpoint,
                                              lightglue_params, load_params,
                                              superpoint_state_dict)
from icepy4d_tpu_torch.models.lightglue import LightGlue
from icepy4d_tpu_torch.models.superpoint import SuperPoint
from torch_port_inputs import shifted_pair


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def trees():
    sp, lg = (bundled_checkpoint(n) for n in
              ("superpoint_synthetic.npz", "lightglue_synthetic.npz"))
    assert sp is not None and lg is not None
    return load_params(sp), load_params(lg)


def test_loader_matches_jax_loader(trees):
    _tree_equal(trees[0], j_load_params(bundled_checkpoint(
        "superpoint_synthetic.npz")))


def test_layouts():
    tree = {"params": {"c": {"kernel": np.zeros((3, 3, 2, 5)),
                             "bias": np.zeros(5)}}}
    assert superpoint_state_dict(tree)["c.weight"].shape == (5, 2, 3, 3)
    lg = lightglue_params({"layers": [{"n": {"scale": np.ones(4)},
                                       "d": {"kernel": np.zeros((4, 6))}}]})
    assert lg["layers.0.n.weight"].shape == (4,)
    assert lg["layers.0.d.weight"].shape == (6, 4)


def test_bundled_models_match_jax(trees):
    sp_tree, lg_tree = trees
    a, b = shifted_pair(128, 160)
    images = (np.stack([a, b]) / 255.0).astype(np.float32)

    j_sp = JSuperPoint(max_keypoints=256, precision="highest")
    feats_j = j_sp.extract(jax.tree.map(jnp.asarray, sp_tree),
                           jnp.asarray(images))
    sp = SuperPoint(max_keypoints=256, device="cpu").load_state_dict(
        superpoint_state_dict(sp_tree))
    feats = sp.extract(torch.from_numpy(images))
    assert np.asarray(feats_j["mask"]).sum() > 40
    np.testing.assert_array_equal(feats["keypoints"].numpy(),
                                  np.asarray(feats_j["keypoints"]))
    np.testing.assert_allclose(feats["descriptors"].numpy(),
                               np.asarray(feats_j["descriptors"]), atol=1e-4)

    f = {k: np.asarray(v) for k, v in feats_j.items()}
    size = np.full((1, 2), [160.0, 128.0], np.float32)
    data = {"kpts0": f["keypoints"][:1], "desc0": f["descriptors"][:1],
            "mask0": f["mask"][:1], "size0": size,
            "kpts1": f["keypoints"][1:], "desc1": f["descriptors"][1:],
            "mask1": f["mask"][1:], "size1": size}
    out_j = JLightGlue(precision="highest").match(
        jax.tree.map(jnp.asarray, lg_tree),
        {k: jnp.asarray(v) for k, v in data.items()})
    lg = LightGlue(device="cpu")
    lg.load_state_dict(lightglue_params(lg_tree))
    out = lg.match({k: torch.tensor(v) for k, v in data.items()})
    assert (np.asarray(out_j["matches0"]) > -1).sum() > 10
    np.testing.assert_array_equal(out["matches0"].numpy(),
                                  np.asarray(out_j["matches0"]))
    np.testing.assert_allclose(out["mscores0"].numpy(),
                               np.asarray(out_j["mscores0"]), atol=1e-4)
