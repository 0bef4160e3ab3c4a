"""The port's DISK and ALIKED extractors (`models/disk.py`,
`models/aliked.py`) == icepy4d_tpu's, on seeded inputs.

DISK (random weights) and ALIKED (the bundled `aliked_synthetic.npz`):
the same keypoints (DISK's integer peaks exactly; ALIKED's sub-pixel
positions within 5e-5 px, measured 7.6e-6), scores and descriptors
within 1e-5 (measured 3.0e-6 and 7.7e-7). The kornia-layout DISK state
dict (tests/oracle_disk.py) goes through the port's loader and the JAX
converter alike. Both extractors through `NearestNeighborMatcher`, and
ALIKED through `LightGlueMatcher` (input dim 128), give the JAX
matchers' putative matches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.matching import GeometricVerification as JGV
from icepy4d_tpu.matching import LightGlueMatcher as JLG
from icepy4d_tpu.matching import NearestNeighborMatcher as JNN
from icepy4d_tpu.models.aliked import ALIKED as JALIKED
from icepy4d_tpu.models.convert import disk_params_from_torch
from icepy4d_tpu.models.disk import DISK as JDISK
from icepy4d_tpu_torch.matching import (GeometricVerification,
                                        LightGlueMatcher,
                                        NearestNeighborMatcher)
from icepy4d_tpu_torch.models.aliked import ALIKED
from icepy4d_tpu_torch.models.convert import (aliked_params, disk_params,
                                              load_params, load_torch_disk)
from icepy4d_tpu_torch.models.disk import DISK, disk_tree
from icepy4d_tpu_torch.models.lightglue import lightglue_tree
from oracle_disk import DISK as OracleDISK
from torch_port_inputs import REPO_WEIGHTS, shifted_pair


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images():
    a, b = shifted_pair(96, 136)          # 136: not a multiple of 16
    return np.stack([a, b]).astype(np.float32) / 255.0


@pytest.fixture(scope="module")
def aliked_tree():
    return load_params(REPO_WEIGHTS / "aliked_synthetic.npz")


def _check(got, ref, kp_atol=0.0):
    mask = np.asarray(ref["mask"])
    np.testing.assert_array_equal(got["mask"].numpy(), mask)
    assert mask.sum() >= 50
    np.testing.assert_allclose(got["keypoints"].numpy(),
                               np.asarray(ref["keypoints"]), atol=kp_atol,
                               rtol=0)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(ref["scores"]), atol=1e-5)
    np.testing.assert_allclose(got["descriptors"].numpy(),
                               np.asarray(ref["descriptors"]), atol=1e-5)


@pytest.mark.parametrize("window", [5, 7])
def test_disk_extract(images, window):
    tree = disk_tree(seed=1)
    ref = JDISK(max_keypoints=200, nms_window_size=window).extract(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(images))
    got = DISK(max_keypoints=200, nms_window_size=window,
               device="cpu").load_state_dict(disk_params(tree)).extract(
        torch.from_numpy(images))
    _check(got, ref)


def test_disk_torch_checkpoint(images):
    """The kornia-layout state dict through both converters."""
    torch.manual_seed(0)
    oracle = OracleDISK().eval()
    for m in oracle.modules():
        if isinstance(m, torch.nn.PReLU):
            m.weight.data.uniform_(0.1, 0.4)
    sd = oracle.state_dict()
    jtree = disk_params_from_torch(sd)
    ref = JDISK(max_keypoints=200).extract(
        jax.tree.map(jnp.asarray, jtree), jnp.asarray(images))
    got = DISK(max_keypoints=200, device="cpu").load_state_dict(
        load_torch_disk(sd)).extract(torch.from_numpy(images))
    _check(got, ref)


def test_aliked_extract(images, aliked_tree):
    ref = JALIKED(max_keypoints=200, precision="highest").extract(
        jax.tree.map(jnp.asarray, aliked_tree), jnp.asarray(images))
    got = ALIKED(max_keypoints=200, device="cpu").load_state_dict(
        aliked_params(aliked_tree)).extract(torch.from_numpy(images))
    # the integer peaks are equal; the soft-argmax offsets round apart
    np.testing.assert_array_equal(
        np.round(got["keypoints"].numpy()), np.round(np.asarray(
            ref["keypoints"])))
    _check(got, ref, kp_atol=5e-5)


def _run_pair(jm, pm):
    a, b = shifted_pair(160, 224)
    jm.match(a, b, geometric_verification=JGV.NONE)
    pm.match(a, b, geometric_verification=GeometricVerification.NONE)
    assert len(jm.mkpts0) >= 20
    assert len(pm.mkpts0) == len(jm.mkpts0)
    # the same matches; rows ranked by score may swap where scores agree
    # to the last bits, so both sides are sorted by position
    got = np.concatenate([pm.mkpts0, pm.mkpts1], 1)
    ref = np.concatenate([jm.mkpts0, jm.mkpts1], 1)
    got = got[np.lexsort(np.round(got, 2).T[::-1])]
    ref = ref[np.lexsort(np.round(ref, 2).T[::-1])]
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert pm.descriptors0.shape[0] == 128


@pytest.mark.parametrize("kind", ["disk", "aliked"])
def test_nn_matcher_with_extractor(kind, aliked_tree):
    tree = aliked_tree if kind == "aliked" else disk_tree(seed=1)
    opt = {"extractor": kind, "max_keypoints": 256}
    _run_pair(JNN(dict(opt, superpoint_params=jax.tree.map(jnp.asarray,
                                                           tree))),
              NearestNeighborMatcher(dict(opt, superpoint_params=tree),
                                     device="cpu"))


def test_lightglue_matcher_with_aliked(aliked_tree):
    """LightGlue behind a 128-d input projection (f32 trunk, 3 layers)."""
    lg = lightglue_tree(n_layers=3, input_dim=128, seed=4)
    opt = {"extractor": "aliked", "max_keypoints": 256, "n_layers": 3,
           "activation_dtype": "float32", "filter_threshold": 0.05}
    _run_pair(JLG(dict(opt, superpoint_params=jax.tree.map(jnp.asarray,
                                                           aliked_tree),
                       matcher_params=jax.tree.map(jnp.asarray, lg))),
              LightGlueMatcher(dict(opt, superpoint_params=aliked_tree,
                                    matcher_params=lg), device="cpu"))


def test_lightglue_random_tree_matches_jax_init():
    from icepy4d_tpu.models.lightglue import LightGlue as JLightGlue

    a = jax.tree.map(np.asarray, JLightGlue(n_layers=2, input_dim=128)
                     .init(7))
    b = lightglue_tree(n_layers=2, input_dim=128, seed=7)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x, np.float32), y)
