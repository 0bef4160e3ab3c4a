"""Port SuperPoint == icepy4d_tpu's on the same random weights, f32 at
"highest" matmul precision (1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.models.superpoint import SuperPoint as JSuperPoint
from icepy4d_tpu_torch.models.convert import superpoint_state_dict
from icepy4d_tpu_torch.models.superpoint import SuperPoint
from torch_port_inputs import shifted_pair, superpoint_tree


@pytest.fixture(scope="module")
def models():
    tree = superpoint_tree(seed=1)
    ref = JSuperPoint(max_keypoints=200, precision="highest")
    port = SuperPoint(max_keypoints=200, device="cpu").load_state_dict(
        superpoint_state_dict(tree))
    return ref, jax.tree.map(jnp.asarray, tree), port


@pytest.fixture(scope="module")
def images():
    a, b = shifted_pair(117, 150)       # not multiples of 8: pad band
    return (np.stack([a, b]) / 255.0).astype(np.float32)


def test_dense_outputs_match(models, images):
    ref, params, port = models
    x = np.pad(images, ((0, 0), (0, 3), (0, 2)))[..., None]
    with jax.default_matmul_precision("highest"):
        heat_j, desc_j = ref.net.apply(params, jnp.asarray(x))
    with torch.inference_mode():
        heat_p, desc_p = port.net(torch.from_numpy(x[..., 0])[:, None])
    np.testing.assert_allclose(heat_p.numpy(), np.asarray(heat_j),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(desc_p.permute(0, 2, 3, 1).numpy(),
                               np.asarray(desc_j), atol=1e-4, rtol=1e-4)


def test_extract_matches(models, images):
    ref, params, port = models
    out_j = ref.extract(params, jnp.asarray(images))
    out_p = port.extract(torch.from_numpy(images))
    mask = np.asarray(out_j["mask"])
    assert mask.sum() > 50
    np.testing.assert_array_equal(out_p["mask"].numpy(), mask)
    np.testing.assert_array_equal(out_p["keypoints"].numpy(),
                                  np.asarray(out_j["keypoints"]))
    np.testing.assert_allclose(out_p["scores"].numpy(),
                               np.asarray(out_j["scores"]), atol=1e-6)
    np.testing.assert_allclose(out_p["descriptors"].numpy(),
                               np.asarray(out_j["descriptors"]), atol=1e-4)
