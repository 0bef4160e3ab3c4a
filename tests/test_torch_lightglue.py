"""Port LightGlue == icepy4d_tpu's on the same random weights: 2 layers,
d=64, 2 heads, f32 at "highest" matmul precision."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.models.lightglue import LightGlue as JLightGlue
from icepy4d_tpu_torch.models.convert import lightglue_params
from icepy4d_tpu_torch.models.lightglue import LightGlue
from torch_port_inputs import lightglue_tree

CFG = dict(n_layers=2, num_heads=2, descriptor_dim=64, input_dim=64,
           filter_threshold=0.0)


def _data(seed=3, b=2, m=96, n=80, d=64):
    rng = np.random.default_rng(seed)
    k0 = rng.uniform(0, 300, (b, m, 2)).astype(np.float32)
    k1 = k0[:, :n] + rng.normal(0, 0.5, (b, n, 2)).astype(np.float32)
    d0 = rng.normal(size=(b, m, d)).astype(np.float32)
    d1 = d0[:, :n] + 0.3 * rng.normal(size=(b, n, d)).astype(np.float32)
    mask0 = rng.uniform(size=(b, m)) < 0.9
    mask1 = rng.uniform(size=(b, n)) < 0.9
    size = np.full((b, 2), 300.0, np.float32)
    return {"kpts0": k0, "kpts1": k1, "desc0": d0 / 8, "desc1": d1 / 8,
            "mask0": mask0, "mask1": mask1, "size0": size, "size1": size}


@pytest.fixture(scope="module")
def tree():
    return lightglue_tree(CFG["n_layers"], 64, 2, seed=4)


def _run_jax(tree, data):
    ref = JLightGlue(**CFG, precision="highest")
    out = ref.match(jax.tree.map(jnp.asarray, tree),
                    {k: jnp.asarray(v) for k, v in data.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _port(tree, dtype="float32"):
    port = LightGlue(**CFG, activation_dtype=dtype, device="cpu")
    port.load_state_dict(lightglue_params(tree))
    return port


def test_match_equals_jax(tree):
    data = _data()
    ref = _run_jax(tree, data)
    out = _port(tree).match({k: torch.from_numpy(v) for k, v in data.items()})
    la_ref = ref["log_assignment"]
    la = out["log_assignment"].numpy()
    valid = la_ref > -1e8   # masked entries are NEG_INF on both sides
    np.testing.assert_array_equal(la < -1e8, ~valid)
    np.testing.assert_allclose(la[valid], la_ref[valid], atol=1e-4,
                               rtol=1e-4)
    assert (ref["matches0"] > -1).sum() > 20
    np.testing.assert_array_equal(out["matches0"].numpy(), ref["matches0"])
    np.testing.assert_array_equal(out["matches1"].numpy(), ref["matches1"])


def test_bfloat16_trunk_smoke(tree):
    """The bf16 activation trunk runs and agrees with f32 on nearly every
    match decision (the assignment head stays f32)."""
    data = {k: torch.from_numpy(v) for k, v in _data(seed=5).items()}
    m32 = _port(tree).match(data)["matches0"]
    m16 = _port(tree, "bfloat16").match(data)["matches0"]
    assert (m32 == m16).float().mean() > 0.9
    assert m16.dtype == torch.int32
