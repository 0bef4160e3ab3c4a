"""The port's `top2_last` == icepy4d_tpu's: (best, second, argmax) along
the last axis, exactly, with duplicate maxima (only the first argmax is
masked, so second == best), rows masked to the lowest float32, whole
masked rows, and integer input."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.ops.topk import top2_last as jtop2
from icepy4d_tpu_torch.ops.topk import safe_top_k, top2_last


def _cases():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 17, 33)).astype(np.float32)
    dup = x.copy()
    dup[0, :, 5] = dup[0].max(-1) + 1.0          # two equal maxima a row
    dup[0, :, 20] = dup[0, :, 5]
    neg = np.finfo(np.float32).min
    masked = x.copy()
    masked[1, :, ::2] = neg                      # every other column masked
    masked[2, 4] = neg                           # a whole masked row
    ints = rng.integers(-5, 5, size=(4, 40)).astype(np.int32)
    return {"random": x, "duplicate_max": dup, "masked": masked,
            "int32": ints}


@pytest.mark.parametrize("name", sorted(_cases()))
def test_top2_last_matches_jax(name):
    x = _cases()[name]
    ref = [np.asarray(a) for a in jtop2(jnp.asarray(x))]
    got = [a.numpy() for a in top2_last(torch.from_numpy(x))]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    if name == "duplicate_max":
        assert np.array_equal(got[0][0], got[1][0])
        assert (got[2][0] == 5).all()


def test_safe_top_k_index_order_on_ties():
    x = torch.tensor([[0.0, 2.0, 0.0, 2.0, 1.0, 0.0]])
    vals, idx = safe_top_k(x, 5)
    assert vals.tolist() == [[2.0, 2.0, 1.0, 0.0, 0.0]]
    assert idx.tolist() == [[1, 3, 4, 0, 2]]
