"""The port's ring attention and sequence-parallel LightGlue and
SuperGlue (`icepy4d_tpu_torch/parallel/`) against the JAX package's, at
the sizes and seeds of `tests/test_parallel.py`: 8 shards on both sides
(the port's in-process mesh of 8 CPU slots, the JAX package's 8 virtual
CPU devices), the same numpy inputs, the JAX weight trees carried across
by the converters.

Tolerances: ring attention within 2e-5 of the JAX ring (fully masked
rows included: both give the uniform average of v); the sharded
matchers' matches0 and matches1 equal to the JAX sharded forward's on
>= 99% of the slots, mscores within rtol 1e-3 / atol 1e-5 where both
match (the JAX tests' bars; measured: every match equal, scores within
5e-6); against the port's own dense forward, the JAX tests' bars. Each
JAX factory runs once, in a module-scoped fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.models.lightglue import LightGlue as JLightGlue
from icepy4d_tpu.models.superglue import SuperGlue as JSuperGlue
from icepy4d_tpu.parallel import make_mesh as jmake_mesh
from icepy4d_tpu.parallel import make_ring_attention as jmake_ring
from icepy4d_tpu.parallel import make_sequence_parallel_lightglue as jmake_lg
from icepy4d_tpu.parallel import make_sequence_parallel_superglue as jmake_sg
from icepy4d_tpu_torch.models.convert import (lightglue_params,
                                              superglue_params)
from icepy4d_tpu_torch.models.lightglue import LightGlue
from icepy4d_tpu_torch.models.superglue import SuperGlue
from icepy4d_tpu_torch.parallel import (Mesh, make_mesh, make_ring_attention,
                                        make_sequence_parallel_lightglue,
                                        make_sequence_parallel_superglue)
from torch_port_inputs import attention_operands, keypoint_sets

SHARDS = 8
# ring operands of tests/test_parallel.py: (b, h, n, hd, seed, p_keep)
RING_CASES = {"padded": (2, 4, 256, 32, 0, 0.7),
              "fully_masked": (1, 2, 128, 16, 1, None)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes():
    return (jmake_mesh(SHARDS, dp=1, tp=SHARDS, axis_names=("data", "seq")),
            make_mesh(SHARDS, dp=1, tp=SHARDS, axis_names=("data", "seq"),
                      device="cpu"))


def _torch(data: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in data.items()}


def _jax(data: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in data.items()}


def _numpy(out: dict) -> dict:
    return {k: np.asarray(v) for k, v in out.items()}


# -- ring attention ---------------------------------------------------------

@pytest.fixture(scope="module")
def ring_runs(meshes):
    jm, pm = meshes
    jring, ring = jmake_ring(jm, axis="seq"), make_ring_attention(pm)
    out = {}
    for name, args in RING_CASES.items():
        ops = attention_operands(*args)
        out[name] = (np.asarray(jring(*map(jnp.asarray, ops))),
                     ring(*map(torch.from_numpy, ops)).numpy())
    return out


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_attention_equals_jax(ring_runs, case):
    ref, got = ring_runs[case]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_ring_attention_rejects_bad_split(meshes):
    q, k, v, m = map(torch.from_numpy, attention_operands(1, 2, 100, 16, 0))
    with pytest.raises(ValueError, match="divisible"):
        make_ring_attention(meshes[1])(q, k, v, m)


def test_sequence_axis_across_devices_raises():
    """A sharded axis whose slots name two devices of one process: the
    route is one process a card."""
    devs = np.empty((1, 2), dtype=object)
    devs[0, 0], devs[0, 1] = torch.device("cpu"), torch.device("cuda", 0)
    with pytest.raises(ValueError, match="torchrun"):
        make_ring_attention(Mesh(devs, ("data", "seq")))


# -- sequence-parallel LightGlue ---------------------------------------------

@pytest.fixture(scope="module")
def lightglue_runs(meshes):
    jm, pm = meshes
    jlg = JLightGlue(n_layers=2, filter_threshold=0.0, precision="highest")
    params = jlg.init(0)
    data = keypoint_sets(2, 128, seed=3)
    ref = _numpy(jmake_lg(jm, jlg)(params, _jax(data)))
    lg = LightGlue(n_layers=2, filter_threshold=0.0, device="cpu")
    lg.load_state_dict(lightglue_params(jax.tree.map(np.asarray, params)))
    sp = make_sequence_parallel_lightglue(pm, lg)
    return ref, _numpy(sp(_torch(data))), _numpy(lg.match(_torch(data))), \
        sp, data


def _hold(ref: dict, got: dict, bar: float = 0.99) -> None:
    """matches0 and matches1 equal on >= `bar` of the slots; mscores0
    within rtol 1e-3 / atol 1e-5 where both match."""
    for k in ("matches0", "matches1"):
        agree = (ref[k] == got[k]).mean()
        assert agree >= bar, f"{k} agreement {agree}"
    ok = (ref["matches0"] > -1) & (ref["matches0"] == got["matches0"])
    assert ok.sum() > 20
    np.testing.assert_allclose(got["mscores0"][ok], ref["mscores0"][ok],
                               rtol=1e-3, atol=1e-5)


def test_sequence_parallel_lightglue_equals_jax(lightglue_runs):
    ref, got, _, _, _ = lightglue_runs
    assert set(got) == {"matches0", "matches1", "mscores0", "mscores1"}
    _hold(ref, got)


def test_sequence_parallel_lightglue_equals_dense(lightglue_runs):
    """tests/test_parallel.py's bars: matches0 >= 99%, matches1 equal,
    mscores0 on the dense matches."""
    _, got, dense, _, _ = lightglue_runs
    assert (got["matches0"] == dense["matches0"]).mean() > 0.99
    np.testing.assert_array_equal(got["matches1"], dense["matches1"])
    ok = dense["matches0"] > -1
    np.testing.assert_allclose(got["mscores0"][ok], dense["mscores0"][ok],
                               rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("bad", ["no_size", "indivisible"])
def test_sequence_parallel_lightglue_rejects(lightglue_runs, bad):
    *_, sp, data = lightglue_runs
    data = dict(_torch(data))
    if bad == "no_size":
        data["size1"] = None
        match = "size0 and size1"
    else:
        data = {k: v[:, :100] for k, v in data.items() if k[:4] != "size"}
        data.update(size0=torch.tensor([640.0, 480.0]),
                    size1=torch.tensor([640.0, 480.0]))
        match = "divisible"
    with pytest.raises(ValueError, match=match):
        sp(data)


# -- sequence-parallel SuperGlue ---------------------------------------------

@pytest.fixture(scope="module")
def superglue_runs(meshes):
    jm, pm = meshes
    jsg = JSuperGlue(sinkhorn_iterations=15, match_threshold=0.0,
                     precision="highest")
    params = jsg.init(0)
    data = keypoint_sets(2, 128, seed=4, scores=True)
    ref = _numpy(jmake_sg(jm, jsg)(params, _jax(data)))
    sg = SuperGlue(sinkhorn_iterations=15, match_threshold=0.0, device="cpu")
    sg.load_state_dict(superglue_params(jax.tree.map(np.asarray, params)))
    got = _numpy(make_sequence_parallel_superglue(pm, sg)(_torch(data)))
    return ref, got, _numpy(sg.match(_torch(data)))


def test_sequence_parallel_superglue_equals_jax(superglue_runs):
    ref, got, _ = superglue_runs
    assert set(got) == {"matches0", "matches1", "mscores0", "mscores1"}
    _hold(ref, got)


def test_sequence_parallel_superglue_equals_dense(superglue_runs):
    """tests/test_parallel.py's bars: matches0 and matches1 >= 99%,
    mscores0 on the dense matches."""
    _, got, dense = superglue_runs
    _hold(dense, got)
