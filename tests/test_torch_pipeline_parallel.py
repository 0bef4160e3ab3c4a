"""The port's pipeline-parallel LightGlue and LoFTR coarse transformer
(`icepy4d_tpu_torch/parallel/lightglue_pp.py`, `loftr_pp.py`) against
the JAX package's, at the sizes and seeds of `tests/test_parallel.py`:
4 stages on both sides (the port's mesh of 4 CPU slots, the JAX
package's 4 virtual CPU devices), 8 layers or 4 coarse pairs, a batch of
8 pairs, the same numpy inputs, the JAX weight trees carried across by
the converters.

Tolerances: LightGlue's matches0 equal and the log assignment within
1e-4 abs + 1e-4 rel on its valid entries (the bar of
test_torch_lightglue.py; the entries reach -127 here, and the largest
difference measured is 4.3e-4 at -70.7, 5.4e-5 relative: the two
libraries' f32 orders over 8 layers), its masked entries masked in
both; against the port's own dense forward 1e-5 (the same f32
operations on smaller batches; measured 0). LoFTR within 2e-4 of the
JAX stages (measured 1.2e-5) and 1e-5 of the port's `lft_apply`. Each
JAX factory runs once, in a module-scoped fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.models.lightglue import LightGlue as JLightGlue
from icepy4d_tpu.models.loftr import LoFTR as JLoFTR
from icepy4d_tpu.parallel import make_mesh as jmake_mesh
from icepy4d_tpu.parallel import make_pipeline_parallel_lightglue as jmake_lg
from icepy4d_tpu.parallel import \
    make_pipeline_parallel_loftr_coarse as jmake_loftr
from icepy4d_tpu_torch.models.convert import lightglue_params, loftr_params
from icepy4d_tpu_torch.models.lightglue import LightGlue
from icepy4d_tpu_torch.models.loftr import LoFTR, lft_apply, loftr_tree
from icepy4d_tpu_torch.parallel import (make_mesh,
                                        make_pipeline_parallel_lightglue,
                                        make_pipeline_parallel_loftr_coarse)

STAGES = 4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes():
    return (jmake_mesh(STAGES, dp=STAGES, tp=1, axis_names=("pp", "unused")),
            make_mesh(STAGES, dp=STAGES, tp=1, axis_names=("pp", "unused"),
                      device="cpu"))


def _pair_batch(b=8, n=32, d=256, seed=5) -> dict:
    """tests/test_parallel.py's 8-pair batch on a 64 px frame."""
    r = np.random.default_rng(seed)
    return {"kpts0": r.uniform(0, 64, (b, n, 2)).astype(np.float32),
            "kpts1": r.uniform(0, 64, (b, n, 2)).astype(np.float32),
            "desc0": r.normal(size=(b, n, d)).astype(np.float32),
            "desc1": r.normal(size=(b, n, d)).astype(np.float32),
            "mask0": r.uniform(size=(b, n)) < 0.9,
            "mask1": r.uniform(size=(b, n)) < 0.9,
            "size0": np.full((b, 2), 64.0, np.float32),
            "size1": np.full((b, 2), 64.0, np.float32)}


# -- LightGlue ----------------------------------------------------------------

@pytest.fixture(scope="module")
def lightglue_runs(meshes):
    jm, pm = meshes
    jlg = JLightGlue(n_layers=8, precision="highest")
    params = jlg.init(jax.random.PRNGKey(0))
    data = _pair_batch()
    ref = {k: np.asarray(v) for k, v in jmake_lg(jm, jlg)(
        params, {k: jnp.asarray(v) for k, v in data.items()}).items()}
    lg = LightGlue(n_layers=8, device="cpu")
    lg.load_state_dict(lightglue_params(jax.tree.map(np.asarray, params)))
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    got = {k: v.numpy() for k, v in
           make_pipeline_parallel_lightglue(pm, lg)(tdata).items()}
    dense = {k: v.numpy() for k, v in lg.match(tdata).items()}
    return ref, got, dense, lg, tdata


def test_pipeline_parallel_lightglue_equals_jax(lightglue_runs):
    ref, got, _, _, _ = lightglue_runs
    np.testing.assert_array_equal(got["matches0"], ref["matches0"])
    assert (got["matches0"] > -1).sum() > 20
    la_ref, la = ref["log_assignment"], got["log_assignment"]
    valid = la_ref > -1e8
    np.testing.assert_array_equal(la < -1e8, ~valid)
    np.testing.assert_allclose(la[valid], la_ref[valid], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got["mscores0"], ref["mscores0"], atol=1e-5,
                               rtol=1e-4)


def test_pipeline_parallel_lightglue_equals_dense(lightglue_runs):
    _, got, dense, _, _ = lightglue_runs
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(got[k], dense[k])
    for k in ("mscores0", "mscores1", "log_assignment"):
        np.testing.assert_allclose(got[k], dense[k], atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_micro", [2, 8])
def test_pipeline_parallel_lightglue_microbatches(meshes, lightglue_runs,
                                                  n_micro):
    """Other microbatch counts (the schedule with fewer microbatches
    than stages, and one pair a microbatch) give the same forward."""
    _, got, _, lg, tdata = lightglue_runs
    out = make_pipeline_parallel_lightglue(meshes[1], lg,
                                           n_micro=n_micro)(tdata)
    np.testing.assert_array_equal(out["matches0"].numpy(), got["matches0"])
    np.testing.assert_allclose(out["log_assignment"].numpy(),
                               got["log_assignment"], atol=1e-5, rtol=0)


def test_pipeline_parallel_lightglue_rejects_bad_split(meshes,
                                                       lightglue_runs):
    _, pm = meshes
    with pytest.raises(ValueError, match="n_layers"):
        make_pipeline_parallel_lightglue(
            pm, LightGlue(n_layers=9, device="cpu"))
    *_, lg, tdata = lightglue_runs
    with pytest.raises(ValueError, match="n_micro"):
        make_pipeline_parallel_lightglue(pm, lg, n_micro=3)(tdata)


# -- LoFTR coarse transformer ----------------------------------------------------

@pytest.fixture(scope="module")
def loftr_runs(meshes):
    jm, pm = meshes
    tree = loftr_tree(seed=0)
    r = np.random.default_rng(7)
    b, l, d = 8, 48, 256
    ins = (r.normal(size=(b, l, d)).astype(np.float32),
           r.normal(size=(b, l, d)).astype(np.float32),
           r.uniform(size=(b, l)) < 0.9, r.uniform(size=(b, l)) < 0.9)
    jpp = jmake_loftr(jm, JLoFTR(coarse_pairs=4, precision="highest"))
    ref = [np.asarray(a) for a in jpp(
        jax.tree.map(jnp.asarray, tree["coarse"]), *map(jnp.asarray, ins))]
    model = LoFTR(precision="highest", device="cpu")
    model.load_state_dict(loftr_params(tree))
    tins = [torch.from_numpy(a) for a in ins]
    got = [a.numpy() for a in
           make_pipeline_parallel_loftr_coarse(pm, model)(*tins)]
    with torch.inference_mode():
        dense = [a.numpy() for a in lft_apply(model.net.coarse, *tins,
                                              model.nhead)]
    return ref, got, dense, model


def test_pipeline_parallel_loftr_equals_jax(loftr_runs):
    ref, got, _, _ = loftr_runs
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=2e-4)


def test_pipeline_parallel_loftr_equals_lft_apply(loftr_runs):
    _, got, dense, _ = loftr_runs
    for a, b in zip(got, dense):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_pipeline_parallel_loftr_rejects_bad_split(loftr_runs):
    model = loftr_runs[3]
    mesh = make_mesh(3, dp=3, tp=1, axis_names=("pp", "unused"), device="cpu")
    with pytest.raises(ValueError, match="coarse_pairs"):
        make_pipeline_parallel_loftr_coarse(mesh, model)
