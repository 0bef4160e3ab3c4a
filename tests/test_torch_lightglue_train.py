"""The port's LightGlue training, homography stage
(`training/lightglue_train.py`, `ops/attention.py::dense_attention`) ==
icepy4d_tpu's on the same numpy-seeded inputs, in f32 on the CPU.

Sizes: 2 layers at the published width (256-d, 4 heads), 64 keypoints,
pairs of 96x128 frames, batches of 2, the bundled SuperPoint.
Tolerances: the datasets' homographies, masks and ground truth equal,
keypoints and descriptors within 1e-5; the losses and attention within
1e-5 relative; one train step's loss within 1e-5 relative and every
gradient tensor within 1e-4 of its largest magnitude; after 3 steps
every parameter within 2 * lr * 3 of the JAX one (Adam moves a
parameter by at most about lr a step, so where a gradient is at
rounding level the packages may step opposite ways); match counts of
`evaluate_matching` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icepy4d_tpu.models.lightglue import LightGlue as JLightGlue
from icepy4d_tpu.models.superpoint import SuperPoint as JSuperPoint
from icepy4d_tpu.ops.attention import _xla_attention
from icepy4d_tpu.training import lightglue_train as jtrain
from icepy4d_tpu_torch.models.convert import (lightglue_params, load_params,
                                              superpoint_state_dict)
from icepy4d_tpu_torch.models.lightglue import LightGlue
from icepy4d_tpu_torch.models.superpoint import SuperPoint
from icepy4d_tpu_torch.ops.attention import dense_attention
from icepy4d_tpu_torch.training import _optim
from icepy4d_tpu_torch.training import lightglue_train as ttrain
from torch_port_inputs import REPO_WEIGHTS
from training_parity import capture, rel

N_LAYERS = 2
LR = 1e-3
WARMUP = 1
STEPS = 3
KEYS = ("kpts0", "desc0", "mask0", "size0", "kpts1", "desc1", "mask1",
        "size1", "H")




@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sp_tree():
    return load_params(REPO_WEIGHTS / "superpoint_synthetic.npz")


@pytest.fixture(scope="module")
def datasets(sp_tree):
    """make_lightglue_dataset of both packages, seed 0, a real pool of
    two frames (both branches are drawn), chunks of 3 images."""
    pool = [np.random.default_rng(9).uniform(0, 1, (80, 200)).astype(
        np.float32), np.random.default_rng(10).uniform(0, 1, (140, 170))
        .astype(np.float32)]
    jsp = JSuperPoint(max_keypoints=64, detection_threshold=0.0005)
    jparams = jax.tree.map(jnp.asarray, sp_tree)
    ref = jtrain.make_lightglue_dataset(
        np.random.default_rng(0), lambda im: jsp.extract(jparams, im), 2, 2,
        h=96, w=128, real_pool=pool, real_fraction=0.5, extract_chunk=3)
    sp = SuperPoint(max_keypoints=64, detection_threshold=0.0005,
                    device="cpu").load_state_dict(
        superpoint_state_dict(sp_tree))
    got = ttrain.make_lightglue_dataset(
        np.random.default_rng(0), sp.extract, 2, 2, h=96, w=128,
        real_pool=pool, real_fraction=0.5, extract_chunk=3)
    return got, {k: np.asarray(v) for k, v in ref.items()}


def test_make_lightglue_dataset(datasets):
    got, ref = datasets
    assert sorted(got) == sorted(ref)
    for k in KEYS:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype
        if k.startswith(("kpts", "desc")):
            # masked slots hold sub-threshold cells, whose order the
            # packages' last bits decide; every valid slot agrees
            valid = ref["mask" + k[-1]]
            np.testing.assert_allclose(got[k][valid], ref[k][valid],
                                       atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(got[k], ref[k])
    assert ref["mask0"].sum() > 50


def test_gt_assignment_and_explicit(datasets):
    _, ds = datasets
    rng = np.random.default_rng(1)
    kpts0 = rng.uniform(0, 60, (2, 30, 2)).astype(np.float32)
    kpts1 = np.concatenate([kpts0[:, :20] + rng.normal(0, 2.0, (2, 20, 2)),
                            rng.uniform(0, 60, (2, 10, 2))], 1
                           ).astype(np.float32)
    H = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    H[1, 2] = [0.0, 0.0, 1e-12]                # the 1e-9 guard
    m0 = rng.uniform(size=(2, 30)) < 0.9
    m1 = rng.uniform(size=(2, 30)) < 0.9
    args = (kpts0, kpts1, H, m0, m1)
    for th in ((3.0, 6.0), (1.0, 2.0)):
        ref = jtrain.gt_assignment(*map(jnp.asarray, args), *th)
        got = ttrain.gt_assignment(*map(torch.from_numpy, args), *th)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    ref = jtrain.homography_to_explicit(ds)
    got = ttrain.homography_to_explicit(ds, device="cpu")
    assert sorted(got) == sorted(ref) and "H" not in got
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]))


def test_losses_and_attention():
    rng = np.random.default_rng(2)
    scores = rng.normal(-3, 2, (2, 9, 11)).astype(np.float32)
    gt0 = rng.integers(-1, 10, (2, 8)).astype(np.int32)
    unm0 = rng.uniform(size=(2, 8)) < 0.3
    unm1 = rng.uniform(size=(2, 10)) < 0.3
    args = (scores, gt0, unm0, unm1)
    assert rel(ttrain.assignment_nll(*map(torch.from_numpy, args)),
                jtrain.assignment_nll(*map(jnp.asarray, args))) <= 1e-5
    z = rng.normal(0, 30, (50,)).astype(np.float32)
    y = (rng.uniform(size=50) < 0.5).astype(np.float32)
    np.testing.assert_allclose(
        ttrain.sigmoid_ce(torch.from_numpy(z), torch.from_numpy(y)).numpy(),
        np.asarray(jtrain.sigmoid_ce(jnp.asarray(z), jnp.asarray(y))),
        rtol=1e-5, atol=1e-6)

    q, k, v = (rng.normal(size=(2, 4, 17, 64)).astype(np.float32)
               for _ in range(3))
    mask = rng.uniform(size=(2, 17)) < 0.7
    mask[1] = False                  # a fully masked row: the mean of v
    ref = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v, mask))))
    got = dense_attention(*map(torch.from_numpy, (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(),
                               np.broadcast_to(v[1].mean(1, keepdims=True),
                                               v[1].shape), atol=1e-5)


@pytest.fixture(scope="module")
def jax_run(datasets):
    """JAX make_train_step over the JAX dataset's batches: per-step
    losses, the first step's gradients and parameters, and the
    parameters after STEPS steps, from the JAX package's init (seed 3)."""
    _, ds = datasets
    model = JLightGlue(n_layers=N_LAYERS)
    params = model.init(3)
    sched = optax.warmup_cosine_decay_schedule(0.0, LR, WARMUP, STEPS,
                                               LR * 0.05)
    tx = optax.chain(capture(), optax.clip_by_global_norm(1.0),
                     optax.adam(sched))
    step = jtrain.make_train_step(model, tx)
    opt = tx.init(params)
    out = {"init": jax.tree.map(np.asarray, params), "losses": [],
           "recall": []}
    for k in range(STEPS):
        batch = {key: jnp.asarray(ds[key][k % 2]) for key in KEYS}
        params, opt, metrics = step(params, opt, batch)
        out["losses"].append(float(metrics["loss"]))
        out["recall"].append(float(metrics["recall_gt"]))
        if k == 0:
            out["grads"] = jax.tree.map(np.asarray, opt[0])
            out["after0"] = jax.tree.map(np.asarray, params)
    out["params"] = jax.tree.map(np.asarray, params)
    return out


def _model(tree) -> LightGlue:
    lg = LightGlue(n_layers=N_LAYERS, device="cpu")
    lg.load_state_dict(lightglue_params(tree))
    return lg


def test_forward_all_layers(datasets, jax_run):
    _, ds = datasets
    batch = {k: ds[k][0] for k in KEYS}
    ref = jtrain.forward_all_layers(
        JLightGlue(n_layers=N_LAYERS),
        jax.tree.map(jnp.asarray, jax_run["init"]),
        {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = ttrain.forward_all_layers(
            _model(jax_run["init"]),
            {k: torch.from_numpy(v) for k, v in batch.items()})
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape == (N_LAYERS, 2, 64, 256)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())


def test_train_step_parity(datasets, jax_run):
    _, ds = datasets
    lg = _model(jax_run["init"])
    opt = _optim.lightglue_optimizer(lg.parameters(), LR, STEPS, WARMUP)
    step = ttrain.make_train_step(lg, opt)
    for k in range(STEPS):
        batch = {key: torch.from_numpy(ds[key][k % 2]) for key in KEYS}
        metrics = step(batch)
        ref_loss = jax_run["losses"][k]
        # later steps start from parameters up to 2 * lr * k apart
        assert rel(metrics["loss"], ref_loss) <= (1e-5 if k == 0 else 1e-3)
        if k == 0:
            assert abs(float(metrics["recall_gt"]) - jax_run["recall"][0]) \
                < 1e-6
            ref = lightglue_params(jax_run["grads"])
            for name, p in lg.named_parameters():
                scale = float(ref[name].abs().max())
                err = float((p.grad - ref[name]).abs().max())
                assert err <= 1e-4 * scale, (name, err, scale)
            # lr 0 at the first update: no parameter moves, in either
            init = lightglue_params(jax_run["init"])
            after0 = lightglue_params(jax_run["after0"])
            for name, p in lg.named_parameters():
                assert torch.equal(p.detach(), init[name])
                assert torch.equal(after0[name], init[name])
    ref = lightglue_params(jax_run["params"])
    for name, p in lg.named_parameters():
        assert float((p.detach() - ref[name]).abs().max()) \
            <= 2 * LR * STEPS, name


def test_train_lightglue_and_evaluate(datasets):
    """The two trainers from their common fresh init (seed 5): history
    entries and final parameters; then evaluate_matching's counts on
    the trained weights, at the model's threshold and overridden."""
    got_ds, ds = datasets
    jmodel = JLightGlue(n_layers=N_LAYERS)
    jparams, jhist = jtrain.train_lightglue(
        jmodel, ds, steps=STEPS, lr=LR, seed=5, scan_chunk=2, warmup=WARMUP,
        log=lambda s: None)
    lg = LightGlue(n_layers=N_LAYERS, device="cpu")
    state, hist = ttrain.train_lightglue(
        lg, got_ds, steps=STEPS, lr=LR, seed=5, scan_chunk=2, warmup=WARMUP,
        log=lambda s: None)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [1, 2]
    for h, r in zip(hist, jhist):
        assert rel(h["chunk_mean"], r["chunk_mean"]) <= 1e-3
    ref = lightglue_params(jax.tree.map(np.asarray, jparams))
    for name, t in state.items():
        assert float((t - ref[name]).abs().max()) <= 2 * LR * STEPS, name

    # the same weights on both sides for the evaluation
    trained = jax.tree.map(np.asarray, jparams)
    for th in (None, 0.0):
        r = jtrain.evaluate_matching(jmodel, jax.tree.map(jnp.asarray,
                                                          trained), ds,
                                     filter_threshold=th)
        g = ttrain.evaluate_matching(_model(trained), None, ds,
                                     filter_threshold=th)
        assert g == r
    assert r["n_pred"] > 0
