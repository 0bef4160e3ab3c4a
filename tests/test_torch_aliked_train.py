"""The port's ALIKED training (`training/aliked_train.py`) ==
icepy4d_tpu's on the same numpy-seeded inputs, in f32 on the CPU.

Sizes: the published channels (16/32/64/128, dim 128) from the bundled
`aliked_synthetic.npz`, pairs of 96x128 frames, batches of 2.
Tolerances: warped points and peaks within 1e-5 px (peaks' validity
equal), heat maps equal; one train step's loss within 1e-5 relative and
every gradient tensor within 1e-4 of its largest magnitude; after 3
adamw steps every parameter within 2 * lr * 3 of the JAX one (a step
moves a parameter by at most about lr, so where a gradient is at
rounding level the packages may step opposite ways). The JAX side is
its train step replayed over `train_aliked`'s cached batches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icepy4d_tpu.models.aliked import SDDH as JSDDH
from icepy4d_tpu.models.aliked import ALIKED as JALIKED
from icepy4d_tpu.training import aliked_train as jtrain
from icepy4d_tpu.training.synthetic import (make_pair_batch,
                                            make_real_pair_batch)
from icepy4d_tpu_torch.models.aliked import ALIKED
from icepy4d_tpu_torch.models.convert import aliked_params, load_params
from icepy4d_tpu_torch.ops.image import (bilinear_sample,
                                         bilinear_sample_batched)
from icepy4d_tpu_torch.training import _optim
from icepy4d_tpu_torch.training import aliked_train as ttrain
from torch_port_inputs import REPO_WEIGHTS
from training_parity import capture, rel

LR = 1e-3
STEPS = 3
H, W = 96, 128




@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    return load_params(REPO_WEIGHTS / "aliked_synthetic.npz")


def _model(tree) -> ALIKED:
    return ALIKED(device="cpu").load_state_dict(aliked_params(tree))


def test_geometry_helpers():
    rng = np.random.default_rng(0)
    kpts = rng.uniform(0, 120, (2, 30, 2)).astype(np.float32)
    Hs = np.stack([make_pair_batch(rng, 1, H, W)[2][0] for _ in range(2)])
    ref = jax.vmap(jtrain.warp_points)(jnp.asarray(kpts), jnp.asarray(Hs))
    got = ttrain.warp_points(torch.from_numpy(kpts), torch.from_numpy(Hs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-6)

    labels = rng.integers(0, 65, (2, H // 8, W // 8)).astype(np.int32)
    np.testing.assert_array_equal(
        ttrain.labels_to_heatmap(torch.from_numpy(labels), H, W).numpy(),
        np.asarray(jtrain.labels_to_heatmap(jnp.asarray(labels), H, W)))

    # the batched sampler is the per-image one, bit for bit
    feat = torch.from_numpy(rng.normal(size=(2, 20, 30, 8)).astype(
        np.float32))
    xy = torch.from_numpy(rng.uniform(-3, 33, (2, 50, 2)).astype(
        np.float32))
    per_image = torch.stack([bilinear_sample(f, p) for f, p in zip(feat, xy)])
    assert torch.equal(bilinear_sample_batched(feat, xy), per_image)
    assert torch.equal(bilinear_sample_batched(feat[..., 0], xy),
                       per_image[..., 0])

    score = rng.uniform(0, 1, (2, H, W)).astype(np.float32)
    score[0, :40] = 0.0             # fewer peaks than K: invalid slots
    rk, rv = jtrain._detect_peaks(jnp.asarray(score), 200, 2)
    gk, gv = ttrain._detect_peaks(torch.from_numpy(score), 200, 2)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))


def test_zero_descriptor_gradient(tree):
    """A keypoint far out of bounds samples only padding: with the
    projection bias at 0 its descriptor is exactly 0, and the NaN-safe
    L2 normalisation keeps every gradient finite and equal to JAX's."""
    rng = np.random.default_rng(1)
    sddh_tree = dict(tree["params"]["sddh"])
    sddh_tree["proj"] = dict(sddh_tree["proj"],
                             bias=np.zeros_like(sddh_tree["proj"]["bias"]))
    feat = rng.normal(size=(24, 32, 128)).astype(np.float32)
    feat /= np.linalg.norm(feat, axis=-1, keepdims=True)
    kpts = np.array([[10.0, 12.5], [-400.0, -400.0], [20.3, 7.7]],
                    np.float32)
    wts = rng.normal(size=(3, 128)).astype(np.float32)

    def jloss(p):
        d = JSDDH().apply({"params": p}, jnp.asarray(feat), jnp.asarray(kpts))
        return jnp.sum(d * wts)

    ref = aliked_params({"sddh": jax.tree.map(
        np.asarray, jax.jit(jax.grad(jloss))(
        jax.tree.map(jnp.asarray, sddh_tree)))})
    model = ALIKED(device="cpu")
    model.model.load_state_dict(aliked_params(
        {"net": tree["params"]["net"], "sddh": sddh_tree}))
    sddh = model.model.sddh
    d = sddh(torch.from_numpy(feat), torch.from_numpy(kpts))
    assert float(d[1].detach().abs().max()) == 0.0
    (d * torch.from_numpy(wts)).sum().backward()
    for name, p in sddh.named_parameters():
        g = p.grad
        assert torch.isfinite(g).all(), name
        r = ref["sddh." + name]
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max()), \
            name


@pytest.fixture(scope="module")
def replay(tree):
    """The JAX train step replayed over train_aliked's cached batches
    (seed 2, a real pool, n_batches 2 cycled) with train_aliked's
    optimiser: per-step losses, the first step's gradients and the
    parameters after STEPS steps."""
    pool = [np.random.default_rng(8).uniform(0, 1, (150, 200)).astype(
        np.float32)]
    rng = np.random.default_rng(2)
    host = []
    for _ in range(2):      # train_aliked's draws, in its order
        if rng.uniform() < 0.5:
            host.append(make_real_pair_batch(rng, pool, 2, H, W)
                        + (np.zeros(2, np.float32),))
        else:
            host.append(make_pair_batch(rng, 2, H, W)
                        + (np.ones(2, np.float32),))
    assert {float(b[4][0]) for b in host} == {0.0, 1.0}   # both kinds
    tx = optax.chain(capture(), optax.clip_by_global_norm(1.0),
                     optax.adamw(optax.cosine_decay_schedule(LR, STEPS)))
    step = jtrain.make_train_step(JALIKED(), tx)
    params = jax.tree.map(jnp.asarray, tree)
    opt = tx.init(params)
    losses, grads = [], None
    for k in range(STEPS):
        params, opt, loss = step(params, opt,
                                 *map(jnp.asarray, host[k % 2]))
        losses.append(float(loss))
        if k == 0:
            grads = jax.tree.map(np.asarray, opt[0])
    return {"pool": pool, "host": host, "losses": losses, "grads": grads,
            "params": jax.tree.map(np.asarray, params)}


def test_train_step_gradients(tree, replay):
    model = _model(tree)
    opt = _optim.aliked_optimizer(model.model.parameters(), LR, STEPS)
    loss = ttrain.make_train_step(model, opt)(
        *map(torch.from_numpy, replay["host"][0]))
    assert rel(loss, replay["losses"][0]) <= 1e-5
    ref = aliked_params(replay["grads"])
    for name, p in model.model.named_parameters():
        scale = float(ref[name].abs().max())
        err = float((p.grad - ref[name]).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


def test_train_aliked_replays_jax(tree, replay):
    logs = []
    model = _model(tree)
    state = ttrain.train_aliked(
        model, None, steps=STEPS, batch=2, h=H, w=W, lr=LR, seed=2,
        n_batches=2, real_pool=replay["pool"], scan_chunk=1,
        log=logs.append)
    assert len(logs) == 1 and logs[0].startswith(f"step {STEPS}/{STEPS}")
    ref = aliked_params(replay["params"])
    for name, t in state.items():
        assert float((t - ref[name]).abs().max()) <= 2 * LR * STEPS, name
    # the chunked log: the mean loss of each chunk of 2 steps
    logs.clear()
    ttrain.train_aliked(_model(tree), None, steps=STEPS, batch=2, h=H, w=W,
                        lr=LR, seed=2, n_batches=2,
                        real_pool=replay["pool"], scan_chunk=2,
                        log=logs.append)
    assert [s.split()[1] for s in logs] == ["2/3", "3/3"]
    first = float(logs[0].split()[-1])
    assert abs(first - np.mean(replay["losses"][:2])) <= 1e-3 * first
