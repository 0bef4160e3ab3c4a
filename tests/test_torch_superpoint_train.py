"""The port's SuperPoint training (`models/superpoint.py`'s raw surface
and `describe_at`, `training/superpoint_train.py`) == icepy4d_tpu's on
the same numpy-seeded inputs, in f32 on the CPU (the JAX package's
"default" matmul precision is full f32 there).

Tolerances: raw logits and dense descriptors within 1e-5 of their
largest magnitude (the bundled checkpoint's logits reach ~60, where f32
sums of 1152 products round apart by ~2e-4), `describe_at` within 1e-5;
the losses within 1e-5 relative; one train step's loss within 1e-5
relative and every gradient tensor within 1e-4 of its largest
magnitude. After 3 Adam steps every parameter lies within 2 * lr * 3 of
the JAX one: a step moves a parameter by at most about lr whatever its
gradient's size, so a parameter whose gradient is at rounding level may
go one way in one package and the other way in the other. The JAX side
runs the per-step path (XLA on the CPU runs the scanned conv backward
far too slowly).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icepy4d_tpu.models.superpoint import SuperPoint as JSuperPoint
from icepy4d_tpu.training import superpoint_train as jtrain
from icepy4d_tpu.training.synthetic import make_batch, make_pair_batch
from icepy4d_tpu_torch.models.convert import (load_params,
                                              superpoint_state_dict)
from icepy4d_tpu_torch.models.superpoint import SuperPoint, SuperPointNet
from icepy4d_tpu_torch.training import superpoint_train as ttrain
from icepy4d_tpu_torch.training._optim import Adam
from torch_port_inputs import REPO_WEIGHTS
from training_parity import capture, rel

LR = 1e-3
STEPS = 3
H = W = 64



@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    return load_params(REPO_WEIGHTS / "superpoint_synthetic.npz")


def _net(tree) -> SuperPointNet:
    net = SuperPointNet()
    net.load_state_dict(superpoint_state_dict(tree))
    return net



def test_raw_surface(tree):
    imgs = np.random.default_rng(0).uniform(0, 1, (2, 48, 72)).astype(
        np.float32)
    jl, jd = JSuperPoint().net.apply(jax.tree.map(jnp.asarray, tree),
                                     jnp.asarray(imgs)[..., None], raw=True)
    with torch.no_grad():
        tl, td = _net(tree)(torch.from_numpy(imgs)[:, None], raw=True)
    assert tl.shape == (2, 65, 6, 9) and tl.dtype == torch.float32
    for got, ref in ((tl, jl), (td, jd)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                                   atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_describe_at(tree):
    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 1, (2, 70, 93)).astype(np.float32)   # padded
    kpts = rng.uniform(-2, 95, (2, 40, 2)).astype(np.float32)
    ref = JSuperPoint().describe_at(jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(imgs), jnp.asarray(kpts))
    sp = SuperPoint(device="cpu").load_state_dict(superpoint_state_dict(tree))
    got = sp.describe_at(torch.from_numpy(imgs), torch.from_numpy(kpts))
    assert got.shape == (2, 40, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_losses():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 3, (2, 6, 9, 65)).astype(np.float32)
    labels = rng.integers(0, 65, (2, 6, 9)).astype(np.int32)
    labels[0, :3] = 64
    ref = jtrain.detector_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = ttrain.detector_loss(torch.from_numpy(logits).permute(0, 3, 1, 2),
                               torch.from_numpy(labels))
    assert rel(got, ref) <= 1e-5

    hc, wc = 6, 8
    d = rng.normal(size=(2, 2, hc * wc, 32)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r0 = np.random.default_rng(3)
    Hs = np.stack([make_pair_batch(r0, 1, 8 * hc, 8 * wc)[2][0]
                   for _ in range(2)])
    Hs[1, 2] = [0.0, 0.0, 1e-12]     # a vanishing third row: the 1e-9 guard
    ref = np.mean([float(jtrain.descriptor_loss(
        jnp.asarray(d[0, i]), jnp.asarray(d[1, i]), jnp.asarray(Hs[i]),
        hc, wc)) for i in range(2)])
    got = ttrain.descriptor_loss(torch.from_numpy(d[0]),
                                 torch.from_numpy(d[1]),
                                 torch.from_numpy(Hs), hc, wc)
    assert rel(got, ref) <= 1e-5


@pytest.fixture(scope="module")
def replay(tree):
    """The JAX train step replayed over train_superpoint's cached
    batches (seed 4, two batches cycled): per-step losses, the first
    step's gradients and the parameters after STEPS steps."""
    rng = np.random.default_rng(4)
    host = [make_pair_batch(rng, 2, H, W) for _ in range(2)]
    tx = optax.chain(capture(), optax.adam(LR))
    step = jtrain.make_train_step(JSuperPoint().net, tx)
    params = jax.tree.map(jnp.asarray, tree)
    opt = tx.init(params)
    losses, grads = [], None
    for k in range(STEPS):
        params, opt, metrics = step(params, opt,
                                    *map(jnp.asarray, host[k % 2]))
        losses.append(float(metrics["loss"]))
        if k == 0:
            grads = jax.tree.map(np.asarray, opt[0])
    return {"host": host, "losses": losses, "grads": grads,
            "params": jax.tree.map(np.asarray, params)}


def test_train_step_gradients(tree, replay):
    net = _net(tree)
    step = ttrain.make_train_step(net, Adam(net.parameters(), LR))
    metrics = step(*map(torch.from_numpy, replay["host"][0]))
    assert rel(metrics["loss"], replay["losses"][0]) <= 1e-5
    ref = superpoint_state_dict(replay["grads"])
    for name, p in net.named_parameters():
        scale = float(ref[name].abs().max())
        err = float((p.grad - ref[name]).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


def test_train_superpoint_replays_jax(tree, replay):
    state, history = ttrain.train_superpoint(
        steps=STEPS, batch=2, h=H, w=W, lr=LR, seed=4, n_cached_batches=2,
        params=superpoint_state_dict(tree), scan_chunk=1, device="cpu")
    assert [h["step"] for h in history] == list(range(STEPS))
    assert rel(history[0]["loss"], replay["losses"][0]) <= 1e-5
    # later steps start from parameters that may differ by 2 * lr * k
    for h, ref in zip(history[1:], replay["losses"][1:]):
        assert rel(h["loss"], ref) <= 1e-3
    ref = superpoint_state_dict(replay["params"])
    for name, t in state.items():
        assert float((t - ref[name]).abs().max()) <= 2 * LR * STEPS, name


def test_chunked_history(tree):
    """Chunks of scan_chunk steps give one history entry each, the
    batches cycling through the cache (5 steps over 2 batches)."""
    _, history = ttrain.train_superpoint(
        steps=5, batch=2, h=H, w=W, lr=LR, seed=4, n_cached_batches=2,
        params=superpoint_state_dict(tree), scan_chunk=2, device="cpu")
    assert [h["step"] for h in history] == [1, 3, 4]
    assert all(np.isfinite(h["chunk_mean"]) for h in history)


def test_homographic_adaptation(tree):
    pool = list(make_batch(np.random.default_rng(5), 2, 100, 140)[0])
    ref = jtrain.homographic_adaptation(
        jax.tree.map(jnp.asarray, tree), pool, np.random.default_rng(6),
        n_patches=3, n_warps=4, h=H, w=W)
    got = ttrain.homographic_adaptation(
        superpoint_state_dict(tree), pool, np.random.default_rng(6),
        n_patches=3, n_warps=4, h=H, w=W, device="cpu")
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert (got[1] < 64).sum() > 0
