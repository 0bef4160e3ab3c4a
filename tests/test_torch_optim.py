"""The port's optimiser pieces (`training/_optim.py`) against optax, the
JAX library the JAX package's trainers use: the schedules at chosen
update counts, the global-norm clip above and below its threshold, and
each trainer's optimiser over a few updates from the same parameters and
gradients.

Tolerances. Schedules: 1e-6 relative and 1e-6 of the peak learning
rate (optax evaluates them in float32, the port in float64; near the
end of a cosine 1 + cos cancels). Clip: 2e-7 relative, two float32
roundings of the global norm; a `+ 1e-6` on the norm, as
`torch.nn.utils.clip_grad_norm_` adds, is ten times that at a norm of
1.0001. Updates: each update is taken from the same parameters on both
sides and held within 2e-5 of its largest magnitude, the float32
rounding of Adam's bias corrections (optax raises b ** count in float32,
the port in float64: 1e-5 relative at the first update for b2 = 0.999),
plus one float32 spacing of the parameter, the rounding of `p + u`. An
eps inside the square root, or ten times optax's, moves the updates of
the leaf whose gradients are near eps by half or more. A
weight decay of 1e-2 in place of adamw's 1e-4 moves an update by
lr * 1e-2 * |p|, 100 spacings of a parameter near 1; a schedule read
after the count's increment moves it by 0.6% or more."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icepy4d_tpu_torch.training import _optim

SHAPES = [(3, 4), (5,), (2, 2, 3)]
LR = 3e-3
STEPS = 20
WARMUP = 4


def _counts(*counts):
    return sorted(set(c for c in counts if c >= 0))


SCHEDULES = {
    "cosine": (lambda: _optim.cosine_decay_schedule(LR, STEPS),
               lambda: optax.cosine_decay_schedule(LR, STEPS),
               _counts(0, 1, 2, STEPS // 2, STEPS - 1, STEPS, STEPS + 5)),
    "cosine_alpha": (lambda: _optim.cosine_decay_schedule(LR, STEPS, 0.1),
                     lambda: optax.cosine_decay_schedule(LR, STEPS, 0.1),
                     _counts(0, 7, STEPS, STEPS + 1)),
    # LightGlue's, with its max(steps, warmup + 1)
    "warmup_cosine": (
        lambda: _optim.warmup_cosine_decay_schedule(
            0.0, LR, WARMUP, max(STEPS, WARMUP + 1), LR * 0.05),
        lambda: optax.warmup_cosine_decay_schedule(
            0.0, LR, WARMUP, max(STEPS, WARMUP + 1), LR * 0.05),
        _counts(0, 1, WARMUP - 1, WARMUP, WARMUP + 1, STEPS - 1, STEPS,
                STEPS + 5)),
    # fewer steps than warmup: the decay still has one update to run
    "warmup_cosine_short": (
        lambda: _optim.warmup_cosine_decay_schedule(
            0.0, LR, WARMUP, max(2, WARMUP + 1), LR * 0.05),
        lambda: optax.warmup_cosine_decay_schedule(
            0.0, LR, WARMUP, max(2, WARMUP + 1), LR * 0.05),
        _counts(0, 1, WARMUP, WARMUP + 1, WARMUP + 2)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_optax(name):
    ours, theirs, counts = SCHEDULES[name]
    ours, theirs = ours(), theirs()
    for c in counts:
        ref = float(theirs(jnp.asarray(c, jnp.int32)))
        np.testing.assert_allclose(ours(c), ref, rtol=1e-6, atol=1e-6 * LR,
                                   err_msg=f"{name} at count {c}")


def test_lightglue_schedule_starts_at_zero():
    sched = _optim.lightglue_optimizer(
        [torch.zeros(1, requires_grad=True)], LR, STEPS, WARMUP).lr
    assert sched(0) == 0.0
    assert sched(WARMUP) == pytest.approx(LR, rel=1e-12)


def _grads(seed, norm):
    """Gradients of global norm `norm`; the last leaf's are 1e-8 of the
    others', so its sqrt(nu_hat) is of the order of eps and where eps
    stands shows."""
    rng = np.random.default_rng(seed)
    g = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    g[-1] *= np.float32(1e-8)
    total = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in g))
    return [(x * (norm / total)).astype(np.float32) for x in g]


@pytest.mark.parametrize("norm", [0.4, 1.0001, 3.7])
def test_clip_by_global_norm_matches_optax(norm):
    g = _grads(1, norm)
    ref, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(x) for x in g], optax.EmptyState())
    got = _optim.clip_by_global_norm([torch.from_numpy(x) for x in g], 1.0)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-7,
                                   atol=0)
    if norm < 1.0:
        for a, x in zip(got, g):
            np.testing.assert_array_equal(a.numpy(), x)


OPTIMIZERS = {
    "superpoint": (lambda p: _optim.superpoint_optimizer(p, LR),
                   lambda: optax.adam(LR)),
    "lightglue": (lambda p: _optim.lightglue_optimizer(p, LR, STEPS, WARMUP),
                  lambda: optax.chain(
                      optax.clip_by_global_norm(1.0),
                      optax.adam(optax.warmup_cosine_decay_schedule(
                          0.0, LR, WARMUP, max(STEPS, WARMUP + 1),
                          LR * 0.05)))),
    "aliked": (lambda p: _optim.aliked_optimizer(p, LR, STEPS),
               lambda: optax.chain(
                   optax.clip_by_global_norm(1.0),
                   optax.adamw(optax.cosine_decay_schedule(LR, STEPS)))),
}

# gradient norms above and below the clip's 1.0, one update each
NORMS = [5.0, 0.3, 2.0, 0.05, 1.5, 0.8, 12.0]


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """The trainer's optimiser and the JAX trainer's optax chain over
    the same gradients, each update from the port's parameters of the
    moment (magnitudes near 1, so adamw's decay shows): every update
    within f32 rounding, and the trajectories together at the end."""
    make_ours, make_theirs = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    init = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    params = [torch.from_numpy(x.copy()).requires_grad_() for x in init]
    opt = make_ours(params)
    tx = make_theirs()
    jparams = [jnp.asarray(x) for x in init]
    state = tx.init(jparams)
    for k, norm in enumerate(NORMS):
        g = _grads(10 + k, norm)
        before = [p.detach().clone() for p in params]
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x)
        opt.step()
        upd, state = tx.update([jnp.asarray(x) for x in g], state,
                               [jnp.asarray(b.numpy()) for b in before])
        jparams = optax.apply_updates(jparams, upd)
        for p, b, u in zip(params, before, upd):
            ref, got = np.asarray(u), p.detach().numpy()
            if name == "lightglue" and k == 0:
                # the schedule is read before the count's increment
                np.testing.assert_array_equal(ref, 0.0)
                np.testing.assert_array_equal(got, b.numpy())
                continue
            want = b.numpy() + ref
            err = np.abs(got - want)
            bound = 2e-5 * np.abs(ref).max() + np.spacing(np.abs(want))
            assert (err <= bound).all(), (name, k, float(err.max()))
    # optax's own trajectory, from the same start: within a few spacings
    for p, j in zip(params, jax.tree.leaves(jparams)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                   rtol=1e-6, atol=1e-6)
