"""Helpers shared by the training parity tests (tests/test_torch_*_train.py,
test_torch_finetune.py): they import JAX and optax, so they live apart
from torch_port_inputs.py, which chip_smoke.py imports on the card."""

import jax
import jax.numpy as jnp
import optax


def capture() -> optax.GradientTransformation:
    """An optax transform that passes the updates on and keeps the last
    gradients as its state: chained first, it hands a JAX train step's
    gradients out through the returned optimiser state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))


def rel(a, b) -> float:
    """|a - b| / |b| of two scalars."""
    return abs(float(a) - float(b)) / abs(float(b))
