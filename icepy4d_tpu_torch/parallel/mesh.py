"""A (data, model) grid of device slots (counterpart of
`icepy4d_tpu/parallel/mesh.py`).

The JAX package lays a named `jax.sharding.Mesh` over its devices and
lets XLA split a batch over the data axis. Here a `Mesh` is a (dp, tp)
grid of `torch.device` slots, dealt round-robin over the visible devices
of one type: on one card every slot names `cuda:0`, and `make_mesh(4)`
is a batch of four epochs in one forward (the one-card form of the JAX
tests' eight virtual CPU devices); on several cards each card runs the
slots that name it. The model axis is accepted and validated as in the
JAX package; the sequence- and pipeline-parallel models shard tokens
and layers over a named axis (`parallel/_ring.py`), whose slots may all
name one device: there each slot is one shard of a tensor on it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from icepy4d_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """devices: (dp, tp) object array of torch.device slots;
    process_axis: the axis whose slots are the processes of a
    `torch.distributed` group (set by `global_mesh`), if any."""

    devices: np.ndarray
    axis_names: tuple[str, str] = ("data", "model")
    process_axis: str | None = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def slots(self, axis: str = "data") -> list[torch.device]:
        """The devices along `axis` (the first slot of the other axis)."""
        i = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, i, 0)[:, 0])

    @property
    def distinct(self) -> list[torch.device]:
        """Each device once, in slot order."""
        out: list[torch.device] = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out


def _visible(device: torch.device) -> list[torch.device]:
    if device.index is not None:
        return [device]
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              tp: int | None = None,
              axis_names: tuple[str, str] = ("data", "model"),
              device=None) -> Mesh:
    """A (dp, tp) mesh of `n_devices` slots (default: one a visible
    device). Without dp and tp every slot goes to the data axis; given
    one, the other is n_devices // it; dp * tp != n_devices raises
    ValueError. `device` resolves as `resolve_device` does (the card by
    default, the CPU only when asked); the slots go round-robin over the
    visible devices of its type (one given with an index: that one)."""
    dev = resolve_device(device)
    devs = _visible(dev)
    n = n_devices or len(devs)
    if dp is None and tp is None:
        dp, tp = n, 1
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"dp*tp={dp * tp} != n_devices={n}")
    grid = np.empty(n, dtype=object)
    for i in range(n):
        grid[i] = devs[i % len(devs)]
    return Mesh(grid.reshape(dp, tp), tuple(axis_names))


def tree_map(fn, tree):
    """`fn` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _to(device: torch.device, non_blocking: bool = False):
    def move(a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a)
        return a.to(device, non_blocking=non_blocking) \
            if torch.is_tensor(a) else a
    return move


def replicate(mesh: Mesh, tree) -> dict:
    """{device: the tree with its leaves on that device} for each
    distinct device of the mesh (one entry on one card)."""
    return {d: tree_map(_to(d), tree) for d in mesh.distinct}


def shard_batch(mesh: Mesh, tree, axis: str = "data") -> list:
    """One tree per slot along `axis`: slot i holds rows [i * b / n,
    (i + 1) * b / n) of every leaf, on its device. Leading dims must
    divide by the axis size (pad batches to the mesh size upstream), as
    in the JAX package."""
    slots = mesh.slots(axis)
    n = len(slots)
    for a in _leaves(tree):
        if hasattr(a, "shape") and a.shape[0] % n:
            raise ValueError(f"leading dim {a.shape[0]} is not divisible "
                             f"by the {axis} axis ({n})")
    out = []
    for i, d in enumerate(slots):
        def take(a, i=i):
            if not hasattr(a, "shape"):
                return a
            m = a.shape[0] // n
            return _to(d)(a[i * m:(i + 1) * m])
        out.append(tree_map(take, tree))
    return out
