"""Ring attention: sequence-parallel masked attention over a mesh axis
(counterpart of `icepy4d_tpu/parallel/ring_attention.py`).

The token axis is sharded over the axis; each shard holds one K/V block,
the blocks rotate around the ring (`_ring.py`'s `ppermute`), and the
softmax is accumulated online, so no shard builds the whole (N, N) score
matrix.

    ring = make_ring_attention(mesh, axis="seq")
    out = ring(q, k, v, kmask)

The arithmetic is the JAX ring's, in f32: masked keys get -1e9 added to
their logits, so a query row whose keys are all masked gets the uniform
average of v (as `ops/attention.py::dense_attention`, not the kernel's
zeros), and the output is num / max(den, 1e-30). The ring step is plain
matmuls and exponentials, as in the JAX package, where it is jnp outside
any Pallas kernel; it launches no kernel.
"""

from __future__ import annotations

import torch

from icepy4d_tpu_torch.parallel._ring import axis_of
from icepy4d_tpu_torch.parallel.mesh import Mesh

NEG = -1e9


def _ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          m: torch.Tensor, axis) -> torch.Tensor:
    """Per-shard body: q (L*B, H, nq, hd) local queries; k / v
    (L*B, H, nk, hd) and the key mask m (L*B, nk) the local K/V block,
    rotated around the ring."""
    b, h, nq, hd = q.shape
    scale = hd ** -0.5
    qf = q.float()
    mx = torch.full((b, h, nq), float("-inf"), device=q.device)
    num = torch.zeros((b, h, nq, hd), device=q.device)
    den = torch.zeros((b, h, nq), device=q.device)
    for i in range(axis.size):
        sim = (qf @ k.float().transpose(-1, -2)).mul_(scale)
        sim += ((m.float() - 1.0) * -NEG)[:, None, None, :]
        new_mx = torch.maximum(mx, sim.amax(-1))
        corr = torch.exp(mx - new_mx)
        p = sim.sub_(new_mx[..., None]).exp_()
        num = num * corr[..., None] + p @ v.float()
        den = den * corr + p.sum(-1)
        mx = new_mx
        if i + 1 < axis.size:
            k, v, m = (axis.ppermute(t) for t in (k, v, m))
    return (num / den.clamp_min(1e-30)[..., None]).to(q.dtype)


def make_ring_attention(mesh: Mesh, axis: str = "seq"):
    """A ring-attention callable over `mesh`'s `axis`.

    ring(q, k, v, kmask): global q (B, H, Nq, hd), k / v (B, H, Nk, hd),
    kmask (B, Nk); Nq and Nk must divide by the axis size. Tokens are
    sharded over the axis, everything else replicated. Returns the
    global (B, H, Nq, hd) on the axis's device."""
    ax = axis_of(mesh, axis)

    def ring(q, k, v, kmask):
        q, k, v = (ax.shard(t.to(ax.device), 2) for t in (q, k, v))
        m = ax.shard(kmask.to(ax.device), 1)
        return ax.unshard(_ring_attention_local(q, k, v, m, ax), 2)

    return ring
