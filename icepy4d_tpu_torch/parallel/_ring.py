"""The collectives of the sharded models: an axis object that stands in
for the `lax` collectives (`ppermute`, `all_gather`, `psum`, `pmax`)
that the JAX package's `shard_map` bodies call.

A body is written once against an axis and runs on local tensors whose
leading dim is L * B for the L shards held here, shard-major (row
l * B + b is batch row b of the l-th shard). Two backends:

- `InProcessAxis` (the mesh form): the axis's slots all name one device
  (the CPU in the tests, `cuda:0` on one card). All S shards sit on it
  under one leading dim of S * B, so token-local work (projections,
  rotary encoding, FFN, the models' blocks) runs once over every shard,
  and the dim is unfolded to (S, B, ...) only inside the collectives:
  `ppermute` is a roll along it.
- `GroupAxis` (the process form): the mesh's axis is the process axis of
  `parallel/distributed.py::global_mesh`; each process holds its shard
  (L = 1), `ppermute` is a `batch_isend_irecv` pair and the gathers
  and reductions are `torch.distributed` collectives (gloo on the CPU,
  nccl on cards).

`shard` and `unshard` move between the global tensors that callers pass
and get back and the local ones; in the process form `unshard`
all-gathers, so only O(N) outputs cross processes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from icepy4d_tpu_torch.parallel.distributed import _local_device
from icepy4d_tpu_torch.parallel.mesh import Mesh


def _check_split(n: int, size: int) -> int:
    if n % size:
        raise ValueError(f"token dim {n} is not divisible by the axis size "
                         f"{size}")
    return n // size


class InProcessAxis:
    """`size` shards on one device, folded into the leading dim."""

    def __init__(self, size: int, device: torch.device):
        self.size = size
        self.device = device
        self.index = torch.arange(size, device=device)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.size, -1, *x.shape[1:])

    def _merge(self, y: torch.Tensor) -> torch.Tensor:
        return y.reshape(-1, *y.shape[2:])

    def row_shards(self, rows: int) -> torch.Tensor:
        """The global shard index of each of `rows` local rows."""
        return self.index.repeat_interleave(rows // self.size)

    def shard(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Global (B, ..., N, ...) -> local (S * B, ..., N / S, ...)."""
        _check_split(x.shape[dim], self.size)
        return self._merge(torch.stack(x.chunk(self.size, dim)))

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        """A global per-batch tensor (B, ...) -> each shard's copy."""
        return self._merge(x.expand(self.size, *x.shape))

    def unshard(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Local (S * B, ..., n, ...) -> global (B, ..., S * n, ...)."""
        return torch.cat(self._split(x).unbind(0), dim)

    def ppermute(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """Shard s's block to shard s + shift (mod the size)."""
        return self._merge(torch.roll(self._split(x), shift, 0))

    def all_gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Every shard's block, concatenated along `dim` in shard order,
        to every shard."""
        return self.replicate(self.unshard(x, dim))

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self.replicate(self._split(x).sum(0))

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self.replicate(self._split(x).amax(0))


class GroupAxis:
    """One shard a process, over the default process group."""

    def __init__(self, size: int):
        self.size = size
        self.rank = dist.get_rank()
        self.device = _local_device()
        self.index = torch.tensor([self.rank], device=self.device)

    def row_shards(self, rows: int) -> torch.Tensor:
        return self.index.expand(rows)

    def shard(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        n = _check_split(x.shape[dim], self.size)
        return x.narrow(dim, self.rank * n, n).contiguous()

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def unshard(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return self.all_gather(x, dim)

    def ppermute(self, x: torch.Tensor, shift: int = 1,
                 wrap: bool = True) -> torch.Tensor:
        """Rank r's x to rank r + shift; without `wrap` (the pipeline's
        partial stage shift) the last ranks send nothing and the first
        receive zeros."""
        dst, src = self.rank + shift, self.rank - shift
        if wrap:
            dst, src = dst % self.size, src % self.size
        x = x.contiguous()
        ops = []
        if 0 <= dst < self.size:
            ops.append(dist.P2POp(dist.isend, x, dst))
        out = torch.zeros_like(x)
        if 0 <= src < self.size:
            ops.append(dist.P2POp(dist.irecv, out, src))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out

    def all_gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        return torch.cat(parts, dim)

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        y = x.clone()
        dist.all_reduce(y, op)
        return y

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Rank src's x to every rank."""
        y = x.contiguous().clone()
        dist.broadcast(y, src)
        return y


def group_axis(mesh: Mesh, axis: str) -> GroupAxis | None:
    """The process form of `axis`, when it is the process axis of a
    `global_mesh` in a group of more than one process."""
    if mesh.process_axis != axis or not dist.is_initialized() \
            or dist.get_world_size() == 1:
        return None
    size = mesh.shape[axis]
    if size != dist.get_world_size():
        raise ValueError(f"the {axis} axis has {size} slots for "
                         f"{dist.get_world_size()} processes")
    return GroupAxis(size)


def axis_of(mesh: Mesh, axis: str) -> InProcessAxis | GroupAxis:
    """The axis object of `mesh`'s `axis`. A sequence axis whose slots
    name several devices of one process raises: run one process a card
    under torchrun and build the mesh with `global_mesh`."""
    group = group_axis(mesh, axis)
    if group is not None:
        return group
    slots = mesh.slots(axis)
    if len(set(slots)) > 1:
        raise ValueError(
            f"the {axis} axis spans {sorted(set(map(str, slots)))} in one "
            f"process; a sharded axis across cards runs one process a card "
            f"(torchrun --nproc_per_node N, init_distributed(), "
            f"global_mesh(axis_names=({axis!r}, ...)))")
    return InProcessAxis(len(slots), slots[0])
