"""The season over several processes (counterpart of
`icepy4d_tpu/parallel/distributed.py`), on `torch.distributed`.

Each process runs a contiguous shard of the epochs with the standard
per-epoch flow; checkpoints land in the shared results directory by
epoch, and the only traffic between processes is the small summary that
`all_gather_host` exchanges at the end. Launch one process a card with
`torchrun --nproc_per_node N script.py` (nccl), or on the CPU with
`device="cpu"` (gloo).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.parallel.mesh import Mesh, tree_map

def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None, device=None) -> bool:
    """Join the process group. Returns True when a multi-process group
    was initialised, False for a single process (no address given or
    found, or one process).

    coordinator_address "host:port" (default MASTER_ADDR:MASTER_PORT),
    num_processes (WORLD_SIZE), process_id (RANK): torchrun's
    variables. `device` resolves as `resolve_device` does: on the card
    the group uses nccl and the process's card is local_device_ids (an
    index or a list whose first entry counts; default LOCAL_RANK, else
    process_id modulo the visible cards); device="cpu" uses gloo."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes in (None, 1):
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        if local_device_ids is None:
            local = int(env.get("LOCAL_RANK",
                                process_id % torch.cuda.device_count()))
        elif isinstance(local_device_ids, int):
            local = local_device_ids
        else:
            local = int(list(local_device_ids)[0])
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))
    return True


def _local_device() -> torch.device:
    """The device this process joined the group with: its card under
    nccl (init_distributed made it the current one), else the CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


# partition_epochs' arguments take the two names
_index, _count = process_index, process_count


def global_mesh(axis_names=("epoch", "data"), axis_sizes=None) -> Mesh:
    """A mesh of every process's devices, processes on the first axis
    and each process's local devices on the second (the device this
    process joined with: one card, or the CPU). axis_sizes overrides
    the shape; its product must be the device count."""
    local = [_local_device()]
    n_proc = process_count()
    grid = np.empty(n_proc * len(local), dtype=object)
    for i in range(len(grid)):
        grid[i] = local[i % len(local)]
    if axis_sizes is None:
        axis_sizes = (n_proc, len(local))
    if int(np.prod(axis_sizes)) != len(grid):
        raise ValueError(f"{axis_sizes} != {len(grid)} devices")
    return Mesh(grid.reshape(axis_sizes), tuple(axis_names))


@dataclass(frozen=True)
class EpochShard:
    """This process's contiguous slice of the season."""

    start: int
    stop: int

    @property
    def indices(self) -> range:
        return range(self.start, self.stop)

    def __len__(self) -> int:
        return self.stop - self.start


def partition_epochs(n_epochs: int, process_index: int | None = None,
                     process_count: int | None = None) -> EpochShard:
    """Contiguous epoch range of one process (default: this one); the
    remainder goes to the first processes (shards differ by at most one
    epoch)."""
    pi = _index() if process_index is None else process_index
    pc = _count() if process_count is None else process_count
    base, rem = divmod(n_epochs, pc)
    start = pi * base + min(pi, rem)
    return EpochShard(start, start + base + (1 if pi < rem else 0))


def all_gather_host(tree):
    """Every process's tree of equal-shape host arrays, to every process:
    each leaf (shape s) comes back as a (process_count, *s) numpy array,
    one `dist.all_gather` a leaf (under nccl through this process's
    card)."""
    pc = process_count()
    if pc == 1:
        return tree_map(lambda x: np.asarray(x)[None], tree)

    def gather(x):
        a = np.ascontiguousarray(np.asarray(x))
        t = torch.from_numpy(a.astype(np.uint8) if a.dtype == bool else a)
        t = t.to(_local_device())
        parts = [torch.empty_like(t) for _ in range(pc)]
        dist.all_gather(parts, t)
        return torch.stack(parts).cpu().numpy().astype(a.dtype)

    return tree_map(gather, tree)
