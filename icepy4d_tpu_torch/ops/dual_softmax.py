"""LoFTR's dual-softmax coarse match: a hand-written CUDA kernel and its
plain PyTorch version.

What the coarse match takes from the (B, L0, L1) dual-softmax
confidences conf = softmax(sim, 1) * softmax(sim, 2) is three vectors:
each row's best column `bj` = conf.argmax(2) and its confidence `bv` =
conf.amax(2), and each column's best row `bi` = conf.argmax(1). sim is
(c0 / sqrt(d)) (c1 / sqrt(d))^T / T with -1e9 wherever a cell of either
side is masked.

The kernel (`csrc/dual_softmax.cu`) replaces no Pallas kernel: the JAX
package runs the dual softmax as plain jnp. It computes the three vectors
from two passes of the product without the L0 x L1 matrix (see the
source): f32-accurate products (3xTF32), f32 statistics, ties to the
lowest index as torch.argmax, the plain version's values for masked rows
and columns.

`best_matches` is the dispatch: a CPU tensor runs the plain version
(`confidence_plain`, then `best_of`), which is the dense arithmetic the
port has always run; a CUDA tensor launches the kernel, or raises if it
cannot (d other than 256, a dtype other than float32).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from icepy4d_tpu_torch.ops import _build
from icepy4d_tpu_torch.ops._build import CudaKernel

KERNEL = CudaKernel("dual_softmax.cu", "dual_softmax_fwd", [
    ctypes.c_void_p, ctypes.c_void_p,                    # c0, c1
    ctypes.c_void_p, ctypes.c_void_p,                    # mask0, mask1
    ctypes.c_void_p,                                     # workspace
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # bj, bv, bi
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, L0, L1
    ctypes.c_float,                                      # scale
])

FEATURE_DIM = 256   # the feature dim csrc/dual_softmax.cu is compiled for
MAX_L1 = 131072     # the kernel's bound on L1 (a mask bit a column in smem)
MASKED = -1e9       # the similarity of a masked cell


def confidence_plain(c0: torch.Tensor, c1: torch.Tensor, mask0: torch.Tensor,
                     mask1: torch.Tensor, temperature: float) -> torch.Tensor:
    """Dual-softmax confidences (B, L0, L1) of c0 (B, L0, d) and c1
    (B, L1, d) under the cell masks (B, L0) and (B, L1)."""
    d = c0.shape[-1]
    n0 = c0 / math.sqrt(d)
    n1 = c1 / math.sqrt(d)
    sim = torch.bmm(n0, n1.transpose(1, 2)).div_(temperature)
    sim.masked_fill_(~(mask0[:, :, None] & mask1[:, None, :]), MASKED)
    conf = torch.softmax(sim, 1)
    return conf.mul_(torch.softmax(sim, 2))


def best_of(conf: torch.Tensor):
    """(bj, bv, bi) of confidences (B, L0, L1): each row's best column and
    its confidence, each column's best row."""
    return conf.argmax(2), conf.amax(2), conf.argmax(1)


def _check(c0: torch.Tensor, c1: torch.Tensor, mask0: torch.Tensor,
           mask1: torch.Tensor) -> None:
    """Raise on what the kernel cannot take."""
    if c0.ndim != 3 or c0.shape[-1] != FEATURE_DIM:
        raise ValueError(f"the dual-softmax kernel takes c0 (B, L0, "
                         f"{FEATURE_DIM}), got {tuple(c0.shape)}")
    b, l0, d = c0.shape
    l1 = c1.shape[1] if c1.ndim == 3 else -1
    if c1.shape != (b, l1, d) or mask0.shape != (b, l0) \
            or mask1.shape != (b, l1):
        raise ValueError(
            f"shape mismatch: c0 {tuple(c0.shape)} c1 {tuple(c1.shape)} "
            f"mask0 {tuple(mask0.shape)} mask1 {tuple(mask1.shape)}")
    if b < 1 or l0 < 1 or not 1 <= l1 <= MAX_L1:
        raise ValueError(f"the dual-softmax kernel takes B, L0 >= 1 and "
                         f"1 <= L1 <= {MAX_L1}, got {b}, {l0}, {l1}")
    if c0.dtype != torch.float32 or c1.dtype != torch.float32:
        raise ValueError(f"the dual-softmax kernel takes float32 features, "
                         f"got {c0.dtype} and {c1.dtype}")
    if mask0.dtype != torch.bool or mask1.dtype != torch.bool:
        raise ValueError(f"the dual-softmax kernel takes bool masks, got "
                         f"{mask0.dtype} and {mask1.dtype}")
    devices = {t.device for t in (c0, c1, mask0, mask1)}
    if len(devices) != 1 or c0.device.type != "cuda":
        raise ValueError(f"the dual-softmax kernel takes CUDA tensors on one "
                         f"device, got {sorted(str(x) for x in devices)}")


@functools.lru_cache(maxsize=64)
def _workspace_bytes(b: int, l0: int, l1: int) -> int:
    fn = _build.load(KERNEL.source).dual_softmax_workspace
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return int(fn(b, l0, l1))


def dual_softmax_kernel(c0: torch.Tensor, c1: torch.Tensor,
                        mask0: torch.Tensor, mask1: torch.Tensor,
                        temperature: float):
    """Launch the CUDA kernel: (bj (B, L0) int64, bv (B, L0) f32, bi (B, L1)
    int64) as `best_of(confidence_plain(...))` gives them."""
    _check(c0, c1, mask0, mask1)
    b, l0, d = c0.shape
    l1 = c1.shape[1]
    c0, c1 = c0.contiguous(), c1.contiguous()
    mask0, mask1 = mask0.contiguous(), mask1.contiguous()
    dev = c0.device
    work = torch.empty(_workspace_bytes(b, l0, l1), dtype=torch.uint8,
                       device=dev)
    bj = torch.empty((b, l0), dtype=torch.int64, device=dev)
    bv = torch.empty((b, l0), dtype=torch.float32, device=dev)
    bi = torch.empty((b, l1), dtype=torch.int64, device=dev)
    scale = math.log2(math.e) / (d * temperature)
    KERNEL.launch(dev, c0.data_ptr(), c1.data_ptr(), mask0.data_ptr(),
                  mask1.data_ptr(), work.data_ptr(), bj.data_ptr(),
                  bv.data_ptr(), bi.data_ptr(), b, l0, l1, scale)
    return bj, bv, bi


def best_matches(c0: torch.Tensor, c1: torch.Tensor, mask0: torch.Tensor,
                 mask1: torch.Tensor, temperature: float):
    """Dispatch by device: the kernel on CUDA, the plain dense version on
    the CPU. Returns (bj, bv, bi)."""
    if c0.device.type == "cpu":
        return best_of(confidence_plain(c0, c1, mask0, mask1, temperature))
    if c0.device.type != "cuda":
        raise ValueError(f"unsupported device {c0.device}")
    return dual_softmax_kernel(c0, c1, mask0, mask1, temperature)
