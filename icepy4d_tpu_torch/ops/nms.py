"""SuperPoint NMS and border zeroing: a hand-written CUDA kernel and its
plain PyTorch version.

The kernel (`csrc/nms.cu`) replaces the Pallas kernel
`icepy4d_tpu/ops/pallas_nms.py::fused_nms_border`. It computes exactly
`simple_nms` (five (2r+1)^2 max-pools with two suppression rounds) and
then zeroes a `border`-wide frame against the original h0 x w0 extent.
Max and equality are exact in f32, so the kernel's output is bitwise
equal to the plain version's.

`fused_nms_border` is the dispatch: a CPU tensor runs the plain version,
a CUDA tensor launches the kernel (and raises if it cannot).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from icepy4d_tpu_torch.ops._build import CudaKernel

KERNEL = CudaKernel("nms.cu", "fused_nms_border", [
    ctypes.c_void_p, ctypes.c_void_p,                  # heat, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int,          # B, H, W
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # r, border, h0, w0
])

# output tile side of the kernel; each block also loads a 5r halo
TILE = 32
SMEM_LIMIT = 227 * 1024


def smem_bytes(nms_radius: int) -> int:
    """Shared memory of one kernel block: three f32 and two u8 planes of
    the (TILE + 10r)^2 window (must match csrc/nms.cu)."""
    side = TILE + 10 * nms_radius
    return side * side * (3 * 4 + 2)


def simple_nms(scores: torch.Tensor, nms_radius: int = 4) -> torch.Tensor:
    """Max-pool NMS with two suppression rounds. scores: (B, H, W).

    Pools pad with -inf (F.max_pool2d's padding), as `reduce_window`
    does in the JAX package's `simple_nms`.
    """
    size = 2 * nms_radius + 1

    def max_pool(x):
        return F.max_pool2d(x[:, None], size, stride=1,
                            padding=nms_radius)[:, 0]

    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool(scores)
    for _ in range(2):
        supp_mask = max_pool(max_mask.to(scores.dtype)) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == max_pool(supp_scores)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def nms_border_plain(heat: torch.Tensor, nms_radius: int, border: int,
                     h0: int, w0: int) -> torch.Tensor:
    """Plain version of the kernel: simple_nms, then zero every pixel
    within `border` of the original h0 x w0 extent (or beyond it)."""
    out = simple_nms(heat, nms_radius)
    h, w = heat.shape[1:]
    ys = torch.arange(h, device=heat.device)
    xs = torch.arange(w, device=heat.device)
    frame = ((ys < border) | (ys >= h0 - border))[:, None] | \
        ((xs < border) | (xs >= w0 - border))[None, :]
    return torch.where(frame[None], 0.0, out)


def fused_nms_border(heat: torch.Tensor, nms_radius: int, border: int,
                     h0: int, w0: int) -> torch.Tensor:
    """simple_nms + border zeroing of a (B, H, W) f32 heatmap."""
    if heat.device.type == "cpu":
        return nms_border_plain(heat, nms_radius, border, h0, w0)
    if heat.device.type != "cuda":
        raise ValueError(f"unsupported device {heat.device}")
    if heat.dtype != torch.float32 or heat.ndim != 3:
        raise ValueError(f"heat must be (B, H, W) float32, got "
                         f"{tuple(heat.shape)} {heat.dtype}")
    if smem_bytes(nms_radius) > SMEM_LIMIT:
        raise ValueError(f"nms_radius {nms_radius} needs more shared "
                         f"memory than one block has")
    heat = heat.contiguous()
    b, h, w = heat.shape
    out = torch.empty_like(heat)
    if heat.numel():
        KERNEL.launch(heat.device, heat.data_ptr(), out.data_ptr(), b, h, w,
                      nms_radius, border, h0, w0)
    return out
