"""SuperPoint NMS and border zeroing: a hand-written CUDA kernel and its
plain PyTorch version.

The kernel (`csrc/nms.cu`) replaces the Pallas kernel
`icepy4d_tpu/ops/pallas_nms.py::fused_nms_border`. It computes exactly
`simple_nms` (five (2r+1)^2 max-pools with two suppression rounds) and
then zeroes a `border`-wide frame against the original h0 x w0 extent.
Max and equality are exact in f32, so the kernel's output is bitwise
equal to the plain version's for every finite input.

The function is bound by bytes (one read and one write of the map); a
kernel pays for the 5r halo, shared-memory traffic and instruction issue
on top. The kernel's design: a block owns a WIN_H x WIN_W window and
writes its centre (`tile_shape`); pool k runs only on the rows the next
pool needs (`stage_rows`); a thread keeps a run of outputs in registers
and forms the (2r+1)-wide max in log steps; the max and suppression
masks are 32-pixel words, their pools ORs and shifts; the suppressed
scores are formed on the fly; one block per SM walks over the tiles and
fetches the next window into registers while it pools this one. The
constants below mirror the kernel's and are what the CPU tests hold its
geometry to.

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

# geometry of one kernel block (must match csrc/nms.cu)
WIN_H = 104                  # window rows
WIN_WORDS = 6                # window width in 32-pixel mask words
WIN_W = 32 * WIN_WORDS
RUN = 8                      # outputs a thread keeps in registers
COL_RUN_MAX = 24             # ... at most, in a column pass
THREADS = 384
N_POOLS = 5                  # each pool reaches nms_radius further
SMEM_LIMIT = 227 * 1024


def pitch(nms_radius: int) -> int:
    """Floats per row of a score plane: the window's columns between
    -inf pads of the radius rounded up to 4, and 4 more (an odd number
    of 16-byte vectors, which keeps the row pass free of bank conflicts)."""
    return WIN_W + 2 * 4 * ((nms_radius + 3) // 4) + 4


def smem_bytes(nms_radius: int) -> int:
    """Shared memory of one kernel block: two f32 planes of WIN_H x pitch
    and two bit planes of WIN_H x WIN_WORDS words."""
    return WIN_H * (2 * pitch(nms_radius) * 4 + 2 * WIN_WORDS * 4)


# largest radius (at most 9) whose tile still holds one run each way and
# whose planes fit one block's shared memory
MAX_RADIUS = max(r for r in range(10)
                 if min(WIN_H, WIN_W) - 2 * N_POOLS * r >= RUN
                 and smem_bytes(r) <= SMEM_LIMIT)


def col_run(n_rows: int) -> int:
    """Rows a thread takes at a time in a column pass over `n_rows`
    rows: the THREADS / WIN_W threads of a column get equally many runs
    of at most COL_RUN_MAX rows."""
    per_column = THREADS // WIN_W
    n_seg = per_column
    while -(-n_rows // n_seg) > COL_RUN_MAX:
        n_seg += per_column
    return max(RUN, -(-n_rows // n_seg))


def tile_shape(nms_radius: int) -> tuple[int, int]:
    """(rows, columns) one block writes: its window less the 5r halo."""
    halo = N_POOLS * nms_radius
    return WIN_H - 2 * halo, WIN_W - 2 * halo


def stage_rows(nms_radius: int, stage: int) -> tuple[int, int]:
    """Window rows [lo, hi) on which the kernel computes stage `stage`
    (1: first pool and max mask, 2 and 4: suppression masks, 3 and 5:
    re-pools; 0: the load). Every stage spans the window's whole width."""
    return stage * nms_radius, WIN_H - stage * nms_radius


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


def check_kernel_args(heat: torch.Tensor, nms_radius: int) -> None:
    """Raise on what the kernel does not take."""
    if heat.dtype != torch.float32 or heat.ndim != 3:
        raise ValueError(f"heat must be (B, H, W) float32, got "
                         f"{tuple(heat.shape)} {heat.dtype}")
    if not 0 <= nms_radius <= MAX_RADIUS:
        raise ValueError(f"nms_radius {nms_radius} outside the kernel's "
                         f"0..{MAX_RADIUS}")


def fused_nms_border(heat: torch.Tensor, nms_radius: int, border: int,
                     h0: int, w0: int) -> torch.Tensor:
    """simple_nms + border zeroing of a (B, H, W) f32 heatmap."""
    if heat.device.type == "cpu":
        return nms_border_plain(heat, nms_radius, border, h0, w0)
    if heat.device.type != "cuda":
        raise ValueError(f"unsupported device {heat.device}")
    check_kernel_args(heat, nms_radius)
    heat = heat.contiguous()
    b, h, w = heat.shape
    out = torch.empty_like(heat)
    if heat.numel():
        KERNEL.launch(heat.device, heat.data_ptr(), out.data_ptr(), b, h, w,
                      nms_radius, border, h0, w0)
    return out
