"""ZNCC disparity sweep of a rectified pair: the hand-written CUDA kernel.

The kernel (`csrc/sweep.cu`) replaces the Pallas kernel
`icepy4d_tpu/ops/pallas_sweep.py::disparity_sweep_pallas`. Its plain
PyTorch version is `ops/dense.py::disparity_sweep_plain`, and
`ops/dense.py::disparity_sweep` is the dispatch: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel through
`disparity_sweep_kernel` (and raises if it cannot).

Both take the hypotheses as (disp_min, step) in float32 and round every
cost as the other does: the box sums run tap by tap in the same order
(no running sums) and the kernel is built without FMA contraction
(`ops/_build.py`), so the two are bitwise equal in cost.

With that arithmetic fixed, the function is bound on this card by the
f32 instruction rate, and before that by how many words a pixel and
hypothesis move through the load/store pipe. The kernel keeps the work
in registers: a block owns a 16-row tile 128 window columns wide for the
whole hypothesis loop; in the vertical pass a thread holds one window
column of the reference for 8 output rows in registers, reads the
shifted column of the secondary image straight into registers and
stores only the three vertical sums; in the horizontal pass a thread
owns a strip of 8 adjacent pixels of a row, loads its sums once with
128-bit loads and slides the window over them in registers. The sums are
double buffered (one barrier per hypothesis) and the argmin state of a
thread's 8 pixels never leaves its registers. Any H and W; windows 3 to
15, odd.
"""

from __future__ import annotations

import ctypes

import torch

from icepy4d_tpu_torch.ops._build import CudaKernel

KERNEL = CudaKernel("sweep.cu", "disparity_sweep", [
    ctypes.c_void_p, ctypes.c_void_p,                    # i0, i1
    ctypes.c_void_p, ctypes.c_void_p,                    # disparity, cost
    ctypes.c_void_p, ctypes.c_void_p,                    # uniqueness, inbounds
    ctypes.c_int, ctypes.c_int,                          # H, W
    ctypes.c_float, ctypes.c_float, ctypes.c_int,        # disp_min, step, n_disp
    ctypes.c_int,                                        # window
])

# the windows csrc/sweep.cu is compiled for
WINDOWS = (3, 5, 7, 9, 11, 13, 15)


def disparity_sweep_kernel(I0r: torch.Tensor, I1r: torch.Tensor,
                           disp_min, step, n_disp: int,
                           window: int) -> dict:
    """Launch the sweep kernel on (H, W) CUDA tensors.

    Hypothesis k is disp_min + k * step (float32 values). Returns dict of
    (H, W) disparity, cost, uniqueness (float32) and inbounds (bool).
    """
    if I0r.ndim != 2 or I1r.shape != I0r.shape:
        raise ValueError(f"I0r and I1r must be (H, W) of one shape, got "
                         f"{tuple(I0r.shape)} and {tuple(I1r.shape)}")
    if window not in WINDOWS:
        raise ValueError(f"the sweep kernel takes windows {WINDOWS}, "
                         f"got {window}")
    if n_disp < 1:
        raise ValueError(f"n_disp must be positive, got {n_disp}")
    if I0r.device.type != "cuda" or I1r.device != I0r.device:
        raise ValueError(f"the sweep kernel takes CUDA tensors on one "
                         f"device, got {I0r.device} and {I1r.device}")
    i0 = I0r.to(torch.float32).contiguous()
    i1 = I1r.to(torch.float32).contiguous()
    h, w = i0.shape
    disp, cost, uniq = (torch.empty_like(i0) for _ in range(3))
    inb = torch.empty((h, w), dtype=torch.bool, device=i0.device)
    if i0.numel():
        KERNEL.launch(i0.device, i0.data_ptr(), i1.data_ptr(),
                      disp.data_ptr(), cost.data_ptr(), uniq.data_ptr(),
                      inb.data_ptr(), h, w, float(disp_min), float(step),
                      n_disp, window)
    return {"disparity": disp, "cost": cost, "uniqueness": uniq,
            "inbounds": inb}
