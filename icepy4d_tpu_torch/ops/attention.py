"""Masked softmax attention for the matcher transformers: a hand-written
CUDA kernel and its plain PyTorch version.

The kernel (`csrc/attention.cu`) replaces the Pallas kernel
`icepy4d_tpu/ops/attention.py::flash_attention`. Its contract is the
TPU kernel's: bf16 operands with f32 sums, q pre-scaled by
hd^-0.5 * log2(e), exp2 after subtracting the row max, key masking by
multiplying with the 0/1 mask, and `pv / max(den, 1e-20)` outside the
kernel, so a query row whose keys are all masked gives zeros. Two
differences from the TPU kernel, both explained in csrc/attention.cu:
the offset subtracted is the row max rounded up to an integer, and the
max runs over the unmasked keys only (over all keys, the denominator
falls under the clamp where a masked key's logit exceeds every valid
one by more than ~66 in log2 units).

`masked_attention` is the dispatch: a CPU tensor runs the plain version
in f32 (what the JAX package computes on the CPU for every row with at
least one valid key), a CUDA tensor launches the kernel (and raises if
it cannot). The kernel keeps 27.9 KB of shared memory per block whatever
the number of keys, so every (B, H, Nq, Nk) with hd = 64 dispatches to
it; other head dims raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from icepy4d_tpu_torch.ops._build import CudaKernel

KERNEL = CudaKernel("attention.cu", "masked_attention_fwd", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # kmask, pv, den
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, Nq, Nk
])

HEAD_DIM = 64   # the head dim csrc/attention.cu is compiled for


def _prescale(hd: int) -> float:
    return hd ** -0.5 * math.log2(math.e)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kmask: torch.Tensor,
                    operand_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of the kernel's arithmetic.

    q (B,H,Nq,hd), k/v (B,H,Nk,hd), kmask (B,Nk) bool. `operand_dtype`
    is the type q (after its pre-scale), k, v and the probabilities are
    rounded to before each product; sums are f32. bfloat16 is the
    kernel's contract, float32 the CPU slice's.
    """
    scale = _prescale(q.shape[-1])
    qs = (q.float() * scale).to(operand_dtype).float()
    ks = k.to(operand_dtype).float()
    vs = v.to(operand_dtype).float()
    keep = kmask[:, None, None, :]
    sim = torch.where(keep, qs @ ks.transpose(-1, -2), float("-inf"))
    mx = sim.amax(-1, keepdim=True)
    # ceil of the max over the unmasked keys (0 where every key is
    # masked): the kernel's online offset reaches the same integer
    p = torch.exp2(sim - torch.where(mx == float("-inf"), 0.0, mx.ceil()))
    pv = p.to(operand_dtype).float() @ vs
    den = p.sum(-1, keepdim=True)
    return (pv / den.clamp_min(1e-20)).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kmask: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. Shapes as `attention_plain`; hd must be 64."""
    b, h, nq, hd = q.shape
    nk = k.shape[2]
    if hd != HEAD_DIM:
        raise ValueError(f"the attention kernel takes hd={HEAD_DIM}, got {hd}")
    if k.shape != (b, h, nk, hd) or v.shape != k.shape \
            or kmask.shape != (b, nk):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} kmask {tuple(kmask.shape)}")
    qb = (q.float() * _prescale(hd)).to(torch.bfloat16).contiguous()
    kb = k.to(torch.bfloat16).contiguous()
    vb = v.to(torch.bfloat16).contiguous()
    mf = kmask.to(torch.float32).contiguous()
    pv = torch.empty((b, h, nq, hd), dtype=torch.float32, device=q.device)
    den = torch.empty((b, h, nq, 1), dtype=torch.float32, device=q.device)
    if pv.numel():
        KERNEL.launch(q.device, qb.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                      mf.data_ptr(), pv.data_ptr(), den.data_ptr(),
                      b, h, nq, nk)
    return (pv / den.clamp_min(1e-20)).to(q.dtype)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kmask: torch.Tensor) -> torch.Tensor:
    """Dispatch by device: the kernel on CUDA, the plain f32 version on
    the CPU."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kmask)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return flash_attention(q, k, v, kmask)
