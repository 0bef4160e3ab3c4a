"""Masked softmax attention for the matcher transformers: a hand-written
CUDA kernel and its plain PyTorch version.

The kernel (`csrc/attention.cu`) replaces the Pallas kernel
`icepy4d_tpu/ops/attention.py::flash_attention`. It computes what the
TPU kernel computes: bf16 operands with f32 sums, q scaled by
hd^-0.5 * log2(e), exp2 after subtracting a row offset, masked keys
dropped, and `pv / max(den, 1e-20)`, so a query row whose keys are all
masked gives zeros. Two differences from the TPU kernel, both explained
in csrc/attention.cu: the offset subtracted is the row max rounded up to
an integer, and the max runs over the unmasked keys only (over all keys,
the denominator falls under the clamp where a masked key's logit exceeds
every valid one by more than ~66 in log2 units).

On this card the function is bound by the tensor cores and then by the
exponentials. The kernel is built for Hopper: a producer warp keeps TMA
loads of 128-key K and V tiles in flight through a ring of buffers, two
consumer warpgroups of 64 query rows each run both products as `wgmma`
and an online softmax between them, and the scaling of q, the mask (as
the bool tensor it is) and the final division are inside the kernel.
The tensor maps carry the tensors' own strides, so LightGlue's
(B, N, H, hd) head views go in without a copy; the output comes back in
that layout too (shape (B, H, Nq, hd), heads strided), which is what the
blocks reshape next.

`masked_attention` is the dispatch: a CPU tensor runs the plain version
in f32 (what the JAX package computes on the CPU for every row with at
least one valid key), a CUDA tensor launches the kernel (and raises if
it cannot). Every (B, H, Nq, Nk) with hd = 64 dispatches to it; other
head dims raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from icepy4d_tpu_torch.ops._build import CudaKernel

KERNEL = CudaKernel("attention.cu", "masked_attention_fwd", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
    ctypes.c_void_p, ctypes.c_void_p,                    # kmask, out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H, Nq, Nk
    *[ctypes.c_longlong] * 12,   # (batch, head, row) strides of q, k, v, out
    ctypes.c_float, ctypes.c_int,                        # q_scale, out_f32
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


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kmask: torch.Tensor) -> None:
    """Raise on what the kernel cannot take."""
    if q.ndim != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the attention kernel takes q (B, H, Nq, "
                         f"{HEAD_DIM}), got {tuple(q.shape)}")
    b, h, _, hd = q.shape
    nk = k.shape[2] if k.ndim == 4 else -1
    if k.shape != (b, h, nk, hd) or v.shape != k.shape \
            or kmask.shape != (b, nk):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} kmask {tuple(kmask.shape)}")
    if nk < 1:
        raise ValueError("the attention kernel needs at least one key")
    devices = {t.device for t in (q, k, v, kmask)}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"the attention kernel takes CUDA tensors on one "
                         f"device, got {sorted(str(d) for d in devices)}")


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """`t` as bf16 that a 16-byte load or a tensor map can address: unit
    stride in hd, every other stride a positive multiple of 8 elements,
    base 16-byte aligned. LightGlue's head views already are; anything
    else is copied."""
    t = t.to(torch.bfloat16)
    if t.stride(-1) != 1 or t.data_ptr() % 16 \
            or any(s <= 0 or s % 8 for s in _strides(t)):
        t = t.contiguous()
    return t


def _strides(t: torch.Tensor) -> list[int]:
    """(batch, head, row) strides in elements; a dim of size 1 may carry
    any stride, so it is given a valid one."""
    return [s if n > 1 else HEAD_DIM
            for s, n in zip(t.stride()[:3], t.shape[:3])]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kmask: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel. Shapes as `attention_plain`; hd must be 64.
    Returns (B, H, Nq, hd) in q's dtype, laid out as (B, Nq, H, hd)."""
    _check(q, k, v, kmask)
    b, h, nq, hd = q.shape
    nk = k.shape[2]
    out_dtype = q.dtype if q.dtype in (torch.bfloat16, torch.float32) \
        else torch.float32
    if q.dtype == torch.bfloat16:
        qb, q_scale = q, _prescale(hd)      # scaled and rounded in the kernel
    else:
        # the product is rounded to bf16 once, from f32, as in the plain
        # version: one fused pass here, and the kernel's scale is 1
        qb, q_scale = (q.float() * _prescale(hd)), 1.0
    qb, kb, vb = _tma_ready(qb), _tma_ready(k), _tma_ready(v)
    mask = kmask.to(torch.bool).contiguous()
    out = torch.empty((b, nq, h, hd), dtype=out_dtype,
                      device=q.device).transpose(1, 2)
    if out.numel():
        KERNEL.launch(q.device, qb.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                      mask.data_ptr(), out.data_ptr(), b, h, nq, nk,
                      *_strides(qb), *_strides(kb), *_strides(vb),
                      *_strides(out), q_scale,
                      int(out_dtype == torch.float32))
    return out.to(q.dtype)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kmask: torch.Tensor) -> torch.Tensor:
    """Differentiable masked attention in f32: the counterpart of the JAX
    package's `_xla_attention`, which its LightGlue training runs in place
    of the Pallas kernel (that kernel has no backward).

    Two products and a softmax, masked keys filled with -1e9 after the
    hd^-0.5 scale, so a query row whose keys are all masked gets the
    uniform average of v (the kernel and `attention_plain` give zeros).
    The training forward uses it on every device; it launches no kernel
    of this repository.
    """
    sim = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    sim = torch.where(kmask[:, None, None, :], sim, -1e9)
    return (torch.softmax(sim, -1) @ v.float()).to(q.dtype)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kmask: torch.Tensor) -> torch.Tensor:
    """Dispatch by device: the kernel on CUDA, the plain f32 version on
    the CPU."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kmask)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return flash_attention(q, k, v, kmask)
