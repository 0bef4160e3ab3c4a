"""Operand rounding for the reference and its lower-precision control.

The reference computes every product in float32 with TF32 off. A
precision name says to what the operands of a product (activations and
weights) are rounded before it: "f32" leaves them, "tf32" keeps 10
mantissa bits, "bf16" 7, "fp8" is float8 e4m3 (3 bits, saturating at
448). Sums stay float32, as on the card's tensor cores.
"""

from __future__ import annotations

import contextlib

import torch

# one step below each precision a configuration can state
LOWER = {"f32": "bf16", "tf32": "bf16", "bf16": "fp8"}
FP8_MAX = 448.0


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """`x` (float32) rounded to `precision` and returned as float32."""
    if precision == "f32":
        return x
    if precision == "tf32":
        bits = x.float().contiguous().view(torch.int32)
        # round to nearest on the 13 dropped mantissa bits
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "fp8":
        return x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float()
    raise ValueError(f"unknown precision {precision!r}")


def lowered(precisions: dict) -> dict:
    """The control's precisions: each part one step below the stated."""
    return {k: LOWER[v] for k, v in precisions.items()}


@contextlib.contextmanager
def full_f32():
    """Matrix products and cuDNN convolutions in full float32 inside the
    block (no TF32), whatever the caller set."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def linear(x: torch.Tensor, w: dict, precision: str) -> torch.Tensor:
    """x @ kernel + bias for a dense layer {"kernel" (in, out), "bias"}."""
    y = round_to(x, precision) @ round_to(w["kernel"], precision)
    return y + w["bias"] if "bias" in w else y
