"""The benchmark's own operation and byte counts, and the card's peaks.

Counts are the algorithms' at the published widths and these inputs'
shapes, never the program's own counters, so a change to the program
cannot move its yardstick. A FLOP is one multiply or one add of a
product (2 per multiply-accumulate) in a convolution or a matrix
product; element-wise work (activations, norms, softmax, the Sinkhorn
iterations) is left out, as `torch.utils.flop_counter` leaves it out.

Peaks and `lower_bound` are copied from `chip_smoke.py` (NVIDIA's data
sheet, H100 SXM, dense rates at 700 W).
"""

from __future__ import annotations

MEM_BPS = 3.35e12           # device memory rate, bytes/s
BF16_FLOPS = 989e12         # dense bf16 tensor-core rate, FLOP/s


def lower_bound(n_bytes: float, n_ops: float, ops_rate: float = BF16_FLOPS):
    """(seconds, what bounds it): the larger of bytes over the memory
    rate and operations over their peak rate."""
    t_bytes, t_ops = n_bytes / MEM_BPS, n_ops / ops_rate
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def conv(h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * h * w * cin * cout * k * k


def attention(b: int, h: int, nq: int, nk: int, hd: int) -> float:
    """q k^T and p v."""
    return 4.0 * b * h * nq * nk * hd


def attention_bytes(b: int, h: int, nq: int, nk: int, hd: int,
                    in_bytes: int = 2, out_bytes: int = 2) -> float:
    """q, k, v and the key mask read once, the output written once."""
    return b * h * (nq + 2 * nk) * hd * in_bytes + b * h * nq * hd * out_bytes \
        + b * nk


def nms_bytes(b: int, h: int, w: int) -> float:
    """A (b, h, w) f32 score map read once and written once."""
    return 2.0 * 4 * b * h * w
