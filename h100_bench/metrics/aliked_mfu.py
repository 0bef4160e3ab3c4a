"""% of the card's dense bf16 peak (989 TFLOP/s, H100 SXM) that the whole
ALIKED-n16 + LightGlue match step reaches: the algorithm's product FLOPs
of the traced pairs (ALIKED-n16 over the 8 tiles, LightGlue over the 16
tile pairs, at the reference's keypoint counts; `aliked_flops.py`) over
the traced window's seconds."""

from h100_bench.aliked_flops import pair_flops
from h100_bench.flops import BF16_FLOPS


def read(run):
    if run.trace is None or not run.traced_items:
        return None
    return 100.0 * pair_flops(run) * run.traced_items \
        / run.trace.window_s / BF16_FLOPS
