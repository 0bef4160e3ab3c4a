"""% of the card's dense bf16 peak (989 TFLOP/s, H100 SXM) that the whole
match step reaches: the algorithm's product FLOPs of the pairs traced
(SuperPoint over every tile, the matcher over every tile pair, at the
reference's keypoint counts) over the traced window's seconds."""

from h100_bench.flops import BF16_FLOPS
from h100_bench.readers import pair_flops


def read(run):
    if run.trace is None or not run.traced_items:
        return None
    return 100.0 * pair_flops(run) * run.traced_items \
        / run.trace.window_s / BF16_FLOPS
