"""% of the card's dense bf16 peak (989 TFLOP/s, H100 SXM) that the whole
LoFTR match step reaches: the algorithm's product FLOPs of the traced
pairs' real tile pairs (the backbone over both tiles, the 16 coarse
encoder applications, the similarity and the fine stage at the
reference's kept matches; `loftr_flops.py`, the bucket's padding not
counted) over the traced window's seconds."""

from h100_bench.flops import BF16_FLOPS
from h100_bench.loftr_flops import pair_flops


def read(run):
    if run.trace is None or not run.traced_items:
        return None
    return 100.0 * pair_flops(run) * run.traced_items \
        / run.trace.window_s / BF16_FLOPS
