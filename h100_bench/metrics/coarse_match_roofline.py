"""% of its roofline that LoFTR's coarse matching reaches: the
benchmark's bound of a pair's real tile pairs (each the larger of the
similarity product's 2 L0 L1 d FLOP at 989 TFLOP/s, the card's highest
dense rate, and c0 and c1 read once plus the kept matches written once
at 3.35 TB/s; `loftr_flops.py`) over `coarse_match_s`, the program's
span of the stage. A span and not the device trace: the stage runs
PyTorch's generic kernels, which the trace cannot tell apart by name.
Nothing where the program records no such span."""

from h100_bench.loftr_flops import coarse_match_pair_bound_s
from h100_bench.readers import stage_mean


def read(run):
    t = stage_mean(run, "coarse_match")
    if not t:
        return None
    return 100.0 * coarse_match_pair_bound_s(run) / t
