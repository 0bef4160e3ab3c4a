"""Seconds of LoFTR's `coarse_match` span a pair
(`match.loftr.coarse_match`: the L0 x L1 similarity, the dual softmax,
mutual nearest neighbours, threshold, border and top-k, summed over the
call's forwards), the mean over the window's pairs outside the traced
part; nothing where the program records no such span."""

from h100_bench.readers import stage_mean


def read(run):
    return stage_mean(run, "coarse_match")
