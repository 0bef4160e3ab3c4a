"""Seconds of LoFTR's `coarse` span a pair (`match.loftr.coarse`: the
position encoding and the 4 (self, cross) linear-attention pairs,
summed over the call's forwards), the mean over the window's pairs
outside the traced part; nothing where the program records no such
span."""

from h100_bench.readers import stage_mean


def read(run):
    return stage_mean(run, "coarse")
