"""Seconds of ALIKED-n16's `head` span a pair (`match.aliked.head`, key
`aliked_head`: the aggregation, the three upsamplings, the
concatenation, the score head and the L2 normalisation; summed over the
call's extractions), the mean over the window's pairs outside the traced
part; nothing where the program records no such span."""

from h100_bench.readers import stage_mean


def read(run):
    return stage_mean(run, "aliked_head")
