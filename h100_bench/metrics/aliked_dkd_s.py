"""Seconds of ALIKED-n16's `dkd` span a pair (`match.aliked.dkd`, key
`aliked_dkd`: NMS with the border, top-K, the soft-argmax and the score
reads; summed over the call's extractions), the mean over the window's
pairs outside the traced part; nothing where the program records no such
span."""

from h100_bench.readers import stage_mean


def read(run):
    return stage_mean(run, "aliked_dkd")
