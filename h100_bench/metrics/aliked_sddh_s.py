"""Seconds of ALIKED-n16's `sddh` span a pair (`match.aliked.sddh`, key
`aliked_sddh`: the patches, the offsets, the sampling, sf_conv and the
aggregation weights; summed over the call's extractions), the mean over
the window's pairs outside the traced part; nothing where the program
records no such span."""

from h100_bench.readers import stage_mean


def read(run):
    return stage_mean(run, "aliked_sddh")
