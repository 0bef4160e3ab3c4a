"""Seconds of ALIKED-n16's `dcn` span a pair (`match.aliked.dcn`, key
`aliked_dcn`: the four deformable convolutions of every tile, offsets
and taps included; summed over the call's extractions), the mean over
the window's pairs outside the traced part; nothing where the program
records no such span."""

from h100_bench.readers import stage_mean


def read(run):
    return stage_mean(run, "aliked_dcn")
