"""Seconds of LoFTR's `backbone` span a pair (`match.loftr.backbone`:
the ResNet-FPN over both frames' tiles, summed over the call's
forwards), the mean over the window's pairs outside the traced part;
nothing where the program records no such span."""

from h100_bench.readers import stage_mean


def read(run):
    return stage_mean(run, "backbone")
