"""Seconds of LoFTR's `fine` span a pair (`match.loftr.fine`: window
gather, merge, the fine (self, cross) pair and the expectation, summed
over the call's forwards), the mean over the window's pairs outside the
traced part; nothing where the program records no such span."""

from h100_bench.readers import stage_mean


def read(run):
    return stage_mean(run, "fine")
