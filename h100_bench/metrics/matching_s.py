"""Seconds of the matcher's `matching` stage a pair (its timer, which
synchronises the card at each stage's end), the mean over the window's
pairs outside the traced part."""

from h100_bench.readers import stage_mean


def read(run):
    return stage_mean(run, "matching")
