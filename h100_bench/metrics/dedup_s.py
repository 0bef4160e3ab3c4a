"""Seconds of the matcher's `dedup` span a pair (`_dedup`: the host's
unique keypoints of frame 0, inside `matching`), the mean over the
window's pairs outside the traced part; nothing where the program
records no such span."""

from h100_bench.readers import stage_mean


def read(run):
    return stage_mean(run, "dedup")
