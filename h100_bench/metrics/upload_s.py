"""Seconds of the matcher's `upload` span a pair (both frames to the card
and preprocessed), the mean over the window's pairs outside the traced
part; nothing where the program records no such span."""

from h100_bench.readers import stage_mean


def read(run):
    return stage_mean(run, "upload")
