"""Seconds of the matcher's `model` span a pair (`_match_pair_batch`: the
gather and the matcher model's forward, inside `matching`), the mean
over the window's pairs outside the traced part; nothing where the
program records no such span."""

from h100_bench.readers import stage_mean


def read(run):
    return stage_mean(run, "model")
