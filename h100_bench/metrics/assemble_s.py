"""Seconds of the matcher's `assemble` span a pair (`_assemble`: the
matched rows compacted on the card and copied to the host, inside
`matching`), the mean over the window's pairs outside the traced part;
nothing where the program records no such span."""

from h100_bench.readers import stage_mean


def read(run):
    return stage_mean(run, "assemble")
