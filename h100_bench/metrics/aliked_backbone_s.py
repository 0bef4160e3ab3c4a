"""Seconds of ALIKED-n16's `backbone` span a pair (`match.aliked.backbone`,
key `aliked_backbone`: blocks 1-4 of both frames' tiles, the four
deformable convolutions inside; summed over the call's extractions), the
mean over the window's pairs outside the traced part; nothing where the
program records no such span."""

from h100_bench.readers import stage_mean


def read(run):
    return stage_mean(run, "aliked_backbone")
