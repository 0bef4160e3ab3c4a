"""Power-of-four shape buckets for variable-length point sets.

RANSAC verification pads its putative matches to these buckets, as the
JAX package does, so that both packages see the same padded inputs.
"""

from __future__ import annotations


def pad_bucket(n: int, floor: int = 64) -> int:
    """Smallest power-of-4 multiple of `floor` that holds `n`."""
    cap = floor
    while cap < n:
        cap *= 4
    return cap
