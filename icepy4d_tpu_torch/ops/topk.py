"""Top-k with `jax.lax.top_k`'s tie order."""

from __future__ import annotations

import torch


def safe_top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis of a 2-D (B, N) tensor, largest first.

    Equal values come out in index order, as `jax.lax.top_k` gives them
    (`torch.topk` leaves their order unspecified). The suppressed NMS
    map is mostly exact zeros, so the order of ties decides which empty
    cells fill the padded keypoint slots.
    """
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
