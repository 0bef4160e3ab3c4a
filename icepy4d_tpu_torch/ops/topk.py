"""Top-k with `jax.lax.top_k`'s tie order, and the two-pass top-2 of the
Lowe-ratio matchers (counterpart of `icepy4d_tpu/ops/topk.py`).

The JAX module's `safe_top_k` also broadcasts batch-1 operands with
long rows to batch 2, to step round a crash of the TPU compiler's top-k
emitter. That is a workaround for one compiler and is not ported.
"""

from __future__ import annotations

import torch


def safe_top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis of a 2-D (B, N) tensor, largest first,
    as (scores, indices).

    Equal values come out in index order, as `jax.lax.top_k` gives them
    (`torch.topk` leaves their order unspecified). The suppressed NMS
    map is mostly exact zeros, so the order of ties decides which empty
    cells fill the padded keypoint slots.
    """
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _lowest(dtype: torch.dtype):
    return (torch.finfo(dtype).min if dtype.is_floating_point
            else torch.iinfo(dtype).min)


def top2_last(x: torch.Tensor):
    """(best, second, argmax) along the last axis, by two max passes.

    Duplicate maxima behave as `lax.top_k` does: only the first argmax
    is masked for the second pass, so `second == best` when the row's
    maximum appears twice.
    """
    a1 = torch.argmax(x, dim=-1)
    s1 = torch.gather(x, -1, a1[..., None])[..., 0]
    masked = x.scatter(-1, a1[..., None], _lowest(x.dtype))
    return s1, masked.amax(dim=-1), a1
