"""Pipeline-parallel LoFTR coarse transformer (counterpart of
`icepy4d_tpu/parallel/loftr_pp.py`).

The coarse LocalFeatureTransformer's (self, cross) layer pairs are split
over a mesh axis and tile-pair microbatches stream through the stages as
in `lightglue_pp.py` (the same schedule, bubble slots skipped). Only the
two (mb, L, 256) token sets cross stages; each stage reads its
microbatch's masks. The cross updates keep the published order: f1
attends to the already updated f0. LoFTR's attention is linear, so no
kernel runs.

    pp_coarse = make_pipeline_parallel_loftr_coarse(mesh, model)
    c0, c1 = pp_coarse(c0, c1, mask0, mask1)
    # == lft_apply(model.net.coarse, c0, c1, mask0, mask1, model.nhead)
"""

from __future__ import annotations

import torch

from icepy4d_tpu_torch.models.loftr import lft_apply
from icepy4d_tpu_torch.parallel.lightglue_pp import (micro_batches,
                                                     run_pipeline,
                                                     split_stages, stages_of)
from icepy4d_tpu_torch.parallel.mesh import Mesh


def make_pipeline_parallel_loftr_coarse(mesh: Mesh, model, axis: str = "pp",
                                        n_micro: int | None = None):
    """The staged coarse transformer of the LoFTR model `model` over
    `mesh[axis]` stages; its coarse pairs must divide by the stage count.

    pp_coarse(c0, c1, mask0, mask1) on a pair batch: c0 / c1 (B, L, D),
    mask0 / mask1 (B, L); B must divide by n_micro (default: one
    microbatch a stage). Runs under the model's matmul precision."""
    group, devices = stages_of(mesh, axis)
    stages = split_stages(model.net.coarse, devices, "coarse_pairs")

    def pp_coarse(c0, c1, mask0, mask1):
        dev = devices[0]
        nm = micro_batches(c0.shape[0], n_micro, len(devices))
        parts = [t.to(dev).chunk(nm) for t in (c0, c1, mask0, mask1)]

        def first(m):
            return parts[0][m], parts[1][m]

        def stage_fn(s, m, x):
            return lft_apply(stages[s], *x, parts[2][m].to(devices[s]),
                             parts[3][m].to(devices[s]), model.nhead)

        with torch.inference_mode(), model._precision():
            return run_pipeline(group, devices, stage_fn, first, nm)

    return pp_coarse
