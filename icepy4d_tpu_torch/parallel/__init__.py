"""Batched, multi-process and staged seasons (counterpart of
`icepy4d_tpu/parallel/`): a (data, model) grid of device slots, the
batched epoch steps, the multi-process epoch partition over
`torch.distributed`, and the two-stage extract/match pipeline on CUDA
streams. The JAX package's ring attention and its sequence- and
pipeline-parallel LightGlue, SuperGlue and LoFTR are not ported."""

from icepy4d_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    replicate,
    shard_batch,
)
from icepy4d_tpu_torch.parallel.epoch_step import (  # noqa: F401
    make_sharded_match_step,
    make_sharded_nn_step,
)
from icepy4d_tpu_torch.parallel.staged import (  # noqa: F401
    StagedPipeline,
    split_devices,
)
from icepy4d_tpu_torch.parallel.distributed import (  # noqa: F401
    EpochShard,
    all_gather_host,
    global_mesh,
    init_distributed,
    partition_epochs,
)
