"""Device-mesh parallelism (counterpart of `icepy4d_tpu/parallel/`): a
(data, model) grid of device slots, the batched epoch steps, ring
attention and the sequence-parallel LightGlue and SuperGlue (tokens
sharded over an axis), the pipeline-parallel LightGlue and LoFTR coarse
transformer (layers staged over an axis), the multi-process epoch
partition over `torch.distributed`, and the two-stage extract/match
pipeline on CUDA streams. A sharded axis runs its shards in one process
when its slots name one device (`cuda:0` on one card, the CPU), or one
shard a process over the process axis of `global_mesh` (one process a
card under torchrun)."""

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
from icepy4d_tpu_torch.parallel.ring_attention import (  # noqa: F401
    make_ring_attention,
)
from icepy4d_tpu_torch.parallel.lightglue_sp import (  # noqa: F401
    make_sequence_parallel_lightglue,
)
from icepy4d_tpu_torch.parallel.superglue_sp import (  # noqa: F401
    make_sequence_parallel_superglue,
)
from icepy4d_tpu_torch.parallel.lightglue_pp import (  # noqa: F401
    make_pipeline_parallel_lightglue,
)
from icepy4d_tpu_torch.parallel.loftr_pp import (  # noqa: F401
    make_pipeline_parallel_loftr_coarse,
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
