"""PyTorch/CUDA port of icepy4d_tpu, for one NVIDIA H100.

The package mirrors the layout of `icepy4d_tpu` module by module
(`icepy4d_tpu_torch/ops/attention.py` is the counterpart of
`icepy4d_tpu/ops/attention.py`, and so on) and imports nothing of it or
of JAX. Public entry points run on `"cuda"` unless the caller passes
`device="cpu"`; a default that finds no CUDA device raises.

The hand-written Hopper kernels live in `csrc/` and are built with
`nvcc` at first use (`ops/_build.py`). Each kernel's wrapper launches
the kernel for CUDA tensors and runs its plain PyTorch version for CPU
tensors.
"""

from icepy4d_tpu_torch.core import (  # noqa: F401
    Calibration,
    Camera,
    Epoch,
    Epoches,
    EpochDataMap,
    Features,
    FeatureSet,
    Image,
    ImageDS,
    PointCloud,
    Points,
    PointSet,
    Targets,
)
from icepy4d_tpu_torch.device import resolve_device  # noqa: F401
