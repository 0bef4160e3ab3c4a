"""SuperPoint and LightGlue as PyTorch modules, and the loader that
carries the JAX package's parameter trees across."""

from icepy4d_tpu_torch.models.lightglue import LightGlue  # noqa: F401
from icepy4d_tpu_torch.models.superpoint import (  # noqa: F401
    SuperPoint,
    SuperPointNet,
)
