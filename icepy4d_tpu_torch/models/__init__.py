"""SuperPoint and LightGlue as PyTorch modules, the parameter-free SIFT,
and the loader that carries the JAX package's parameter trees across."""

from icepy4d_tpu_torch.models.lightglue import LightGlue  # noqa: F401
from icepy4d_tpu_torch.models.superpoint import (  # noqa: F401
    SuperPoint,
    SuperPointNet,
)
from icepy4d_tpu_torch.models.sift import SIFT  # noqa: F401
