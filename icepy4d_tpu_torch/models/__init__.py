"""SuperPoint, LightGlue, SuperGlue, DISK, the repository's ALIKED-style
model, the published ALIKED-n16 and LoFTR as PyTorch modules, the
parameter-free SIFT, and the loaders that carry the JAX package's
parameter trees and the published checkpoints across."""

from icepy4d_tpu_torch.models.aliked import ALIKED  # noqa: F401
from icepy4d_tpu_torch.models.aliked_n16 import ALIKEDN16  # noqa: F401
from icepy4d_tpu_torch.models.disk import DISK  # noqa: F401
from icepy4d_tpu_torch.models.lightglue import LightGlue  # noqa: F401
from icepy4d_tpu_torch.models.loftr import LoFTR  # noqa: F401
from icepy4d_tpu_torch.models.superglue import SuperGlue  # noqa: F401
from icepy4d_tpu_torch.models.superpoint import (  # noqa: F401
    SuperPoint,
    SuperPointNet,
)
from icepy4d_tpu_torch.models.sift import SIFT  # noqa: F401
