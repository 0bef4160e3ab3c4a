"""Matching engine: tiled SuperPoint + LightGlue matching and geometric
verification."""

from icepy4d_tpu_torch.matching.enums import (  # noqa: F401
    GeometricVerification,
    Quality,
    TileSelection,
)
from icepy4d_tpu_torch.matching.geometric_verification import (  # noqa: F401
    geometric_verification,
)
from icepy4d_tpu_torch.matching.matchers import (  # noqa: F401
    ImageMatcherBase,
    LightGlueMatcher,
)
from icepy4d_tpu_torch.matching.tiling import Tiler  # noqa: F401
