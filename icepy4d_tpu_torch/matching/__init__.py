"""Matching engine: tiled SuperPoint + LightGlue matching, SIFT and
SuperPoint nearest-neighbour matching, geometric verification and
temporal tracking."""

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
    NearestNeighborMatcher,
    SIFTMatcher,
)
from icepy4d_tpu_torch.matching.tiling import Tiler  # noqa: F401
from icepy4d_tpu_torch.matching.tracking import (  # noqa: F401
    track_features,
    track_matches,
)
