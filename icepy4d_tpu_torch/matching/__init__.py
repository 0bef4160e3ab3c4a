"""Matching engine: tiled SuperPoint + LightGlue or SuperGlue matching,
SIFT, DISK and ALIKED extractors, nearest-neighbour, semi-dense and
LoFTR matching, OC template matching, geometric verification and
temporal tracking, and the matching IO helpers (`matching.utils`)."""

from icepy4d_tpu_torch.matching.enums import (  # noqa: F401
    GeometricVerification,
    Quality,
    TileSelection,
)
from icepy4d_tpu_torch.matching.geometric_verification import (  # noqa: F401
    geometric_verification,
)
from icepy4d_tpu_torch.matching.matchers import (  # noqa: F401
    FeaturesBase,
    ImageMatcherBase,
    LightGlueMatcher,
    LOFTRMatcher,
    LoFTRMatcher,
    NearestNeighborMatcher,
    SemiDenseMatcher,
    SIFTMatcher,
    SuperGlueMatcher,
)
from icepy4d_tpu_torch.matching.templatematch import (  # noqa: F401
    MatchResult,
    TemplateMatch,
    forient,
    oc_track,
)
from icepy4d_tpu_torch.matching.tiling import Tiler  # noqa: F401
from icepy4d_tpu_torch.matching.tracking import (  # noqa: F401
    track_features,
    track_matches,
)
