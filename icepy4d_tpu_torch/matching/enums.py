"""Matching configuration enums (same names and values as
`icepy4d_tpu.matching.enums`).

  PYDEGENSAC -> hypothesis-parallel F-RANSAC with DEGENSAC-style
                plane-degeneracy detection and plane-and-parallax
                recovery (ops/ransac.py::ransac_fundamental_degensac)
  MAGSAC     -> sigma-consensus F estimation with a weighted polish
                (ops/ransac.py::ransac_fundamental_magsac)
  JAX_RANSAC -> plain fixed-threshold Sampson RANSAC
                (ops/ransac.py::ransac_fundamental); the name is kept so
                configurations carry over unchanged
"""

from enum import Enum


class TileSelection(Enum):
    NONE = 0
    EXHAUSTIVE = 1
    GRID = 2
    PRESELECTION = 3


class GeometricVerification(Enum):
    NONE = 0
    PYDEGENSAC = 1
    MAGSAC = 2
    JAX_RANSAC = 3


class Quality(Enum):
    LOW = 0
    MEDIUM = 1
    HIGH = 2
    HIGHEST = 3


QUALITY_NAMES = {
    Quality.LOW: "low",
    Quality.MEDIUM: "medium",
    Quality.HIGH: "high",
    Quality.HIGHEST: "highest",
}

# px scale of matched keypoints relative to the original image
QUALITY_SCALE = {
    Quality.LOW: 0.25,
    Quality.MEDIUM: 0.5,
    Quality.HIGH: 1.0,
    Quality.HIGHEST: 2.0,
}
