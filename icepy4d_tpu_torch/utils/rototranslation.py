"""4x4 roto-translations of point arrays and the Belvedere site frame
(counterpart of `icepy4d_tpu/utils/rototranslation.py`; host numpy).

`Rototranslation` wraps a 4x4 transform for (n, 3) point arrays, with
the surveyed local <-> UTM 32N matrix of the Belvedere glacier site as
classmethod constructors.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# Surveyed similarity between the Belvedere local frame and
# WGS84/UTM 32N.
BELV_LOC2UTM = np.array(
    [
        [0.706579327583, -0.70687371492, -0.00012600114, 416614.833],
        [0.706873714924, 0.706579267979, 0.000202054813, 5090932.706],
        [-0.00005382637, -0.00023195939, 0.999462246895, 1767.547],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


class Rototranslation:
    """Apply a 4x4 transform to (n, 3) points."""

    def __init__(self, t_mat: np.ndarray) -> None:
        t_mat = np.asarray(t_mat, np.float64)
        if t_mat.shape != (4, 4):
            raise ValueError("expected a 4x4 matrix")
        self._T = t_mat

    @property
    def T(self) -> np.ndarray:
        return self._T

    @property
    def T_inv(self) -> np.ndarray:
        return np.linalg.inv(self._T)

    @classmethod
    def read_T_from_file(cls, file) -> "Rototranslation":
        return cls(np.loadtxt(Path(file)))

    @classmethod
    def belvedere_loc2utm(cls) -> "Rototranslation":
        return cls(BELV_LOC2UTM)

    @classmethod
    def belvedere_utm2loc(cls) -> "Rototranslation":
        return cls(np.linalg.inv(BELV_LOC2UTM))

    def transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64).reshape(-1, 3)
        return (x @ self._T[:3, :3].T) + self._T[:3, 3]

    def transform_inverse(self, x: np.ndarray) -> np.ndarray:
        Ti = self.T_inv
        x = np.asarray(x, np.float64).reshape(-1, 3)
        return (x @ Ti[:3, :3].T) + Ti[:3, 3]

    def write_T_mat_to_csv(self, fname, sep: str = " ") -> None:
        np.savetxt(fname, self._T, delimiter=sep)


# reference spelling
Rotrotranslation = Rototranslation


def belvedere_utm2loc(points: np.ndarray) -> np.ndarray:
    return Rototranslation.belvedere_utm2loc().transform(points)


def belvedere_loc2utm(points: np.ndarray) -> np.ndarray:
    return Rototranslation.belvedere_loc2utm().transform(points)
