"""The port's LightGlueMatcher.match == icepy4d_tpu's on the same random
weights and images, f32: the putative matches are the same set, and
PYDEGENSAC verification agrees by outcome (the two packages draw their
RANSAC samples from different generators)."""

import numpy as np
import pytest

from icepy4d_tpu.matching import LightGlueMatcher as JMatcher
from icepy4d_tpu_torch.matching import (GeometricVerification,
                                        LightGlueMatcher, Quality,
                                        TileSelection)
from icepy4d_tpu.matching import GeometricVerification as JGV
from icepy4d_tpu.matching import Quality as JQuality
from icepy4d_tpu.matching import TileSelection as JTileSelection
from torch_port_inputs import (DX, DY, jaccard, lightglue_tree,
                               shifted_pair, superpoint_tree)

CASES = {
    "full": dict(tile_selection="NONE"),
    "tiled": dict(tile_selection="EXHAUSTIVE", grid=[2, 2], overlap=20),
    "grid": dict(tile_selection="GRID", grid=[2, 2], overlap=20),
    "preselection": dict(tile_selection="PRESELECTION", grid=[2, 2],
                         overlap=20, min_matches_per_tile=2),
}


@pytest.fixture(scope="module")
def setup():
    opt = {"max_keypoints": 256, "n_layers": 2, "filter_threshold": 0.0,
           "activation_dtype": "float32", "precision": "highest",
           "superpoint_params": superpoint_tree(seed=2),
           "matcher_params": lightglue_tree(2, 256, 4, seed=3)}
    return (JMatcher(opt), LightGlueMatcher(opt, device="cpu"),
            shifted_pair())


# A pure translation leaves a family of F that explain the true matches;
# at a 1 px threshold each RANSAC run keeps its own borderline matches,
# at 2 px the consensus set is unique.
THRESHOLD = 2.0


def _match(m, images, enums, case, gv):
    GV, Q, TS = enums
    cfg = dict(CASES[case])
    ts = getattr(TS, cfg.pop("tile_selection"))
    m.match(*images, quality=Q.HIGH, tile_selection=ts,
            geometric_verification=getattr(GV, gv), threshold=THRESHOLD,
            **cfg)
    return m


def _rows(m):
    return np.c_[m.mkpts0, m.mkpts1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_putative_matches_equal(setup, case):
    ref, port, images = setup
    r = _rows(_match(ref, images, (JGV, JQuality, JTileSelection), case,
                     "NONE"))
    p = _rows(_match(port, images, (GeometricVerification, Quality,
                                    TileSelection), case, "NONE"))
    assert len(r) > 30
    np.testing.assert_array_equal(p[np.lexsort(p.T)], r[np.lexsort(r.T)])
    assert port.descriptors0.shape == (256, len(p))


@pytest.mark.parametrize("case", ["full", "tiled"])
def test_degensac_outcome(setup, case):
    ref, port, images = setup
    _match(ref, images, (JGV, JQuality, JTileSelection), case, "PYDEGENSAC")
    _match(port, images, (GeometricVerification, Quality, TileSelection),
           case, "PYDEGENSAC")
    # the putative sets are equal (test above) and in the same order
    assert jaccard(port.inlier_mask, ref.inlier_mask) >= 0.95
    err = np.linalg.norm(port.mkpts0 - port.mkpts1 - [DX, DY], axis=1)
    x0h = np.c_[port.mkpts0, np.ones(len(err))]
    x1h = np.c_[port.mkpts1, np.ones(len(err))]
    Fx0, Ftx1 = x0h @ port.F.T, x1h @ port.F
    sampson = np.sum(x1h * Fx0, 1) ** 2 / (
        Fx0[:, 0] ** 2 + Fx0[:, 1] ** 2 + Ftx1[:, 0] ** 2 + Ftx1[:, 1] ** 2)
    assert np.median(sampson[err < 1.5]) < THRESHOLD ** 2
