"""The port's temporal tracking == icepy4d_tpu's with the bundled weights
in f32.

Both packages seed the same previous-epoch features (the JAX pair
match's, descriptors rounded to float16 as it hands them over) into the
next epoch's frames, which the scene has moved by one 8-px cell: the
set of features found agrees with a Jaccard index of at least 0.98 (a
match at LightGlue's filter threshold is decided by the trunks' last
bits), the positions of the features both find within 1e-3 px, and the
track ids are the same. The feature-cache path (the frames the pair
match just extracted) gives what the extraction path gives, and skips
the extraction. Three cameras with partly shared ids track their
intersection, and cameras with no common id track nothing. The frames'
sides are multiples of 10 px: on other sides the JAX package's
full-frame tracking is shifted by its tile's offset (ROADMAP section 3),
which the port does not copy."""

import numpy as np
import pytest
import torch

from icepy4d_tpu.core import Features as JFeatures
from icepy4d_tpu.matching import LightGlueMatcher as JMatcher
from icepy4d_tpu.matching import Quality as JQuality
from icepy4d_tpu.matching import TileSelection as JTS
from icepy4d_tpu.matching import tiling as jtiling
from icepy4d_tpu.matching import tracking as jtracking
from icepy4d_tpu.matching import GeometricVerification as JGV
from icepy4d_tpu_torch.core import Features
from icepy4d_tpu_torch.matching import (LightGlueMatcher, Quality,
                                        TileSelection, tiling, tracking)
from torch_port_inputs import DX, DY, REPO_WEIGHTS, jaccard, shifted_pair


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for the port: the suite runs several test
    files at once on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


H, W = 320, 400
STEP = 8                     # px the scene moves between the epochs
OPT = {"superpoint_weights": str(REPO_WEIGHTS / "superpoint_synthetic.npz"),
       "lightglue_weights": str(REPO_WEIGHTS / "lightglue_synthetic.npz"),
       "activation_dtype": "float32", "max_keypoints": 256}


def _frames(epoch: int, h: int = H):
    big, _ = shifted_pair(h + DY, W + DX + 2 * STEP)
    x = STEP * epoch
    return (np.ascontiguousarray(big[:h, x:x + W]),
            np.ascontiguousarray(big[DY:DY + h, DX + x:DX + x + W]))


@pytest.fixture(scope="module")
def matchers():
    return JMatcher(OPT), LightGlueMatcher(OPT, device="cpu")


@pytest.fixture(scope="module")
def prev(matchers):
    """The JAX pair match of epoch 0 as (kpts, descr, scores) per camera,
    with fresh track ids."""
    jm, _ = matchers
    jm.match(*_frames(0), quality=JQuality.HIGH, tile_selection=JTS.NONE,
             geometric_verification=JGV.NONE)
    n = len(jm.mkpts0)
    assert n > 100
    return {"cam1": (jm.mkpts0, jm.descriptors0.T, jm.scores0),
            "cam2": (jm.mkpts1, jm.descriptors1.T, jm.scores1),
            "ids": np.arange(100, 100 + n, dtype=np.int32)}


def _features(cls, prev, cams=("cam1", "cam2"), ids=None):
    out = {}
    for i, c in enumerate(cams):
        k, d, s = prev[("cam1", "cam2")[i % 2]]
        tid = prev["ids"] if ids is None else ids[i]
        sel = np.isin(prev["ids"], tid)
        f = cls(descr_dim=d.shape[1])
        f.append_features_from_numpy(k[sel], descr=d[sel], scores=s[sel],
                                     track_ids=prev["ids"][sel])
        out[c] = f
    return out


def _compare(got: dict, ref: dict):
    for c in ref:
        ig, ir = got[c].track_ids_to_numpy(), ref[c].track_ids_to_numpy()
        assert len(ir) > 20
        common, pg, pr = np.intersect1d(ig, ir, return_indices=True)
        assert len(common) >= 0.98 * len(np.union1d(ig, ir))
        np.testing.assert_allclose(got[c].kpts_to_numpy()[pg],
                                   ref[c].kpts_to_numpy()[pr], atol=1e-3)
        np.testing.assert_array_equal(ig[pg], ir[pr])


def test_bucket_seeds_identical():
    rng = np.random.default_rng(0)
    kpts = rng.uniform([0, 0], [W, H], size=(700, 2)).astype(np.float32)
    jt = jtiling.Tiler(grid=[2, 3], overlap=30)
    pt = tiling.Tiler(grid=[2, 3], overlap=30)
    jt.compute_limits_by_grid(np.empty((H, W)))
    pt.compute_limits_by_grid(np.empty((H, W)))
    for k in (64, 256):              # 64: some tiles overflow and drop
        for a, b in zip(tracking._bucket_seeds(kpts, pt, k),
                        jtracking._bucket_seeds(kpts, jt, k)):
            np.testing.assert_array_equal(a, b)


def test_track_features_matches_jax(matchers, prev):
    jm, pm = matchers
    new = _frames(1)[0]
    k, d, s = prev["cam1"]
    ref = jtracking.track_features(jm, k, d, s, new)
    got = tracking.track_features(pm, k, d, s, new)
    assert ref[1].sum() > 50
    assert jaccard(got[1], ref[1]) >= 0.98
    both = got[1] & ref[1]
    np.testing.assert_allclose(got[0][both], ref[0][both], atol=1e-3)
    np.testing.assert_allclose(got[2][both], ref[2][both], atol=1e-3)
    # the tracked features moved with the scene
    moved = k[got[1]] - got[0][got[1]]
    assert np.median(np.linalg.norm(moved - [STEP, 0], axis=1)) == 0.0


def test_full_frame_tracking_is_not_shifted(matchers):
    """At 312 px the grid's 1 x 1 tile is 310 px high at y = 2: the JAX
    package's tracked positions come out 2 px low, the port's do not."""
    jm, pm = matchers
    f0 = _frames(0, h=312)[0]
    jm.match(f0, _frames(0, h=312)[1], quality=JQuality.HIGH,
             tile_selection=JTS.NONE, geometric_verification=JGV.NONE)
    k, d, s = jm.mkpts0, jm.descriptors0.T, jm.scores0
    new = _frames(1, h=312)[0]
    ref = jtracking.track_features(jm, k, d, s, new)
    got = tracking.track_features(pm, k, d, s, new)
    for (pos, found), shift in ((got[:2], 0.0), (ref[:2], -2.0)):
        moved = k[found] - pos[found]
        assert found.sum() > 50
        np.testing.assert_array_equal(np.median(moved, axis=0),
                                      [STEP, shift])


@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
def test_track_matches_matches_jax(matchers, prev, grid):
    jm, pm = matchers
    new = dict(zip(("cam1", "cam2"), _frames(1)))
    kw = dict(grid=grid, overlap=40 if grid != (1, 1) else 0)
    ref = jtracking.track_matches(jm, _features(JFeatures, prev), new, **kw)
    got = tracking.track_matches(pm, _features(Features, prev), new, **kw)
    _compare(got, ref)
    # a feature is kept only where both cameras found it
    assert np.array_equal(got["cam1"].track_ids_to_numpy(),
                          got["cam2"].track_ids_to_numpy())


def test_cache_path_equals_extraction_path(matchers, prev, monkeypatch):
    _, pm = matchers
    f0, f1 = _frames(1)
    pm.match(f0, f1, quality=Quality.HIGH, tile_selection=TileSelection.NONE)
    calls = []
    extract = pm._extract
    monkeypatch.setattr(pm, "_extract",
                        lambda *a: calls.append(1) or extract(*a))
    cached = tracking.track_matches(pm, _features(Features, prev),
                                    {"cam1": f0, "cam2": f1})
    assert calls == []
    fresh = tracking.track_matches(pm, _features(Features, prev),
                                   {"cam1": f0.copy(), "cam2": f1.copy()})
    assert len(calls) == 1
    for c in ("cam1", "cam2"):
        for name in ("kpts_to_numpy", "descr_to_numpy", "scores_to_numpy",
                     "track_ids_to_numpy"):
            np.testing.assert_array_equal(getattr(cached[c], name)(),
                                          getattr(fresh[c], name)())


def test_three_cameras_with_differing_ids(matchers, prev):
    jm, pm = matchers
    ids = prev["ids"]
    # each camera holds a different subset; the intersection is tracked
    subsets = [ids[: 3 * len(ids) // 4], ids[len(ids) // 4:],
               ids[::2]]
    cams = ("cam1", "cam2", "cam3")
    f1a, f1b = _frames(1)
    new = {"cam1": f1a, "cam2": f1b, "cam3": f1a}
    ref = jtracking.track_matches(
        jm, _features(JFeatures, prev, cams, subsets), new)
    got = tracking.track_matches(
        pm, _features(Features, prev, cams, subsets), new)
    _compare(got, ref)
    common = np.intersect1d(np.intersect1d(subsets[0], subsets[1]),
                            subsets[2])
    assert set(got["cam3"].track_ids_to_numpy()) <= set(common)


def test_no_common_ids(matchers, prev):
    _, pm = matchers
    ids = prev["ids"]
    feats = _features(Features, prev, ids=[ids[:10], ids[10:20]])
    out = tracking.track_matches(pm, feats, dict(zip(("cam1", "cam2"),
                                                     _frames(1))))
    assert all(len(f) == 0 for f in out.values())
    assert out["cam1"].descr_dim == 256
