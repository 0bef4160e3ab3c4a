"""The port's small product modules == icepy4d_tpu's on the CPU:
`TrackTargets` (positions within 1e-3 px, `ok` equal, SNR within 1e-4
relative, the per-image CSVs of the same targets), the tracked time
series and their DataFrames (equal), the geospatial predicates and
`Rototranslation` (equal), and the logger, the profiler's trace and
`timeit`.
"""

import logging
from datetime import datetime, timedelta

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

import icepy4d_tpu.utils as JU
from icepy4d_tpu.core import Epoch as JEpoch
from icepy4d_tpu.core import Epoches as JEpoches
from icepy4d_tpu.core import Features as JFeatures
from icepy4d_tpu.core import Points as JPoints
import icepy4d_tpu_torch.utils as PU
from icepy4d_tpu_torch.core import Epoch, Epoches, Features, Points
from icepy4d_tpu_torch.utils import logger as plog
from icepy4d_tpu_torch.utils import profiler
from torch_port_inputs import DX, DY, shifted_pair


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_track_targets(tmp_path):
    """Five targets tracked from a frame (an array) into its shifted
    copy and into itself (PNG paths), at an SNR threshold of 5 (the
    small frame's texture peaks at SNR 5.5-6.8); one target too near the
    edge to track."""
    a, b = shifted_pair(240, 320)
    cv2.imwrite(str(tmp_path / "IMG_1.png"), b)
    cv2.imwrite(str(tmp_path / "IMG_2.png"), a)
    xy = np.array([[60.0, 70.0], [160.5, 120.25], [250.0, 180.0],
                   [100.0, 200.0], [3.0, 3.0]])   # the last two fail
    names = [f"T{i}" for i in range(5)]
    out = {}
    for tag, cls, kw in (("j", JU.TrackTargets, {}),
                         ("p", PU.TrackTargets, {"device": "cpu"})):
        tt = cls(a, [tmp_path / "IMG_1.png", tmp_path / "IMG_2.png"], xy,
                 out_dir=tmp_path / tag, target_names=names,
                 template_width=32, search_width=96, snr_threshold=5.0,
                 **kw)
        out[tag] = tt.track()
    assert out["j"].keys() == out["p"].keys()
    for stem in out["j"]:
        rj, rp = out["j"][stem], out["p"][stem]
        np.testing.assert_array_equal(rp["ok"], rj["ok"])
        np.testing.assert_allclose(rp["xy"], rj["xy"], atol=1e-3,
                                   equal_nan=True)
        np.testing.assert_allclose(rp["snr"], rj["snr"], rtol=1e-4)
        assert rp["ok"][:3].all() and not rp["ok"][3:].any()
        shift = [DX, DY] if stem == "IMG_1" else [0, 0]
        # templates sit on whole pixels: the rounded targets, shifted
        np.testing.assert_allclose(rp["xy"][:3], np.round(xy[:3]) - shift,
                                   atol=0.1)
        tj = pd.read_csv(tmp_path / "j" / f"{stem}.csv")
        tp = pd.read_csv(tmp_path / "p" / f"{stem}.csv")
        assert tp["label"].tolist() == tj["label"].tolist()
        np.testing.assert_allclose(tp[["x", "y"]], tj[["x", "y"]],
                                   atol=1.1e-3)
    with pytest.raises(ValueError, match="OC"):
        PU.TrackTargets(a, [b], xy, method="NCC", out_dir=tmp_path / "x",
                        device="cpu")


def season(epoch_cls, epoches_cls, feat_cls, pts_cls):
    """Three epochs; tracks 0-29 seen in all, 30-39 in the first two,
    40-49 only in the last; each moves by a seeded step an epoch."""
    rng = np.random.default_rng(0)
    xy0 = rng.uniform(0, 640, (50, 2))
    X0 = rng.uniform(0, 10, (50, 3))
    eps = epoches_cls()
    t0 = datetime(2022, 7, 28, 10)
    for e in range(3):
        ids = {0: np.arange(40), 1: np.arange(40),
               2: np.r_[np.arange(30), np.arange(40, 50)]}[e]
        feats = {c: feat_cls.from_numpy(xy0[ids] + e * (i + 1.5),
                                        track_ids=ids)
                 for i, c in enumerate(("cam1", "cam2"))}
        pts = pts_cls()
        pts.append_points_from_numpy(X0[ids] + 0.1 * e, track_ids=ids)
        eps.add_epoch(epoch_cls(t0 + timedelta(hours=e), features=feats,
                                points=pts), e)
    return eps


def test_time_series():
    je = season(JEpoch, JEpoches, JFeatures, JPoints)
    pe = season(Epoch, Epoches, Features, Points)
    sj = JU.tracked_features_time_series(je, "cam2")
    sp = PU.tracked_features_time_series(pe, "cam2")
    assert sj.keys() == sp.keys() and len(sp) == 40
    for t in sj:
        assert sj[t].keys() == sp[t].keys()
    pj = JU.tracked_points_time_series(je, min_tracked_epoches=3)
    pp = PU.tracked_points_time_series(pe, min_tracked_epoches=3)
    assert sorted(pp) == sorted(pj) == list(range(30))
    pd.testing.assert_frame_equal(PU.tracked_time_series_to_df(sp, pe),
                                  JU.tracked_time_series_to_df(sj, je))
    pd.testing.assert_frame_equal(PU.tracked_time_series_to_df(pp),
                                  JU.tracked_time_series_to_df(pj))
    for s_j, s_p in ((sj, sp), (pj, pp)):
        pd.testing.assert_frame_equal(PU.compute_displacements(s_p),
                                      JU.compute_displacements(s_j))
    assert PU.sort_features_by_cam(pe, "cam1").keys() == {0, 1, 2}


def test_geospatial():
    rng = np.random.default_rng(1)
    p2 = rng.uniform(0, 10, (200, 2))
    p3 = rng.uniform(0, 10, (200, 3))
    hull = rng.uniform(2, 8, (30, 3))
    rect = [2.0, 3.0, 7.0, 9.0]
    np.testing.assert_array_equal(PU.ccw_sort_points(p2),
                                  JU.ccw_sort_points(p2))
    np.testing.assert_array_equal(PU.points_in_rect(p2, rect),
                                  JU.points_in_rect(p2, rect))
    assert [PU.point_in_rect(p, rect) for p in p2[:20]] == \
        [JU.point_in_rect(p, rect) for p in p2[:20]]
    np.testing.assert_array_equal(PU.point_in_hull(p3, hull),
                                  JU.point_in_hull(p3, hull))
    np.testing.assert_array_equal(PU.point_in_volume(p3, hull),
                                  JU.point_in_volume(p3, hull))
    assert PU.convex_hull_volume(hull) == JU.convex_hull_volume(hull)
    fj, fp = JFeatures.from_numpy(p2), Features.from_numpy(p2)
    mj = JU.select_features_by_rect(fj, rect, inplace=True)
    mp = PU.select_features_by_rect(fp, rect, inplace=True)
    np.testing.assert_array_equal(mp, mj)
    np.testing.assert_array_equal(fp.kpts_to_numpy(), fj.kpts_to_numpy())


def test_rototranslation(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.uniform(-100, 100, (50, 3))
    for name in ("belvedere_loc2utm", "belvedere_utm2loc"):
        a, b = getattr(JU.Rototranslation, name)(), \
            getattr(PU.Rototranslation, name)()
        np.testing.assert_array_equal(b.T, a.T)
        np.testing.assert_array_equal(b.T_inv, a.T_inv)
        np.testing.assert_array_equal(b.transform(x), a.transform(x))
        np.testing.assert_array_equal(b.transform_inverse(x),
                                      a.transform_inverse(x))
        np.testing.assert_array_equal(getattr(PU, name)(x),
                                      getattr(JU, name)(x))
    b.write_T_mat_to_csv(tmp_path / "T.txt")
    np.testing.assert_array_equal(
        PU.Rotrotranslation.read_T_from_file(tmp_path / "T.txt").T, b.T)
    with pytest.raises(ValueError, match="4x4"):
        PU.Rototranslation(np.eye(3))


def test_logger_timer_profiler(tmp_path, caplog):
    log = plog.setup_logger(tmp_path / "logs", console_log_level="debug")
    assert log.name == "icepy4d_tpu_torch" and len(log.handlers) == 2
    log.info("hello")
    for h in log.handlers:
        h.flush()
    (f,) = (tmp_path / "logs").glob("icepy4d_tpu_torch_*.log")
    assert "hello" in f.read_text()
    assert plog.get_logger() is log
    with pytest.raises(ValueError, match="level"):
        plog.setup_logger(console_log_level="loud")
    plog.setup_logger()

    @plog.deprecated("use g")
    def f_old(v):
        return v + 1

    with pytest.warns(DeprecationWarning, match="f_old is deprecated"):
        assert f_old(1) == 2

    @PU.timeit
    def work(n):
        return sum(range(n))

    with caplog.at_level(logging.INFO, logger="icepy4d_tpu_torch"):
        assert work(10) == 45
    assert "Function work took" in caplog.text

    with profiler.trace(tmp_path / "prof"):
        with profiler.annotate("products"):
            torch.ones(64).sum()
    assert '"products"' in (tmp_path / "prof" / "trace.json").read_text()
