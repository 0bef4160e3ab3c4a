"""Both stereo Pipelines run the same synthetic 3-epoch season and agree.

The season (tests/torch_port_inputs.py::StereoSeason) is a layered,
textured scene seen by two calibrated parallel cameras 10 m apart, five
surveyed targets on stable faces and mtime timestamps; both packages
use the bundled LightGlue weights with an f32 trunk, 512 keypoints,
PYDEGENSAC, and orientation, absolute orientation, BA and recovery on.
The putative matches are the same computation in both packages, so
their counts are equal (within 3% for a relaxed rematch, whose
LightGlue threshold of 0 is decided by the trunks' last bits); the two
packages draw their RANSAC samples from
different generators, so verified and orientation counts agree within
3%, the BA RMSE within 0.05 px (and at or under 0.5 px wherever the
reference is), camera centres within 1 cm and rotations within 0.01
degrees. A sabotaged epoch is rescued by both recovery ladders the same
way."""

import csv

import numpy as np
import pytest
import torch

from icepy4d_tpu import Pipeline as JPipeline
from icepy4d_tpu.utils.config import DotDict as JDotDict
from icepy4d_tpu_torch.pipeline import Pipeline
from torch_port_inputs import REPO_WEIGHTS, StereoSeason

OPTIONS = {"superpoint_weights": str(REPO_WEIGHTS / "superpoint_synthetic.npz"),
           "lightglue_weights": str(REPO_WEIGHTS / "lightglue_synthetic.npz"),
           "activation_dtype": "float32"}

@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for the port: the suite runs several test
    files at once on a few cores, and this file's small ops gain little
    from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def season(tmp_path_factory):
    root = tmp_path_factory.mktemp("season")
    cfg = StereoSeason(480, 640, 640.0).write(root, max_keypoints=512,
                                              options=OPTIONS)
    return root, cfg


def _cfg(season, name: str, **proc):
    root, cfg = season
    cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in cfg.items()}
    cfg["paths"]["results_dir"] = str(root / name)
    cfg["proc"].update(proc)
    return cfg


def _sabotage(pipe):
    """Cut the first match call (the epoch's first attempt) to 4
    matches; the recovery ladder's rematch builds a new matcher."""
    orig = pipe.matcher.match
    calls = {"n": 0}

    def sabotaged(*a, **kw):
        out = orig(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 1:
            m = pipe.matcher
            for name in ("_mkpts0", "_mkpts1", "_scores0", "_scores1",
                         "_mconf"):
                setattr(m, name, getattr(m, name)[:4])
            for name in ("_descriptors0", "_descriptors1"):
                setattr(m, name, np.asarray(getattr(m, name))[:, :4])
        return out

    pipe.matcher.match = sabotaged
    return pipe


def _angle_deg(Ra, Rb) -> float:
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    s = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                        M[1, 0] - M[0, 1]]) / 2
    return float(np.degrees(np.arctan2(s, (np.trace(M) - 1) / 2)))


def _agree(eps, jeps):
    assert len(eps) == len(jeps)
    for e, j in zip(eps, jeps):
        q, jq = e.quality, j.quality
        assert (q["status"], q["flags"]) == (jq["status"], jq["flags"])
        assert q["stats"].get("recovered") == jq["stats"].get("recovered")
        s, js = q["stats"], jq["stats"]
        relaxed = "recovered" in js
        if relaxed:
            # the relaxed rematch filters LightGlue's matches at a score
            # threshold of 0, where the last bits of either trunk decide
            assert abs(s["n_putative"] - js["n_putative"]) \
                <= 0.03 * js["n_putative"]
        else:
            assert s["n_putative"] == js["n_putative"]
        for key in ("n_matches", "n_orientation_inliers"):
            assert abs(s[key] - js[key]) <= 0.03 * js[key], key
        if js["ba_rmse_px"] <= 0.5:
            assert s["ba_rmse_px"] <= 0.5
        if not relaxed:
            # (at the relaxed 2-px verification threshold each RANSAC
            # keeps its own borderline matches, and the RMSE follows them)
            assert abs(s["ba_rmse_px"] - js["ba_rmse_px"]) <= 0.05
        for c in ("cam1", "cam2"):
            np.testing.assert_allclose(e.cameras[c].C,
                                       np.asarray(j.cameras[c].C), atol=0.01)
            assert _angle_deg(e.cameras[c].R, j.cameras[c].R) <= 0.01


def test_season_agrees(season):
    cfg = _cfg(season, "res_port")
    eps = list(Pipeline(cfg, device="cpu").run())
    jeps = list(JPipeline(JDotDict.wrap(_cfg(season, "res_jax"))).run())
    _agree(eps, jeps)
    assert all(e.quality["status"] == "ok" for e in eps)
    assert all(len(e.points) >= 100 for e in eps)
    # sinks: one row an epoch with the reference's columns; checkpoints
    root = season[0]
    for name in ("residuals_image.csv", "estimated_cameras.csv"):
        with open(root / "res_port" / name) as f:
            rows = list(csv.reader(f))
        with open(root / "res_jax" / name) as f:
            jrows = list(csv.reader(f))
        assert rows[0] == jrows[0] and len(rows) == len(jrows) == 4
        assert [r[0] for r in rows] == [r[0] for r in jrows]
    assert len(list((root / "res_port" / "epochs").rglob("*.pickle"))) == 3


def test_sabotaged_epoch_is_recovered_alike(season):
    proc = {"epoch_to_process": [1], "save_checkpoints": False}
    eps = list(_sabotage(Pipeline(_cfg(season, "sab_port", **proc),
                                  device="cpu")).run())
    jeps = list(_sabotage(JPipeline(JDotDict.wrap(
        _cfg(season, "sab_jax", **proc)))).run())
    for got in (eps, jeps):
        assert got[0].quality["stats"]["recovered"] == "relaxed_rematch"
        assert got[0].quality["status"] == "ok"
    _agree(eps, jeps)


def test_unported_entry_points_raise(season):
    """Every matcher of the JAX package's registry builds; only the
    multi-device seasons still raise."""
    from icepy4d_tpu.pipeline import MATCHERS as JMATCHERS
    from icepy4d_tpu_torch.pipeline import MATCHERS

    assert set(MATCHERS) == set(JMATCHERS)
    cfg = _cfg(season, "unported")
    cfg["matching"] = dict(cfg["matching"], matcher="semidense")
    assert type(Pipeline(cfg, device="cpu").matcher).__name__ \
        == "SemiDenseMatcher"
    pipe = Pipeline(_cfg(season, "unported"), device="cpu")
    for name in ("run_batched", "run_distributed"):
        with pytest.raises(NotImplementedError, match=name):
            getattr(pipe, name)()


def _tracked_per_epoch(eps):
    """Features of each epoch whose track ids the epoch before held."""
    out = []
    for prev, e in zip(eps, eps[1:]):
        ids = e.features["cam1"].track_ids_to_numpy()
        out.append(int(np.isin(ids, prev.features["cam1"]
                               .track_ids_to_numpy()).sum()))
    return out


def test_tracking_season_agrees(season):
    proc = {"do_tracking": True, "save_checkpoints": False}
    eps = list(Pipeline(_cfg(season, "trk_port", **proc),
                        device="cpu").run())
    jeps = list(JPipeline(JDotDict.wrap(_cfg(season, "trk_jax",
                                             **proc))).run())
    assert [e.quality["status"] for e in eps] == \
        [e.quality["status"] for e in jeps]
    got, ref = _tracked_per_epoch(eps), _tracked_per_epoch(jeps)
    assert all(r > 20 for r in ref), ref
    for g, r in zip(got, ref):
        assert abs(g - r) <= 0.03 * r, (got, ref)
    _agree(eps, jeps)


def test_sift_season_with_gcp_prior_agrees(season):
    """The real season's path: SIFT, the GCP prior, tracking."""
    def cfg(name):
        c = _cfg(season, name, save_checkpoints=False, do_tracking=True)
        c["matching"] = dict(c["matching"], matcher="sift",
                             max_keypoints=2048,
                             options={"dual_orientation": False})
        return c

    pipe = Pipeline(cfg("sift_port"), device="cpu")
    eps = list(pipe.run())
    assert pipe._gcp_prior(eps[0]) is not None
    jeps = list(JPipeline(JDotDict.wrap(cfg("sift_jax"))).run())
    _agree(eps, jeps)
    assert all(e.quality["status"] == "ok" for e in eps)


def test_dense_epoch_agrees(season):
    proc = {"epoch_to_process": [0], "do_dense": True,
            "save_checkpoints": False}
    ep, = Pipeline(_cfg(season, "dense_port", **proc), device="cpu").run()
    jep, = JPipeline(JDotDict.wrap(_cfg(season, "dense_jax", **proc))).run()
    n, jn = len(ep.point_cloud), len(jep.point_cloud)
    assert jn > 10000
    assert abs(n - jn) <= 0.02 * jn
    C, jC = (np.asarray(e.cameras["cam1"].C).reshape(1, 3) for e in (ep, jep))
    depth = np.median(np.linalg.norm(ep.point_cloud.points - C, axis=1))
    jdepth = np.median(np.linalg.norm(jep.point_cloud.points - jC, axis=1))
    assert abs(depth - jdepth) <= 0.005 * jdepth
    ply = season[0] / "dense_port" / "epochs"
    assert len(list(ply.rglob("dense_*.ply"))) == 1


@pytest.mark.parametrize("matcher,options,expect", [
    # the plain NN matcher has no ratio test: the retry forces none
    ("nn", {"distance_threshold": 0.7},
     {"guided_band_px": 9.0, "guided_ratio": 0.95, "guided_min_sim": 0.55,
      "distance_threshold": 0.5}),
    ("sift", {"ratio_threshold": 0.98, "guided_band_px": 2.0},
     {"guided_band_px": 6.0, "guided_ratio": 0.95, "guided_min_sim": 0.55,
      "ratio_threshold": 0.98}),
])
def test_nn_family_recovery_is_permissive(season, matcher, options, expect):
    """The NN family's recovery rematch widens the band and relaxes the
    ratio and similarity floor, never past the live matcher's own
    settings, as the JAX ladder does (pipeline.py:942-970)."""
    cfg = _cfg(season, "relax")
    cfg["matching"] = dict(cfg["matching"], matcher=matcher,
                           options=dict(cfg["matching"]["options"], **options))
    pipe = Pipeline(cfg, device="cpu")
    opt, gv = pipe._relaxed_matcher_options(pipe._initialize_epoch(0))
    assert gv is None
    assert {k: opt.get(k) for k in expect} == expect
    assert ("ratio_threshold" in opt) == ("ratio_threshold" in expect)
    assert ("distance_threshold" in opt) == ("distance_threshold" in expect)
