"""The port's n-camera path against icepy4d_tpu's.

N-view and linear LS triangulation agree within 1e-4 of the scene's
depth. Both pipelines run the three-camera rig of tests/test_multicam.py
(240x320, a ground-truth matcher stub, so the putatives are equal by
construction) and a three-camera synthetic season
(tests/torch_port_inputs.py::StereoSeason with n_cameras=3, bundled
LightGlue weights, f32 trunk): equal statuses and flags and equal
putative counts per slave; track counts, verified counts and
orientation inliers within 3% (the two packages' RANSACs draw from
different generators); BA RMSE within 0.05 px; camera centres within
1 cm; the NaN-padded residuals_image.csv with the same rows. The port's
reprojection filter of the n-camera path (which the JAX package lacks)
is patched out for these comparisons; left in, it drops the
observations that do not reproject and the BA RMSE falls below the JAX
package's. Rotations
are held relative to the master, within 0.01 degrees: the multicam BA
takes no targets, and with the rig's nearly collinear camera centres
(the season's are collinear) their priors leave a rotation about the
centres' line free; on the rig both solvers stop 0.19 degrees apart
along it at the same RMSE to seven digits, and agree within 0.001
degrees before the BA. On the season the relative rotations are held
within 0.025 degrees: the BA has no targets there, and the port's own
relative rotations over six RANSAC seeds span 0.027-0.047 degrees (the
JAX package's seed lands at 0.043, the port's at 0.033; at f = 640 px a
0.01-degree turn is a tenth of a pixel)."""

import csv
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu import Pipeline as JPipeline
from icepy4d_tpu.core.camera import Camera as JCamera
from icepy4d_tpu.ops import triangulation as jtri
from icepy4d_tpu.sfm import Triangulate as JTriangulate
from icepy4d_tpu.utils.config import DotDict as JDotDict
from icepy4d_tpu_torch import pipeline as pipeline_mod
from icepy4d_tpu_torch.core import Camera, Features
from icepy4d_tpu_torch.ops import triangulation as tri
from icepy4d_tpu_torch.pipeline import Pipeline
from icepy4d_tpu_torch.sfm import Triangulate
from test_multicam import CENTERS, GroundTruthMatcher, rig  # noqa: F401
from torch_port_inputs import REPO_WEIGHTS, StereoSeason, rotation_zyx

K = np.array([[900.0, 0, 330], [0, 905.0, 235], [0, 0, 1]], np.float32)
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for the port: the suite runs several test
    files at once on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _views(n=300, v=3, seed=0, noise=0.4):
    """v cameras around a deep block of points; each point misses one
    random view a third of the time."""
    rng = np.random.default_rng(seed)
    X = np.c_[rng.uniform(-4, 4, (n, 2)), rng.uniform(8, 20, n)].astype(
        np.float32)
    Ps, us = [], []
    for i in range(v):
        R = rotation_zyx(0.12 * (i - 1), 0.03 * i, 0.01 * i)
        C = np.array([1.5 * (i - 1), 0.2 * i, 0.1 * i], np.float32)
        P = (K @ np.c_[R, -R @ C]).astype(np.float32)
        uvw = np.c_[X, np.ones(n)] @ P.T
        uv = uvw[:, :2] / uvw[:, 2:]
        Ps.append(P)
        us.append((uv + rng.normal(0, noise, uv.shape)).astype(np.float32))
    mask = np.ones((v, n), bool)
    miss = rng.uniform(size=n) < 1 / 3
    mask[rng.integers(0, v, int(miss.sum())), np.nonzero(miss)[0]] = False
    return X, np.stack(us), np.stack(Ps), mask


@pytest.mark.parametrize("masked", [False, True])
def test_triangulate_nview(masked):
    X, us, Ps, mask = _views()
    m = mask if masked else None
    ref = np.asarray(jtri.triangulate_nview(
        jnp.asarray(us), jnp.asarray(Ps),
        None if m is None else jnp.asarray(m)))
    got = tri.triangulate_nview(
        torch.from_numpy(us), torch.from_numpy(Ps),
        None if m is None else torch.from_numpy(m)).numpy()
    depth = np.maximum(np.abs(X[:, 2:3]), 1.0)
    assert np.all(np.abs(got - ref) <= TOL * depth)
    assert np.median(np.linalg.norm(got - X, axis=1)) < 0.1


def test_linear_ls_triangulation():
    X, us, Ps, _ = _views(v=2)
    args = (us[0], us[1], Ps[0], Ps[1])
    ref = np.asarray(jtri.linear_ls_triangulation(*map(jnp.asarray, args)))
    got = tri.linear_ls_triangulation(*map(torch.from_numpy, args)).numpy()
    depth = np.maximum(np.abs(X[:, 2:3]), 1.0)
    assert np.all(np.abs(got - ref) <= TOL * depth)


def test_triangulate_nviews():
    X, us, Ps, _ = _views()
    cams, jcams = [], []
    for P in Ps:
        E = np.eye(4, dtype=np.float32)
        E[:3] = np.linalg.inv(K) @ P
        cams.append(Camera.create(width=660, height=470, K=K, extrinsics=E))
        jcams.append(JCamera.create(width=660, height=470, K=K,
                                    extrinsics=E))
    got = Triangulate(cams, list(us), device="cpu").triangulate_nviews()
    ref = JTriangulate(jcams, list(us)).triangulate_nviews()
    depth = np.maximum(np.abs(X[:, 2:3]), 1.0)
    assert got.shape == ref.shape == X.shape
    assert np.all(np.abs(got - ref) <= TOL * depth)


# -- pipelines --------------------------------------------------------------

class StubMatcher(GroundTruthMatcher):
    """tests/test_multicam.py's ground-truth matcher with the result
    attributes the port's pipeline reads; `sparse` keeps every fifth
    match of the second slave only, so that its grid column is mostly
    NaN."""

    inlier_mask = None

    def __init__(self, extr, sparse: bool = False):
        super().__init__(extr)
        self._sparse = sparse

    def match(self, im0, im1, **kw):
        out = super().match(im0, im1, **kw)
        if self._sparse and self._call % 2 == 0:
            for name in ("mkpts0", "mkpts1", "scores0", "scores1"):
                setattr(self, name, getattr(self, name)[::5])
            for name in ("descriptors0", "descriptors1"):
                setattr(self, name, getattr(self, name)[:, ::5])
        self.inlier_mask = np.ones(len(self.mkpts0), bool)
        return out


@pytest.fixture
def jax_path(monkeypatch):
    """Run the JAX package's n-camera path: without the port's
    reprojection filter, which the JAX package lacks."""
    monkeypatch.setattr(Pipeline, "_multicam_reprojection_filter",
                        lambda self, epoch, pts3d, xy: None)


def _rig_cfg(root, results, **proc):
    return {
        "paths": {"image_dir": str(root / "img"),
                  "calibration_dir": str(root / "calib"),
                  "results_dir": str(results)},
        "proc": dict({"epoch_to_process": [0], "do_tracking": False,
                      "do_ba": True, "save_checkpoints": False,
                      "use_mtime_fallback": True}, **proc),
        "georef": {"camera_centers_world": CENTERS,
                   "target_dir": str(root / "targets"),
                   "target_world_file": "target_world.csv",
                   "targets_to_use": ["T0", "T1", "T2", "T3"]},
        "other": {"pydegensac_threshold": 2.0},
        "matching": {"matcher": "nn", "quality": "high",
                     "tile_selection": "none", "max_keypoints": 1024,
                     "options": {"distance_threshold": 0.85}},
        "ba": {"camera_location_accuracy": 0.05, "fit_f": False,
               "max_iters": 60},
    }


def _angle_deg(Ra, Rb) -> float:
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    s = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                        M[1, 0] - M[0, 1]]) / 2
    return float(np.degrees(np.arctan2(s, (np.trace(M) - 1) / 2)))


def _within(a, b, rel=0.03):
    assert abs(a - b) <= rel * b, (a, b)


def _agree(eps, jeps, cams, rot_deg=0.01):
    assert len(eps) == len(jeps)
    for e, j in zip(eps, jeps):
        q, jq = e.quality, j.quality
        assert (q["status"], q["flags"]) == (jq["status"], jq["flags"])
        _within(len(e.points), len(j.points))
        for c in cams:
            _within(len(e.features[c]), len(j.features[c]))
        s, js = q["stats"], jq["stats"]
        if "ba_rmse_px" in js:
            assert abs(s["ba_rmse_px"] - js["ba_rmse_px"]) <= 0.05
        R0, jR0 = (np.asarray(x.cameras[cams[0]].R, np.float64)
                   for x in (e, j))
        for c in cams:
            np.testing.assert_allclose(e.cameras[c].C,
                                       np.asarray(j.cameras[c].C), atol=0.01)
            rel = np.asarray(e.cameras[c].R, np.float64) @ R0.T
            jrel = np.asarray(j.cameras[c].R, np.float64) @ jR0.T
            assert _angle_deg(rel, jrel) <= rot_deg


def _residual_rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _same_residual_rows(path, jpath):
    rows, jrows = _residual_rows(path), _residual_rows(jpath)
    assert rows[0] == jrows[0] and len(rows) == len(jrows)
    for r, jr in zip(rows[1:], jrows[1:]):
        assert r[0] == jr[0]
        assert [v == "nan" for v in r] == [v == "nan" for v in jr]
        got = np.array([float(v) for v in r[1:]])
        ref = np.array([float(v) for v in jr[1:]])
        count = [i for i, h in enumerate(rows[0][1:]) if h.endswith("count")]
        # counts of residuals within 3%, the statistics within 0.05 px
        for i in range(len(got)):
            if i in count:
                _within(got[i], ref[i])
            elif np.isfinite(ref[i]):
                assert abs(got[i] - ref[i]) <= 0.05, (rows[0][i + 1], r, jr)


@pytest.mark.usefixtures("jax_path")
@pytest.mark.parametrize("sparse", [False, True])
def test_multicam_rig_agrees(rig, tmp_path, sparse):  # noqa: F811
    root, extr = rig
    pipe = Pipeline(_rig_cfg(root, tmp_path / "port"), device="cpu")
    jpipe = JPipeline(JDotDict.wrap(_rig_cfg(root, tmp_path / "jax")))
    assert pipe.cams == jpipe.cams == ["cam1", "cam2", "cam3"]
    pipe.matcher = StubMatcher(extr, sparse)
    jpipe.matcher = StubMatcher(extr, sparse)
    eps, jeps = list(pipe.run()), list(jpipe.run())
    _agree(eps, jeps, pipe.cams)
    assert eps[0].quality["stats"]["n_putative_cam2"] > 30
    for c, ctr in zip(pipe.cams, CENTERS):
        np.testing.assert_allclose(np.asarray(eps[0].cameras[c].C).ravel(),
                                   ctr, atol=0.15)
    _same_residual_rows(tmp_path / "port" / "residuals_image.csv",
                        tmp_path / "jax" / "residuals_image.csv")
    n3 = [len(e.features["cam3"]) for e in (eps[0], jeps[0])]
    assert n3[0] == n3[1]
    if sparse:       # the second slave's column: four NaN rows in five
        assert n3[0] < 0.25 * len(eps[0].features["cam1"])


@pytest.mark.usefixtures("jax_path")
def test_multicam_temporal_tracking_wiring(rig, tmp_path,  # noqa: F811
                                           monkeypatch):
    """As tests/test_multicam.py:209 holds the JAX package: epoch 1
    seeds the tracking with every camera's previous features and frames,
    and each camera keeps the survivors with their old track ids."""
    root, extr = rig
    for cam in ("cam1", "cam2", "cam3"):
        d = root / "img" / cam
        src = sorted(d.glob("IMG_*00.png"))[0]
        dst = d / src.name.replace("00", "01")
        if not dst.exists():
            shutil.copy(src, dst)
        os.utime(dst, (os.path.getmtime(src) + 3600,
                       os.path.getmtime(src) + 3600))
    calls = {}

    def fake_track_matches(matcher, prev_features, new_images, **kw):
        calls["cams"] = sorted(prev_features)
        calls["imgs"] = sorted(new_images)
        out = {}
        for c, f in prev_features.items():
            ids = f.track_ids_to_numpy()[:7]
            feats = Features(descr_dim=f.descr_dim)
            feats.append_features_from_numpy(
                np.full((7, 2), 3.0, np.float32),
                descr=np.zeros((7, f.descr_dim), np.float32),
                scores=np.ones(7, np.float32), track_ids=ids)
            out[c] = feats
        return out

    monkeypatch.setattr(pipeline_mod, "track_matches", fake_track_matches)
    pipe = Pipeline(_rig_cfg(root, tmp_path, epoch_to_process=[0, 1],
                             do_tracking=True, do_ba=False), device="cpu")
    pipe.matcher = StubMatcher(extr + extr)
    ep0, ep1 = list(pipe.run())
    assert calls["cams"] == calls["imgs"] == ["cam1", "cam2", "cam3"]
    for c in ("cam1", "cam2", "cam3"):
        ids0 = set(ep0.features[c].track_ids_to_numpy().tolist())
        ids1 = set(ep1.features[c].track_ids_to_numpy().tolist())
        assert len(ids0 & ids1) == 7


OPTIONS = {"superpoint_weights": str(REPO_WEIGHTS / "superpoint_synthetic.npz"),
           "lightglue_weights": str(REPO_WEIGHTS / "lightglue_synthetic.npz"),
           "activation_dtype": "float32"}


@pytest.fixture(scope="module")
def season3(tmp_path_factory):
    root = tmp_path_factory.mktemp("season3")
    scene = StereoSeason(480, 640, 640.0, n_cameras=3)
    cfg = scene.write(root, n_epochs=2, max_keypoints=512, options=OPTIONS)
    cfg["proc"].update(save_checkpoints=False)
    return root, cfg


def _season_cfg(season3, name, **proc):
    root, cfg = season3
    cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in cfg.items()}
    cfg["paths"]["results_dir"] = str(root / name)
    cfg["proc"] = dict(cfg["proc"], **proc)
    return cfg


def _putatives(pipe) -> list:
    """Wrap the pipeline's matcher to record each match's putative
    count."""
    counts = []
    orig = pipe.matcher.match

    def match(*a, **kw):
        out = orig(*a, **kw)
        counts.append(len(pipe.matcher.inlier_mask))
        return out

    pipe.matcher.match = match
    return counts


@pytest.mark.usefixtures("jax_path")
@pytest.mark.parametrize("tracking", [False, True])
def test_three_camera_season_agrees(season3, tracking):
    proc = {"do_tracking": tracking,
            "epoch_to_process": [0, 1] if tracking else [0]}
    pipe = Pipeline(_season_cfg(season3, f"p{tracking}", **proc),
                    device="cpu")
    jpipe = JPipeline(JDotDict.wrap(_season_cfg(season3, f"j{tracking}",
                                                **proc)))
    got, ref = _putatives(pipe), _putatives(jpipe)
    eps, jeps = list(pipe.run()), list(jpipe.run())
    assert got == ref and min(ref) > 100
    _agree(eps, jeps, pipe.cams, rot_deg=0.025)
    assert all(e.quality["status"] == "ok" for e in eps)
    root = season3[0]
    _same_residual_rows(root / f"p{tracking}" / "residuals_image.csv",
                        root / f"j{tracking}" / "residuals_image.csv")
    if tracking:
        ids = [set(e.features["cam1"].track_ids_to_numpy().tolist())
               for e in eps]
        jids = [set(e.features["cam1"].track_ids_to_numpy().tolist())
                for e in jeps]
        _within(len(ids[0] & ids[1]), len(jids[0] & jids[1]))


def test_reprojection_filter(season3):
    """The port's reprojection filter: the observations it drops are
    the ones that held the JAX package's BA RMSE up; the cameras stay
    within 1 cm of the unfiltered run's."""
    ep, = Pipeline(_season_cfg(season3, "filter", epoch_to_process=[0]),
                   device="cpu").run()
    jep, = JPipeline(JDotDict.wrap(_season_cfg(season3, "jfilter",
                                               epoch_to_process=[0]))).run()
    dropped = ep.quality["stats"]["n_reprojection_dropped"]
    assert sum(dropped.values()) > 0
    assert ep.quality["stats"]["ba_rmse_px"] < jep.quality["stats"][
        "ba_rmse_px"]
    assert len(ep.points) >= 0.95 * len(jep.points)
    for c in ("cam1", "cam2", "cam3"):
        np.testing.assert_allclose(ep.cameras[c].C,
                                   np.asarray(jep.cameras[c].C), atol=0.01)
