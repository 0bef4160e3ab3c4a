"""The port's space resection against icepy4d_tpu's.

The port normalises both point sets before the DLT, the JAX package
does not (ROADMAP section 3): in float32 its raw system loses the pose
of GCPs tens of metres away (4.5 degrees and no inlier on one of these
scenes, noise-free), where the port's stays within 1e-4 rad. Where the
JAX package is well conditioned (a scene a tenth the size) the two
agree: `pnp_dlt` with equal weights, noise-free, R within 1e-4 rad and
t within 1e-4 of the points' distance (the JAX package's own t is
1e-4 of it off the truth there); `ransac_pnp` and `SpaceResection` by
outcome (the packages draw from different generators; replaying the JAX
draws gives the same hypotheses): the same inlier set, the pose within
1e-3 rad and 1e-3 of the points' distance. `proc.do_space_resection` on the synthetic
stereo season: equal `resection_targets_*` stats, resected centres
within 1e-3 m and rotations within 0.01 degrees. Only the numerics of
a singular system are caught in the pipeline: any other error
propagates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu import Pipeline as JPipeline
from icepy4d_tpu.core.camera import Camera as JCamera
from icepy4d_tpu.ops import epipolar as jep
from icepy4d_tpu.ops import ransac as jr
from icepy4d_tpu.sfm import SpaceResection as JSpaceResection
from icepy4d_tpu.utils.config import DotDict as JDotDict
from icepy4d_tpu_torch import pipeline as pipeline_mod
from icepy4d_tpu_torch.core import Camera
from icepy4d_tpu_torch.ops import epipolar as ep
from icepy4d_tpu_torch.ops import ransac as rs
from icepy4d_tpu_torch.pipeline import Pipeline
from icepy4d_tpu_torch.sfm import SpaceResection, Space_resection
from torch_port_inputs import REPO_WEIGHTS, StereoSeason, rotation_zyx

K = np.array([[1500.0, 0, 640], [0, 1500.0, 480], [0, 0, 1]], np.float32)
DIST = np.array([-0.05, 0.01, 0.0, 0.0, 0.0], np.float32)


def _rot_err(Ra, Rb) -> float:
    """Angle (rad) between two rotations, from the skew part (exact near
    0, where the trace's arccos loses half the digits)."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    s = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                        M[1, 0] - M[0, 1]]) / 2
    return float(np.arctan2(s, (np.trace(M) - 1) / 2))


def _gcps(n=12, n_out=3, seed=0, noise=0.0, scale=0.1):
    """n surveyed points 40-60 m (times `scale`) in front of a turned
    camera, their distorted pixels with `noise` px, the first n_out
    moved by 40-90 px. Returns (X, uv, extrinsics)."""
    rng = np.random.default_rng(seed)
    R = rotation_zyx(0.2, -0.05, 0.03).astype(np.float64)
    C = np.array([3.0, -2.0, 1.0]) * scale
    X = np.c_[rng.uniform(-15, 15, (n, 2)), rng.uniform(40, 60, n)] * scale
    X = (X @ R + C).astype(np.float32)               # camera -> world
    E = np.eye(4, dtype=np.float32)
    E[:3, :3] = R
    E[:3, 3] = -R @ C
    cam = Camera.create(width=1280, height=960, K=K, dist=DIST, extrinsics=E)
    uv = cam.project_point(X) + rng.normal(0, noise, (n, 2))
    uv[:n_out] += rng.uniform(40, 90, (n_out, 2)) * rng.choice([-1, 1],
                                                              (n_out, 2))
    return X, uv.astype(np.float32), E


def _normalised(uv):
    return ((uv - K[:2, 2]) / K[[0, 1], [0, 1]]).astype(np.float32)


def _dlt_inputs(scale, n=30, seed=0):
    X, uv, E = _gcps(n=n, n_out=0, seed=seed, scale=scale)
    xn = _normalised(Camera.create(K=K, dist=DIST).undistort_points(uv))
    return X, xn, np.ones(len(X), np.float32), E


def test_pnp_dlt_equal_weights():
    X, xn, w, E = _dlt_inputs(0.1)
    R, t = ep.pnp_dlt(*(torch.from_numpy(a) for a in (X, xn, w)))
    jR, jt = jep.pnp_dlt(*(jnp.asarray(a) for a in (X, xn, w)))
    assert _rot_err(R.numpy(), np.asarray(jR)) <= 1e-4
    # the points lie 4-6 m away
    assert np.linalg.norm(t.numpy() - np.asarray(jt)) <= 1e-4 * 5.0


@pytest.mark.parametrize("scale", [0.1, 1.0])
def test_pnp_dlt_recovers_the_pose(scale):
    """Noise-free GCPs at 4-6 m and at 40-60 m: the normalised DLT in
    float32 gives the pose within 1e-4 rad and 1e-4 of the distance."""
    X, xn, w, E = _dlt_inputs(scale, n=12, seed=4)
    R, t = ep.pnp_dlt(*(torch.from_numpy(a) for a in (X, xn, w)))
    assert _rot_err(R.numpy(), E[:3, :3]) <= 1e-4
    assert np.linalg.norm(t.numpy() - E[:3, 3]) <= 1e-4 * 60 * scale


def _pnp_inputs(seed=0, scale=0.1):
    X, uv, E = _gcps(seed=seed, scale=scale)
    und = Camera.create(K=K, dist=DIST).undistort_points(uv)
    cap = 32
    p2 = np.zeros((cap, 2), np.float32)
    p3 = np.zeros((cap, 3), np.float32)
    p2[:len(X)], p3[:len(X)] = und, X
    return p3, p2, np.arange(cap) < len(X), E


@pytest.mark.parametrize("replay", [True, False])
def test_ransac_pnp_by_outcome(replay):
    p3, p2, mask, E = _pnp_inputs()
    key = jax.random.PRNGKey(0)
    jR, jt, jinl = jr.ransac_pnp(key, jnp.asarray(p3), jnp.asarray(p2),
                                 jnp.asarray(K), jnp.asarray(mask),
                                 threshold_px=3.0)
    idx = None
    if replay:
        idx = torch.from_numpy(np.asarray(jr.sample_minimal_sets(
            key, jnp.asarray(mask), 256, 6)).astype(np.int64))
    R, t, inl = rs.ransac_pnp(
        torch.Generator().manual_seed(0), torch.from_numpy(p3),
        torch.from_numpy(p2), torch.from_numpy(K), torch.from_numpy(mask),
        threshold_px=3.0, idx=idx)
    jinl = np.asarray(jinl)
    np.testing.assert_array_equal(inl.numpy(), jinl)
    assert not jinl[:3].any() and jinl[3:12].all()
    assert _rot_err(R.numpy(), np.asarray(jR)) <= 1e-3
    assert np.linalg.norm(t.numpy() - np.asarray(jt)) <= 1e-3 * 5.0
    assert _rot_err(R.numpy(), E[:3, :3]) <= 1e-4


@pytest.mark.parametrize("scale,n_out", [(0.1, 3), (1.0, 3), (0.1, 9)])
def test_space_resection(scale, n_out):
    """12 GCPs with 3 gross outliers: the pose of the other 9, the port's
    within 1e-4 rad and 1e-3 m of the truth also at 40-60 m (the JAX
    package's is compared where it is well conditioned); with 9 outliers
    fewer than 4 inliers remain and both keep the camera."""
    X, uv, E = _gcps(n_out=n_out, seed=1, scale=scale)
    start = np.eye(4, dtype=np.float32)
    start[:3, 3] = [0.0, 0.0, 5.0]
    cam = Camera.create(width=1280, height=960, K=K, dist=DIST,
                        extrinsics=start)
    jcam = JCamera.create(width=1280, height=960, K=K, dist=DIST,
                          extrinsics=start)
    sr = SpaceResection(cam, device="cpu")
    got = sr.estimate(uv, X)
    assert Space_resection is SpaceResection
    ref = JSpaceResection(jcam).estimate(uv, X)
    assert sr.inliers.shape == (12,)
    if n_out > 3:
        assert sr.inliers.sum() < 4
        np.testing.assert_array_equal(got.extrinsics, start)
        np.testing.assert_array_equal(np.asarray(ref.extrinsics), start)
        return
    assert not sr.inliers[:3].any() and sr.inliers[3:].all()
    assert _rot_err(got.R, E[:3, :3]) <= 1e-4
    true_C = -E[:3, :3].T @ E[:3, 3]
    assert np.linalg.norm(np.asarray(got.C).ravel() - true_C) <= 1e-3
    if scale < 1.0:
        assert _rot_err(got.R, ref.R) <= 1e-3
        assert np.linalg.norm(np.asarray(got.C).ravel()
                              - np.asarray(ref.C).ravel()) <= 1e-3 * 5.0


# -- the pipeline's do_space_resection ------------------------------------------

OPTIONS = {"superpoint_weights": str(REPO_WEIGHTS / "superpoint_synthetic.npz"),
           "lightglue_weights": str(REPO_WEIGHTS / "lightglue_synthetic.npz"),
           "activation_dtype": "float32"}


@pytest.fixture(scope="module")
def season(tmp_path_factory):
    root = tmp_path_factory.mktemp("season")
    cfg = StereoSeason(480, 640, 640.0).write(root, n_epochs=1,
                                              max_keypoints=512,
                                              options=OPTIONS)
    cfg["proc"].update(do_space_resection=True, save_checkpoints=False)
    return root, cfg


def _cfg(season, name):
    root, cfg = season
    cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in cfg.items()}
    cfg["paths"]["results_dir"] = str(root / name)
    return cfg


def _recording(cls):
    """The pipeline class with each camera's pose recorded right after
    the space resection."""
    class Recording(cls):
        resected: list = []

        def _space_resection(self, epoch, centers):
            super()._space_resection(epoch, centers)
            self.resected.append({c: epoch.cameras[c] for c in self.cams})

    Recording.resected = []
    return Recording


def test_do_space_resection_agrees(season):
    pipe = _recording(Pipeline)(_cfg(season, "port"), device="cpu")
    jpipe = _recording(JPipeline)(JDotDict.wrap(_cfg(season, "jax")))
    ep, = pipe.run()
    jep_, = jpipe.run()
    keys = [k for k in jep_.quality["stats"] if k.startswith("resection")]
    assert sorted(keys) == ["resection_targets_cam1",
                            "resection_targets_cam2"]
    for k in keys:
        assert ep.quality["stats"][k] == jep_.quality["stats"][k] == 5
    (got,), (ref,) = pipe.resected, jpipe.resected
    centers = season[1]["georef"]["camera_centers_world"]
    for c, ctr in zip(pipe.cams, centers):
        np.testing.assert_allclose(np.asarray(got[c].C).ravel(),
                                   np.asarray(ref[c].C).ravel(), atol=1e-3)
        np.testing.assert_allclose(np.asarray(got[c].C).ravel(), ctr,
                                   atol=1e-3)
        assert np.degrees(_rot_err(got[c].R, ref[c].R)) <= 0.01
    assert ep.quality["status"] == jep_.quality["status"] == "ok"


@pytest.mark.parametrize("error,caught", [
    (np.linalg.LinAlgError("SVD did not converge"), True),
    (torch.linalg.LinAlgError("linalg.svd: singular"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     False),
])
def test_resection_catches_only_numerics(season, monkeypatch, error, caught):
    """A singular system keeps the AO pose, as in the JAX package; a
    device error propagates."""
    def failing(*a, **kw):
        raise error

    monkeypatch.setattr(pipeline_mod, "pose_from_known_center", failing)
    cfg = _cfg(season, "fail")
    cfg["proc"] = dict(cfg["proc"], do_ba=False, use_gcp_prior=False)
    pipe = Pipeline(cfg, device="cpu")
    if caught:
        ep, = pipe.run()
        assert not any(k.startswith("resection")
                       for k in ep.quality["stats"])
    else:
        with pytest.raises(RuntimeError, match="CUDA error"):
            pipe.run()
