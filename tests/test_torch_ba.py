"""The port's Schur LM bundle adjustment against icepy4d_tpu's on the
identical problem (the JAX `BAProblem`'s leaves carried across as
numpy): final cost within 1e-4 relative, camera parameters within 1e-4
(rotation vectors in rad, translations and points relative to the
scene's extent, intrinsics relative to the focal), whatever the number
of iterations each took (f32 LM stops where the cost stops falling, and
that depends on the order of the sums). `BundleAdjustment.run` gives
the same RMSE within 1e-3 px and the same refusal below min_points."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.core.camera import Camera as JCamera
from icepy4d_tpu.ops.ba import BAProblem as JBAProblem
from icepy4d_tpu.ops.ba import lm_solve as j_lm_solve
from icepy4d_tpu.ops.geometry_np import matrix_to_rodrigues, project_points
from icepy4d_tpu.sfm import BAConfig as JBAConfig
from icepy4d_tpu.sfm import BundleAdjustment as JBundleAdjustment
from icepy4d_tpu_torch.core import Camera
from icepy4d_tpu_torch.ops.ba import BAProblem, lm_solve
from icepy4d_tpu_torch.sfm import BAConfig, BundleAdjustment
from torch_port_inputs import rotation_zyx

METASHAPE = (0, 1, 2, 3, 4, 5, 6, 7, 8)
K = np.array([[1000.0, 0, 500], [0, 1000.0, 380], [0, 0, 1]], np.float32)
DIST = np.array([-0.05, 0.02, 0.0, 0.0, 0.0], np.float32)

@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for the port: the suite runs several test
    files at once on a few cores, and this file's small ops gain little
    from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)



def _scene(n=400, n_cams=4, seed=0, outliers=0):
    """Cameras on an arc around a deep block of points at ~20 m, noisy
    observations and a perturbed start."""
    rng = np.random.default_rng(seed)
    X = np.c_[rng.uniform(-9, 9, (n, 2)), rng.uniform(-8, 8, n)] \
        + [0, 0, 20.0]
    exts, centers = [], []
    for i in range(n_cams):
        yaw = 0.3 * (i - (n_cams - 1) / 2)
        pitch = 0.15 * (-1) ** i
        R = rotation_zyx(yaw, pitch, 0.1 * i).astype(np.float64)
        C = np.array([20.0 * np.sin(yaw), -20.0 * np.sin(pitch),
                      20.0 - 20.0 * np.cos(yaw)])
        E = np.eye(4)
        E[:3, :3] = R
        E[:3, 3] = -R @ C
        exts.append(E.astype(np.float32))
        centers.append(C)
    obs = np.stack([project_points(X.astype(np.float32), K, E, DIST)
                    for E in exts], 1)
    obs = obs + rng.normal(0, 0.5, obs.shape)
    if outliers:
        obs[:outliers, 1] += rng.uniform(20, 60, (outliers, 2))
    return X, exts, np.array(centers), obs.astype(np.float32), rng


def _problem(case: str, seed=0):
    X, exts, centers, obs, rng = _scene(seed=seed,
                                        outliers=8 if case == "huber" else 0)
    c = len(exts)
    theta = np.stack([np.r_[matrix_to_rodrigues(E[:3, :3]), E[:3, 3]]
                      for E in exts]).astype(np.float32)
    theta[1:, :3] += rng.normal(0, 2e-3, (c - 1, 3))
    theta[1:, 3:] += rng.normal(0, 0.05, (c - 1, 3))
    intr = np.tile(np.r_[K[0, 0], K[1, 1], K[0, 2], K[1, 2], DIST,
                         np.zeros(3)], (c, 1)).astype(np.float32)
    if case == "metashape":
        intr[:, :4] += [8.0, -6.0, 3.0, -2.0]
    p = len(X)
    n_mark = 5                        # surveyed markers fix the datum
    pt_prior = np.zeros((p, 3), np.float32)
    pt_prior_w = np.zeros(p, np.float32)
    pt_prior[:n_mark] = X[:n_mark]
    pt_prior_w[:n_mark] = 100.0
    cam_prior = centers.astype(np.float32)
    cam_prior_w = np.full(c, 2.0 if case != "point_priors" else 0.0,
                          np.float32)
    cam_fixed = np.zeros(c, bool)
    cam_fixed[0] = case in ("ls", "huber", "fixed")
    shift = X.mean(0)
    # re-centred as the bundle layer does: t' = t + R @ shift
    from icepy4d_tpu.ops.geometry_np import rodrigues_to_matrix
    for i in range(c):
        theta[i, 3:] += rodrigues_to_matrix(theta[i, :3]) @ shift
    pts = (X - shift + rng.normal(0, 0.05, X.shape)).astype(np.float32)
    w = np.full((p, c), 1.0, np.float32)
    # some points miss one view (each keeps at least three)
    miss = rng.uniform(size=p) < 0.3
    w[np.nonzero(miss)[0], rng.integers(0, c, int(miss.sum()))] = 0.0
    leaves = dict(cam_theta=theta, intrinsics=intr, points=pts, obs_xy=obs,
                  obs_w=w, pt_prior=(pt_prior - shift).astype(np.float32),
                  pt_prior_w=pt_prior_w,
                  cam_prior=(cam_prior - shift).astype(np.float32),
                  cam_prior_w=cam_prior_w, cam_fixed=cam_fixed)
    free = {"metashape": METASHAPE, "fixed": (0, 1)}.get(case, ())
    robust = 2.0 if case == "huber" else None
    return leaves, free, robust, float(np.ptp(X, axis=0).max())


@pytest.mark.parametrize("case", ["ls", "huber", "metashape",
                                  "point_priors", "fixed"])
def test_lm_solve_identical_problem(case):
    leaves, free, robust, extent = _problem(case)
    ref = j_lm_solve(JBAProblem(**{k: jnp.asarray(v)
                                   for k, v in leaves.items()}),
                     free_intr=free, max_iters=400, robust_delta=robust)
    got = lm_solve(BAProblem.from_numpy("cpu", **leaves), free_intr=free,
                   max_iters=400, robust_delta=robust)
    assert float(got.initial_cost) == pytest.approx(
        float(ref.initial_cost), rel=1e-5)
    assert float(got.cost) < 0.5 * float(got.initial_cost)
    assert float(got.cost) == pytest.approx(float(ref.cost), rel=1e-4)
    th, jth = got.cam_theta.numpy(), np.asarray(ref.cam_theta)
    np.testing.assert_allclose(th[:, :3], jth[:, :3], atol=1e-4)
    np.testing.assert_allclose(th[:, 3:], jth[:, 3:], atol=1e-4 * extent)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points),
                               atol=1e-4 * extent)
    np.testing.assert_allclose(got.intrinsics.numpy(),
                               np.asarray(ref.intrinsics),
                               atol=1e-4 * K[0, 0])
    if case in ("ls", "huber", "fixed"):       # camera 0's pose is frozen
        np.testing.assert_array_equal(th[0], leaves["cam_theta"][0])


def _bundle_inputs(n=120, seed=4):
    X, exts, centers, obs, _ = _scene(n=n, n_cams=2, seed=seed)
    names = ("cam1", "cam2")
    cams = {nm: (K, DIST, E) for nm, E in zip(names, exts)}
    image_points = {nm: obs[:, i] for i, nm in enumerate(names)}
    image_points["cam2"][:5] = np.nan              # unseen in one view
    marker_world = X[:4].astype(np.float32)
    marker_obs = {nm: obs[:4, i] for i, nm in enumerate(names)}
    cam_centers = {nm: centers[i] for i, nm in enumerate(names)}
    pts = X + np.random.default_rng(seed).normal(0, 0.05, X.shape)
    return cams, image_points, pts.astype(np.float32), marker_obs, \
        marker_world, cam_centers


@pytest.mark.parametrize("min_points", [10, 1000])
def test_bundle_adjustment_run(min_points):
    cams, ip, pts, mobs, mworld, centers = _bundle_inputs()
    kw = dict(camera_center_sigma_m=0.5, fit_f=True, robust_delta=2.0,
              max_iters=60, min_points=min_points)
    port = BundleAdjustment(
        {n: Camera.create(width=1000, height=760, K=k, dist=d, extrinsics=e)
         for n, (k, d, e) in cams.items()}, ip, pts,
        marker_image_points=mobs, marker_world=mworld,
        camera_centers=centers, cfg=BAConfig(**kw), device="cpu").run()
    ref = JBundleAdjustment(
        {n: JCamera.create(width=1000, height=760, K=k, dist=d, extrinsics=e)
         for n, (k, d, e) in cams.items()}, ip, pts,
        marker_image_points=mobs, marker_world=mworld,
        camera_centers=centers, cfg=JBAConfig(**kw)).run()
    assert port.ok == ref.ok
    assert port.failure == ref.failure
    if not ref.ok:
        assert port.points is pts or np.array_equal(port.points, pts)
        return
    assert port.reprojection_rmse_px == pytest.approx(
        ref.reprojection_rmse_px, abs=1e-3)
    assert ref.reprojection_rmse_px < 1.0
    # the pipeline's default, free focal lengths: a two-camera network is
    # flat along focal against depth, and where each f32 solver stops on
    # it follows the order of its sums (the test above holds the
    # well-posed problems at 1e-4); here 2e-3 of the scene's extent
    extent = float(np.ptp(pts, axis=0).max())
    assert port.points.shape == ref.points.shape == pts.shape
    np.testing.assert_allclose(port.points, ref.points, atol=2e-3 * extent)
    for n in cams:
        np.testing.assert_allclose(port.cameras[n].C, ref.cameras[n].C,
                                   atol=2e-3 * extent)
        np.testing.assert_allclose(port.cameras[n].K, ref.cameras[n].K,
                                   rtol=2e-3)
