"""The port's Schur LM bundle adjustment against icepy4d_tpu's on the
identical problem (the JAX `BAProblem`'s leaves carried across as
numpy): final cost within 1e-4 relative, camera parameters within 1e-4
(rotation vectors in rad, translations and points relative to the
scene's extent, intrinsics relative to the focal), whatever the number
of iterations each took (f32 LM stops where the cost stops falling, and
that depends on the order of the sums). `BundleAdjustment.run` gives
the same RMSE within 1e-3 px and the same refusal below min_points.
Point covariances at one solution agree within 1e-2 relative Frobenius
error a point and track the empirical error; the batched LM gives each
problem what `lm_solve` gives it alone, and the JAX package's batched
LM's poses, points and cost."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.core.camera import Camera as JCamera
from icepy4d_tpu.ops.ba import BAProblem as JBAProblem
from icepy4d_tpu.ops.ba import lm_solve as j_lm_solve
from icepy4d_tpu.ops.ba import point_covariances as j_point_covariances
from icepy4d_tpu.ops.geometry_np import matrix_to_rodrigues, project_points
from icepy4d_tpu.sfm import BAConfig as JBAConfig
from icepy4d_tpu.sfm import BundleAdjustment as JBundleAdjustment
from icepy4d_tpu_torch.core import Camera
from icepy4d_tpu_torch.ops.ba import (BAProblem, lm_solve, lm_solve_batched,
                                      point_covariances)
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


# -- point covariances and the batched LM ------------------------------------

def _covariance_case(case: str):
    """A solved problem of `_problem` (the JAX package's solution) and
    its covariance settings."""
    leaves, free, robust, _ = _problem(case)
    jprob = JBAProblem(**{k: jnp.asarray(v) for k, v in leaves.items()})
    ref = j_lm_solve(jprob, free_intr=free, max_iters=400,
                     robust_delta=robust)
    return leaves, jprob, ref, free, robust


def _rel_frobenius(a, b):
    return np.linalg.norm(a - b, axis=(1, 2)) / np.linalg.norm(b, axis=(1, 2))


def _float64(prob):
    return BAProblem(*(t.double() if t.is_floating_point() else t
                       for t in prob))


@pytest.mark.parametrize("case", ["ls", "huber", "fixed", "point_priors"])
def test_point_covariances_identical_solution(case):
    """Both packages' covariances at the same (JAX) solution: within
    1e-2 relative Frobenius error on every point (both are within 6e-5
    of a float64 run), symmetric and positive definite."""
    leaves, jprob, ref, free, robust = _covariance_case(case)
    jcov = np.asarray(j_point_covariances(
        jprob, ref.cam_theta, ref.intrinsics, ref.points, free_intr=free,
        robust_delta=robust))
    prob = BAProblem.from_numpy("cpu", **leaves)
    cov = point_covariances(
        prob, *(torch.from_numpy(np.asarray(a)) for a in
                (ref.cam_theta, ref.intrinsics, ref.points)),
        free_intr=free, robust_delta=robust).numpy()
    assert cov.shape == jcov.shape == (len(leaves["points"]), 3, 3)
    assert _rel_frobenius(cov, jcov).max() <= 1e-2
    assert _rel_frobenius(cov, cov.transpose(0, 2, 1)).max() <= 1e-3
    assert (np.linalg.eigvalsh(cov.astype(np.float64)) > 0).all()


def test_point_covariances_free_intrinsics_float32():
    """With nine free intrinsics a camera ("metashape") the reduced
    camera system is near singular: the JAX package's float32 Schur
    complement cancels and its covariances are up to 7% off a float64
    run; the port forms the complement in float64 and stays within 1e-4
    of it."""
    leaves, jprob, ref, free, robust = _covariance_case("metashape")
    args = [torch.from_numpy(np.asarray(a)) for a in
            (ref.cam_theta, ref.intrinsics, ref.points)]
    prob = BAProblem.from_numpy("cpu", **leaves)
    cov = point_covariances(prob, *args, free_intr=free).numpy()
    cov64 = point_covariances(_float64(prob), *(a.double() for a in args),
                              free_intr=free).numpy()
    jcov = np.asarray(j_point_covariances(
        jprob, ref.cam_theta, ref.intrinsics, ref.points, free_intr=free))
    assert cov.dtype == np.float32
    assert _rel_frobenius(cov, cov64).max() <= 1e-4
    assert _rel_frobenius(jcov, cov64).max() <= 0.1


def test_point_covariances_match_empirical_error():
    """As tests/test_ba.py:297 holds the JAX package: with fixed cameras
    and 1 px noise the Mahalanobis distance of the estimation error
    averages chi2(3)'s 3, and doubling sigma quadruples the covariance."""
    from test_ba import _make_scene

    cam_theta, intr, pts, obs = _make_scene(n_pts=200, noise_px=1.0)
    rng = np.random.default_rng(11)
    pts_noisy = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
    p, c = obs.shape[:2]

    def problem(w):
        return BAProblem.from_numpy(
            "cpu", cam_theta=cam_theta, intrinsics=intr, points=pts_noisy,
            obs_xy=obs, obs_w=np.full((p, c), w, np.float32),
            pt_prior=np.zeros((p, 3)), pt_prior_w=np.zeros(p),
            cam_prior=np.zeros((c, 3)), cam_prior_w=np.zeros(c),
            cam_fixed=np.ones(c, bool))

    prob = problem(1.0)
    res = lm_solve(prob, max_iters=60)
    cov = point_covariances(prob, res.cam_theta, res.intrinsics,
                            res.points).numpy().astype(np.float64)
    err = res.points.numpy() - pts
    m2 = np.einsum("pi,pij,pj->p", err, np.linalg.inv(cov), err)
    assert 1.0 < m2.mean() < 9.0
    cov2 = point_covariances(problem(0.5), res.cam_theta, res.intrinsics,
                             res.points).numpy()
    ratio = np.trace(cov2, axis1=1, axis2=2) / np.trace(cov, axis1=1,
                                                        axis2=2)
    np.testing.assert_allclose(ratio, 4.0, rtol=0.05)


def test_bundle_adjustment_covariances():
    """`compute_covariance` fills BAOutput.point_covariances with one
    3x3 a tie point, agreeing with the JAX package's (every point seen
    by both cameras: a point of one view has a singular block, and both
    packages' covariances are then meaningless)."""
    X, exts, cc, obs, _ = _scene(n=120, n_cams=2, seed=4)
    cams, ip, pts, mobs, mworld, centers = _bundle_inputs()
    ip = {n: obs[:, i] for i, n in enumerate(cams)}
    kw = dict(camera_center_sigma_m=0.5, max_iters=60,
              compute_covariance=True)
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
    assert port.point_covariances.shape == ref.point_covariances.shape \
        == (len(pts), 3, 3)
    assert _rel_frobenius(port.point_covariances,
                          ref.point_covariances).max() <= 2e-2
    off = BundleAdjustment(
        {n: Camera.create(width=1000, height=760, K=k, dist=d, extrinsics=e)
         for n, (k, d, e) in cams.items()}, ip, pts,
        cfg=BAConfig(max_iters=5), device="cpu").run()
    assert off.point_covariances is None


def _season_problems():
    """tests/test_ba.py:251's season: four 0.2-px scenes, two cameras
    fixed."""
    from test_ba import _make_scene

    leaves = []
    for seed in range(4):
        cam_theta, intr, pts, obs = _make_scene(seed=seed, noise_px=0.2)
        rng = np.random.default_rng(seed + 10)
        pts_noisy = pts + rng.normal(0, 0.04, pts.shape).astype(np.float32)
        p, c = obs.shape[:2]
        leaves.append(dict(
            cam_theta=cam_theta, intrinsics=intr, points=pts_noisy,
            obs_xy=obs, obs_w=np.ones((p, c), np.float32),
            pt_prior=np.zeros((p, 3), np.float32),
            pt_prior_w=np.zeros(p, np.float32),
            cam_prior=np.zeros((c, 3), np.float32),
            cam_prior_w=np.zeros(c, np.float32),
            cam_fixed=np.array([True, True, False])))
    return leaves


def _rmse(res_points, cam_theta, intr, prob) -> float:
    from icepy4d_tpu_torch.ops.ba import _grid, _project_resid
    from torch.func import vmap

    r = vmap(lambda *a: _project_resid(*a, ()))(
        *_grid(prob, cam_theta[None], intr[None], res_points))
    return float((r ** 2).sum(-1).mean().sqrt())


def test_lm_solve_batched_season():
    """Each problem's result is the port's own lm_solve on it alone, and
    agrees with the JAX package's batched LM: poses, points and cost,
    and every problem at its ~0.2 px noise floor (iteration counts are
    not held)."""
    import jax

    from icepy4d_tpu.ops.ba import lm_solve_batched as j_lm_solve_batched

    leaves = _season_problems()
    probs = [BAProblem.from_numpy("cpu", **lv) for lv in leaves]
    res = lm_solve_batched(probs, max_iters=40)
    jres = j_lm_solve_batched(jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[JBAProblem(**{k: jnp.asarray(v) for k, v in lv.items()})
          for lv in leaves]), max_iters=40)
    assert res.cost.shape == (4,) and len(res.iterations) == 4
    for i, prob in enumerate(probs):
        one = lm_solve(prob, max_iters=40)
        torch.testing.assert_close(res.points[i], one.points, rtol=0, atol=0)
        torch.testing.assert_close(res.cam_theta[i], one.cam_theta, rtol=0,
                                   atol=0)
        assert res.iterations[i] == one.iterations
        assert float(res.cost[i]) < float(res.initial_cost[i])
        assert float(res.cost[i]) == pytest.approx(float(jres.cost[i]),
                                                   rel=1e-3)
        np.testing.assert_allclose(res.cam_theta[i].numpy(),
                                   np.asarray(jres.cam_theta[i]), atol=1e-4)
        np.testing.assert_allclose(res.points[i].numpy(),
                                   np.asarray(jres.points[i]), atol=1e-3)
        assert _rmse(res.points[i], res.cam_theta[i], res.intrinsics[i],
                     prob) < 0.4
