"""The port's projective geometry, transforms, essential-matrix pose and
the host float64 solves against icepy4d_tpu's on the same seeded inputs.

Tolerances: float32 functions within 1e-5 relative (to the largest
magnitude of the reference), float64 host functions within 1e-9, the
undistortion round trip within 1e-4 px; the 8-point essential matrix,
an eigenvector of an f32 normal matrix, within 1e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.core.camera import Camera as JCamera
from icepy4d_tpu.ops import epipolar as jep
from icepy4d_tpu.ops import geometry as jgeom
from icepy4d_tpu.ops import geometry_np as jgeom_np
from icepy4d_tpu.ops import transforms as jtf
from icepy4d_tpu.sfm import fundamental_from_cameras as j_fundamental
from icepy4d_tpu.sfm import pose_from_known_center as j_pose_known
from icepy4d_tpu_torch.core import Camera
from icepy4d_tpu_torch.ops import epipolar as ep
from icepy4d_tpu_torch.ops import geometry as geom
from icepy4d_tpu_torch.ops import geometry_np
from icepy4d_tpu_torch.ops import transforms as tf
from icepy4d_tpu_torch.sfm import fundamental_from_cameras, pose_from_known_center
from torch_port_inputs import rotation_zyx

F32 = 1e-5
F64 = 1e-9
EIG_TOL = 1e-3
K = np.array([[810.0, 1.5, 322.0], [0, 805.0, 241.0], [0, 0, 1]], np.float32)
DIST = np.array([-0.12, 0.08, 0.001, -0.0008, -0.02, 0.01, -0.005, 0.002],
                np.float32)


def _close(got, ref, tol=F32):
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got)
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def _t(a):
    return torch.tensor(np.asarray(a))


def _extrinsics(seed=0):
    rng = np.random.default_rng(seed)
    E = np.eye(4, dtype=np.float32)
    E[:3, :3] = rotation_zyx(*rng.uniform(-0.3, 0.3, 3))
    E[:3, 3] = rng.uniform(-2, 2, 3)
    return E


def _points(n=200, seed=1):
    rng = np.random.default_rng(seed)
    return np.c_[rng.uniform(-3, 3, (n, 2)),
                 rng.uniform(8, 15, n)].astype(np.float32)


def test_homogeneous_and_skew():
    x = np.random.default_rng(0).normal(size=(30, 3)).astype(np.float32)
    _close(geom.to_homogeneous(_t(x)), jgeom.to_homogeneous(jnp.asarray(x)))
    _close(geom.from_homogeneous(_t(x)),
           jgeom.from_homogeneous(jnp.asarray(x)))
    v = np.random.default_rng(1).normal(size=(5, 3)).astype(np.float32)
    _close(geom.skew_symmetric(_t(v)), jgeom.skew_symmetric(jnp.asarray(v)))


@pytest.mark.parametrize("n_dist", [0, 4, 5, 8])
def test_projection_and_undistortion(n_dist):
    dist = DIST[:n_dist]
    E = _extrinsics()
    X = _points()
    _close(geom.world_to_camera(_t(X), _t(E)),
           jgeom.world_to_camera(jnp.asarray(X), jnp.asarray(E)))
    uv = np.asarray(jgeom.project_points(jnp.asarray(X), jnp.asarray(K),
                                         jnp.asarray(E), jnp.asarray(dist)))
    _close(geom.project_points(_t(X), _t(K), _t(E), dist), uv)
    _close(geom.normalize_points(_t(uv), _t(K)),
           jgeom.normalize_points(jnp.asarray(uv), jnp.asarray(K)))
    ref = np.asarray(jgeom.undistort_points(jnp.asarray(uv), jnp.asarray(K),
                                            jnp.asarray(dist)))
    _close(geom.undistort_points(_t(uv), K, dist), ref)
    _close(geom.undistort_points(_t(uv), _t(K), _t(jgeom.pad_distortion(
        jnp.asarray(dist)))), ref)
    xn = np.asarray(jgeom.normalize_points(jnp.asarray(uv), jnp.asarray(K)))
    _close(geom.undistort_normalized(_t(xn), dist),
           jgeom.undistort_normalized(jnp.asarray(xn),
                                      jgeom.pad_distortion(jnp.asarray(dist))))
    # round trip: undistorting the distorted normalised coordinates gives
    # them back, within 1e-4 px at the focal length (measured in the
    # normalised frame, below the float32 spacing of 500-px coordinates)
    xp = geom.world_to_camera(_t(X), _t(E))
    xp = xp[:, :2] / xp[:, 2:]
    back = geom.undistort_normalized(geom.distort_normalized(xp, dist), dist)
    assert float((back - xp).abs().max()) * K[0, 0] <= 1e-4


def test_reprojection_error():
    rng = np.random.default_rng(2)
    obs = rng.uniform(0, 600, (50, 2)).astype(np.float32)
    prj = obs + rng.normal(0, 0.7, obs.shape).astype(np.float32)
    mask = rng.uniform(size=50) > 0.3
    for m in (None, mask):
        got = geom.compute_reprojection_error(
            _t(obs), _t(prj), None if m is None else _t(m))
        ref = jgeom.compute_reprojection_error(
            jnp.asarray(obs), jnp.asarray(prj),
            None if m is None else jnp.asarray(m))
        for g, r in zip(got, ref):
            _close(g, r)


def test_fundamental_from_cameras():
    E0, E1 = _extrinsics(3), _extrinsics(4)
    K1 = K * np.float32(1.1)
    K1[2, 2] = 1.0
    _close(geom.fundamental_from_cameras(_t(K), _t(E0), _t(K1), _t(E1)),
           jgeom.fundamental_from_cameras(*map(jnp.asarray, (K, E0, K1, E1))))
    cams = [Camera.create(width=640, height=480, K=k, extrinsics=e)
            for k, e in ((K, E0), (K1, E1))]
    jcams = [JCamera.create(width=640, height=480, K=k, extrinsics=e)
             for k, e in ((K, E0), (K1, E1))]
    _close(fundamental_from_cameras(*cams), j_fundamental(*jcams), F64)


def test_similarity_host_float64():
    rng = np.random.default_rng(6)
    v0 = rng.normal(size=(7, 3)) * 40
    T = np.eye(4)
    T[:3, :3] = 1.7 * rotation_zyx(0.4, -0.2, 1.1)
    T[:3, 3] = [12.0, -3.0, 5.0]
    v1 = v0 @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.01, v0.shape)
    w = rng.uniform(0.5, 2.0, 7)
    for kw in ({}, {"with_scale": False}, {"weights": w}):
        _close(geometry_np.similarity_from_points(v0, v1, **kw),
               jgeom_np.similarity_from_points(v0, v1, **kw), F64)


def test_euler_quaternion_rodrigues():
    rng = np.random.default_rng(7)
    angles = rng.uniform(-1.2, 1.2, (3, 16)).astype(np.float32)
    R = np.asarray(jtf.euler_matrix(*map(jnp.asarray, angles)))
    _close(tf.euler_matrix(*map(_t, angles)), R)
    for g, r in zip(tf.euler_from_matrix(_t(R)),
                    jtf.euler_from_matrix(jnp.asarray(R))):
        _close(g, r)
    q = np.asarray(jtf.quaternion_from_matrix(jnp.asarray(R)))
    _close(tf.quaternion_from_matrix(_t(R)), q)
    _close(tf.matrix_from_quaternion(_t(q)),
           jtf.matrix_from_quaternion(jnp.asarray(q)))
    rv = rng.normal(size=(16, 3)).astype(np.float32)
    rv[0] = 0.0                                # the identity branch
    rv[1] *= np.pi / np.linalg.norm(rv[1])     # a half turn
    Rr = np.asarray(jtf.rodrigues_to_matrix(jnp.asarray(rv)))
    _close(tf.rodrigues_to_matrix(_t(rv)), Rr)
    _close(tf.matrix_to_rodrigues(_t(Rr[2:])),
           jtf.matrix_to_rodrigues(jnp.asarray(Rr[2:])))


def test_similarity_and_helmert():
    rng = np.random.default_rng(8)
    v0 = (rng.normal(size=(9, 3)) * 20).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = 0.8 * rotation_zyx(0.2, 0.3, -0.5)
    T[:3, 3] = [4.0, 1.0, -2.0]
    v1 = (v0 @ T[:3, :3].T + T[:3, 3]
          + rng.normal(0, 0.05, v0.shape)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 9).astype(np.float32)
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else _t(weights)
        Tj = np.asarray(jtf.similarity_from_points(
            jnp.asarray(v0), jnp.asarray(v1), weights=jw))
        _close(tf.similarity_from_points(_t(v0), _t(v1), weights=tw), Tj)
    _close(tf.apply_transform(_t(T), _t(v0)),
           jtf.apply_transform(jnp.asarray(T), jnp.asarray(v0)))
    p = np.array([0.1, -0.2, 0.3, 1.0, 2.0, -1.0, 1.2], np.float32)
    _close(tf.helmert_params_to_matrix(_t(p)),
           jtf.helmert_params_to_matrix(jnp.asarray(p)))
    unc = rng.uniform(0.01, 0.1, (9, 3)).astype(np.float32)
    _close(tf.helmert_residuals(_t(p), _t(v0), _t(v1), _t(1 / unc)),
           jtf.helmert_residuals(jnp.asarray(p), jnp.asarray(v0),
                                 jnp.asarray(v1), jnp.asarray(1 / unc)))
    T0 = np.array(jtf.similarity_from_points(jnp.asarray(v0),
                                             jnp.asarray(v1)))
    T0[:3, 3] += 0.5                          # start off the optimum
    for weights in (None, 1 / unc):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else _t(weights)
        _close(tf.refine_similarity_gauss_newton(_t(T0), _t(v0), _t(v1),
                                                 weights=tw),
               jtf.refine_similarity_gauss_newton(
                   jnp.asarray(T0), jnp.asarray(v0), jnp.asarray(v1),
                   weights=jw))


def _two_view(seed=9, n=120):
    """K-normalised correspondences of a general scene, x1 = R x0 + t."""
    X = _points(n, seed).astype(np.float64)
    R = rotation_zyx(0.05, -0.08, 0.02)
    t = np.array([1.0, 0.1, -0.2])
    x0 = X[:, :2] / X[:, 2:]
    X1 = X @ R.T + t
    x1 = X1[:, :2] / X1[:, 2:]
    return x0.astype(np.float32), x1.astype(np.float32), R, t / np.linalg.norm(t)


def test_essential_and_pose():
    x0, x1, R_true, t_true = _two_view()
    w = np.ones(len(x0), np.float32)
    E = np.asarray(jep.essential_eight_point(*map(jnp.asarray, (x0, x1, w))))
    # E is the smallest eigenvector of an f32 normal matrix, whose
    # condition is the square of the design's: two LAPACKs agree to
    # ~1e-4 of its norm here (as in test_torch_ransac.EIG_TOL); the pose
    # steps below are held at 1e-5 on the same E
    _close(ep.essential_eight_point(_t(x0), _t(x1), _t(w)), E, EIG_TOL)
    Rs, ts = ep.decompose_essential(_t(E))
    jRs, jts = map(np.asarray, jep.decompose_essential(jnp.asarray(E)))
    # the four candidates agree as a set (SVD sign conventions differ)
    for R, t in zip(Rs.numpy(), ts.numpy()):
        assert min(np.abs(R - jR).max() + np.abs(t - jt).max()
                   for jR, jt in zip(jRs, jts)) <= 1e-4
    z0, z1 = ep._cheirality_depths(Rs[0], ts[0], _t(x0), _t(x1))
    jz0, jz1 = jep._cheirality_depths(jnp.asarray(Rs[0].numpy()),
                                      jnp.asarray(ts[0].numpy()),
                                      jnp.asarray(x0), jnp.asarray(x1))
    _close(z0, jz0, 1e-4)
    _close(z1, jz1, 1e-4)
    R, t, front = ep.recover_pose(_t(E), _t(x0), _t(x1), _t(w))
    jR, jt, jfront = jep.recover_pose(*map(jnp.asarray, (E, x0, x1, w)))
    _close(R, jR)
    _close(t, jt)
    np.testing.assert_array_equal(front.numpy(), np.asarray(jfront))
    np.testing.assert_allclose(R.numpy(), R_true, atol=1e-4)
    np.testing.assert_allclose(t.numpy(), t_true, atol=1e-4)


def test_pose_from_known_center():
    E = _extrinsics(10)
    dist = DIST[:5] * np.float32(0.3)
    K0 = K.copy()
    K0[0, 1] = 0.0                  # the bearings are formed without skew
    cam = Camera.create(width=640, height=480, K=K0, dist=dist,
                        extrinsics=np.eye(4))
    jcam = JCamera.create(width=640, height=480, K=K0, dist=dist,
                          extrinsics=np.eye(4))
    X = _points(5, 11).astype(np.float64)
    C = -E[:3, :3].T @ E[:3, 3]
    uv = np.asarray(jgeom.project_points(jnp.asarray(X, jnp.float32),
                                         jnp.asarray(K0), jnp.asarray(E),
                                         jnp.asarray(dist)))
    got = pose_from_known_center(cam, C, uv, X)
    ref = j_pose_known(jcam, C, uv, X)
    _close(got.extrinsics, np.asarray(ref.extrinsics), F64)
    np.testing.assert_allclose(got.extrinsics[:3, :3], E[:3, :3], atol=1e-4)


def test_smallest_eigenvector_in_chunks():
    """Point-batched eigh runs in chunks (cuSOLVER's batched eigh refuses
    batches of tens of thousands); the chunks give what one call gives."""
    A = np.random.default_rng(5).normal(size=(2, 50, 4, 4)).astype(np.float32)
    M = _t(np.swapaxes(A, -1, -2) @ A)
    got = ep.smallest_eigenvector(M, chunk=7)
    np.testing.assert_array_equal(got.numpy(),
                                  torch.linalg.eigh(M)[1][..., :, 0].numpy())
