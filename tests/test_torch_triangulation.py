"""The port's triangulation against icepy4d_tpu's on the same seeded
scene: points within 1e-4 of their depth; the convergence status equal
except where a point's last depth change sits within 1% of the
tolerance (the two f32 solvers round differently there); colours within
1e-5 of the value range."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.core.camera import Camera as JCamera
from icepy4d_tpu.ops import geometry as jgeom
from icepy4d_tpu.ops import triangulation as jtri
from icepy4d_tpu.sfm import Triangulate as JTriangulate
from icepy4d_tpu_torch.core import Camera
from icepy4d_tpu_torch.ops import triangulation as tri
from icepy4d_tpu_torch.sfm import Triangulate
from torch_port_inputs import rotation_zyx

K = np.array([[900.0, 0, 330], [0, 905.0, 235], [0, 0, 1]], np.float32)
DIST = np.array([-0.09, 0.04, 0.0008, -0.0005, -0.01], np.float32)
TOL = 1e-4


def _rig():
    E0 = np.eye(4, dtype=np.float32)
    E1 = np.eye(4, dtype=np.float32)
    E1[:3, :3] = rotation_zyx(-0.15, 0.02, 0.01)
    E1[:3, 3] = -E1[:3, :3] @ np.array([2.0, 0.1, 0.3], np.float32)
    return E0, E1


def _scene(n=300, seed=0, noise=0.4):
    rng = np.random.default_rng(seed)
    X = np.c_[rng.uniform(-4, 4, (n, 2)), rng.uniform(8, 20, n)].astype(
        np.float32)
    E0, E1 = _rig()
    obs = []
    for E in (E0, E1):
        uv = np.asarray(jgeom.project_points(jnp.asarray(X), jnp.asarray(K),
                                             jnp.asarray(E),
                                             jnp.asarray(DIST)))
        obs.append((uv + rng.normal(0, noise, uv.shape)).astype(np.float32))
    return X, obs, E0, E1


def _P(E):
    return (K @ E[:3, :]).astype(np.float32)


def _depth_close(got, ref, X):
    depth = np.abs(X[:, 2:3])
    assert np.all(np.abs(got - ref) <= TOL * np.maximum(depth, 1.0))


def _last_change(u0, u1, P0, P1):
    """Per point: the relative depth change of the reference solver's
    last iteration, replayed in float64 with the JAX iterate."""
    x9 = np.asarray(jtri.iterative_ls_triangulation(u0, u1, P0, P1,
                                                    iters=9)[0])
    x10 = np.asarray(jtri.iterative_ls_triangulation(u0, u1, P0, P1)[0])
    d = []
    for P in (P0, P1):
        P = np.asarray(P, np.float64)
        a, b = x9 @ P[2, :3] + P[2, 3], x10 @ P[2, :3] + P[2, 3]
        d.append(np.abs(a - b) / np.maximum(np.abs(b), 1e-12))
    return np.maximum(*d)


def test_iterative_and_linear():
    X, (u0, u1), E0, E1 = _scene()
    u0u = np.asarray(jgeom.undistort_points(jnp.asarray(u0), jnp.asarray(K),
                                            jnp.asarray(DIST)))
    u1u = np.asarray(jgeom.undistort_points(jnp.asarray(u1), jnp.asarray(K),
                                            jnp.asarray(DIST)))
    P0, P1 = _P(E0), _P(E1)
    jX, jst = map(np.asarray, jtri.iterative_ls_triangulation(
        *map(jnp.asarray, (u0u, u1u, P0, P1))))
    pX, pst = tri.iterative_ls_triangulation(
        *map(torch.tensor, (u0u, u1u, P0, P1)))
    _depth_close(pX.numpy(), jX, X)
    boundary = np.abs(_last_change(*map(jnp.asarray, (u0u, u1u, P0, P1)))
                      - TOL) <= 0.01 * TOL
    np.testing.assert_array_equal(pst.numpy()[~boundary], jst[~boundary])
    assert jst.mean() > 0.9
    jL = np.asarray(jtri.linear_eigen_triangulation(
        *map(jnp.asarray, (u0u, u1u, P0, P1))))
    pL = tri.linear_eigen_triangulation(*map(torch.tensor,
                                             (u0u, u1u, P0, P1))).numpy()
    _depth_close(pL, jL, X)
    d = tri._dlt_system_two_view(*map(torch.tensor, (u0u, u1u, P0, P1)))
    jd = np.stack([np.asarray(jtri._dlt_system_two_view(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(P0), jnp.asarray(P1)))
        for a, b in zip(u0u[:5], u1u[:5])])
    np.testing.assert_allclose(d.numpy()[:5], jd, rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("approach", ["iterative_LS_triangulation",
                                      "linear_triangulation"])
def test_triangulate_two_views_with_distortion(approach):
    X, (u0, u1), E0, E1 = _scene(seed=1)
    cams = [Camera.create(width=660, height=470, K=K, dist=DIST,
                          extrinsics=E) for E in (E0, E1)]
    jcams = [JCamera.create(width=660, height=470, K=K, dist=DIST,
                            extrinsics=E) for E in (E0, E1)]
    got = Triangulate(cams, [u0, u1], device="cpu").triangulate_two_views(
        approach=approach)
    ref = JTriangulate(jcams, [u0, u1]).triangulate_two_views(
        approach=approach)
    assert got.shape == ref.shape == (len(u0), 3)
    _depth_close(got, ref, X)
    np.testing.assert_allclose(got, X, atol=0.05 * 20)


def test_bilinear_and_colours():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (47, 61, 3)).astype(np.uint8)
    xy = rng.uniform(-3, 64, (200, 2)).astype(np.float32)
    for im in (img.astype(np.float32), img[..., 0].astype(np.float32)):
        np.testing.assert_allclose(
            tri.interpolate_bilinear(torch.tensor(im), torch.tensor(xy)),
            np.asarray(jtri.interpolate_bilinear(jnp.asarray(im),
                                                 jnp.asarray(xy))),
            atol=1e-5 * 255)
    X, (u0, u1), E0, E1 = _scene(n=50, seed=2)
    K0 = K * np.float32(0.1)
    K0[2, 2] = 1.0
    cam = Camera.create(width=61, height=47, K=K0, dist=DIST, extrinsics=E0)
    jcam = JCamera.create(width=61, height=47, K=K0, dist=DIST,
                          extrinsics=E0)
    t = Triangulate([cam, cam], [u0, u1], device="cpu")
    jt = JTriangulate([jcam, jcam], [u0, u1])
    t.points3d, jt.points3d = X, X
    np.testing.assert_allclose(t.interpolate_colors_from_image(img, cam),
                               jt.interpolate_colors_from_image(img, jcam),
                               atol=1e-5)
