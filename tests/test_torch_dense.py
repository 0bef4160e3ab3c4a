"""Port dense stereo (image warps, rectification, plane sweep,
left-right check, PlaneSweepStereo) against icepy4d_tpu on the same
inputs, on the CPU.

Where a result passes through a ZNCC cost, last-bit differences in its
inputs (XLA contracts the bilinear weights and the 3x3 maps into FMAs,
PyTorch's CPU kernels round each product) are amplified by the
cancellation in box(x * x) - m * m to ~1e-5 in the cost; the tolerances
below are stated beside each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.core.camera import Camera as JCamera
from icepy4d_tpu.ops import dense as jdense
from icepy4d_tpu.ops import geometry as jgeom
from icepy4d_tpu.ops import image as jimage
from icepy4d_tpu.ops import rectify as jrectify
from icepy4d_tpu.sfm.dense import PlaneSweepStereo as JPlaneSweepStereo
from icepy4d_tpu_torch.core import Camera
from icepy4d_tpu_torch.io import read_ply, write_ply
from icepy4d_tpu_torch.ops import dense, geometry, image, rectify
from icepy4d_tpu_torch.sfm import PlaneSweepStereo
from torch_port_inputs import stereo_rig, sweep_pair

H, W, F = 160, 200, 220.0
DIST = np.array([0.01, -0.002, 0.0005, -0.0003, 0.0], np.float32)
RNG = np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def flat_rig():
    """Camera 1 one unit right of camera 0: an already rectified rig."""
    return stereo_rig(H, W, F, 1.0, 10.0)


@pytest.fixture(scope="module")
def turned_rig():
    """Camera 1 yawed by 2 degrees and rolled by 1."""
    return stereo_rig(H, W, F, 1.0, 10.0, yaw=np.deg2rad(2.0),
                      roll=np.deg2rad(1.0), seed=1)


# -- box filter, ZNCC, left-right check ------------------------------------
# The JAX helpers run under jit, as inside the package's jitted sweeps:
# called eagerly, op by op, XLA neither fuses nor contracts them and
# their rounding differs from the sweeps' by up to ~1e-4 in the cost.

@pytest.mark.parametrize("w", [3, 7])
def test_box_filter(w):
    x = sweep_pair(61, 83)[0]
    ref = jax.jit(jdense._box_filter, static_argnums=1)(jnp.asarray(x), w)
    np.testing.assert_array_equal(dense._box_filter(_t(x), w).numpy(), ref)


def test_zncc_cost():
    I0, I1 = sweep_pair(61, 83, shift=1.7)
    got = dense._zncc_cost(_t(I0), _t(I1), 7).numpy()
    ref = jax.jit(jdense._zncc_cost, static_argnums=2)(
        jnp.asarray(I0), jnp.asarray(I1), 7)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_lr_consistency_mask():
    d0 = RNG.uniform(3, 12, (40, 70)).astype(np.float32)
    d1 = -d0 + RNG.normal(0, 1.2, d0.shape).astype(np.float32)
    for tau in (0.5, 2.0):
        got = dense.lr_consistency_mask(_t(d0), _t(d1), tau=tau).numpy()
        ref = np.asarray(jdense.lr_consistency_mask(
            jnp.asarray(d0), jnp.asarray(d1), tau=tau))
        np.testing.assert_array_equal(got, ref)


# -- plane sweep and unprojection -------------------------------------------

def test_plane_sweep(flat_rig):
    K, E0, E1, I0, I1 = flat_rig
    got = dense.plane_sweep(_t(I0), _t(I1), K, K, E0, E1, 5.0, 20.0,
                            n_planes=64, window=7)
    ref = jdense.plane_sweep(jnp.asarray(I0), jnp.asarray(I1),
                             jnp.asarray(K), jnp.asarray(K), jnp.asarray(E0),
                             jnp.asarray(E1), depth_min=5.0, depth_max=20.0,
                             n_planes=64, window=7)
    inb, rinb = got["inbounds"].numpy(), np.asarray(ref["inbounds"])
    assert (inb == rinb).mean() >= 0.999
    # the bilinear taps round differently (see the module docstring)
    cost, rcost = got["cost"].numpy(), np.asarray(ref["cost"])
    assert np.abs(cost - rcost).max() < 1e-4
    good = inb & rinb & (rcost < 0.2)
    assert good.mean() > 0.5
    rel = np.abs(got["depth"].numpy() - np.asarray(ref["depth"])) \
        / np.asarray(ref["depth"])
    assert np.mean(rel[good] <= 1e-3) >= 0.995
    assert np.median(np.abs(got["depth"].numpy()[20:-20, 40:-20] - 10.0)
                     [good[20:-20, 40:-20]]) < 0.05


def test_depth_to_points(turned_rig):
    K, E0, E1, _, _ = turned_rig
    depth = RNG.uniform(5, 20, (H, W)).astype(np.float32)
    got, valid = dense.depth_to_points(_t(depth), K, E1)
    ref, _ = jdense.depth_to_points(jnp.asarray(depth), jnp.asarray(K),
                                    jnp.asarray(E1))
    assert valid.all()
    assert _rel(got.numpy(), ref) < 1e-5


# -- rectification -------------------------------------------------------------

@pytest.mark.parametrize("sized", [False, True], ids=["plain", "image_size"])
@pytest.mark.parametrize("rig", ["flat_rig", "turned_rig"])
def test_rectify_pair(request, rig, sized):
    K, E0, E1, _, _ = request.getfixturevalue(rig)
    size = (W, H) if sized else None
    got = rectify.rectify_pair(K, E0, K, E1, image_size=size)
    ref = jrectify.rectify_pair(jnp.asarray(K), jnp.asarray(E0),
                                jnp.asarray(K), jnp.asarray(E1),
                                image_size=size)
    for key in ("H0", "H1", "K_new", "R_new", "C0"):
        assert _rel(got[key], ref[key]) < 1e-5, key
    np.testing.assert_allclose(got["baseline"], ref["baseline"], rtol=1e-6)
    np.testing.assert_allclose(got["disp_offset"], ref["disp_offset"],
                               atol=1e-4)
    if rig == "flat_rig" and not sized:
        np.testing.assert_allclose(got["H0"], np.eye(3), atol=1e-5)
        np.testing.assert_allclose(got["H1"], np.eye(3), atol=1e-5)


def test_disparity_depth_conversions(turned_rig):
    K, E0, E1, _, _ = turned_rig
    r = rectify.rectify_pair(K, E0, K, E1, image_size=(W, H))
    rj = jrectify.rectify_pair(jnp.asarray(K), jnp.asarray(E0),
                               jnp.asarray(K), jnp.asarray(E1),
                               image_size=(W, H))
    disp = RNG.uniform(5, 40, (30, 20)).astype(np.float32)
    got = rectify.disparity_to_depth(_t(disp), r["K_new"], r["baseline"],
                                     r["disp_offset"]).numpy()
    ref = jrectify.disparity_to_depth(jnp.asarray(disp), rj["K_new"],
                                      rj["baseline"], rj["disp_offset"])
    assert _rel(got, ref) < 1e-5
    z = np.array([5.0, 7.5, 20.0], np.float32)
    got = rectify.depth_to_disparity(_t(z), r["K_new"], r["baseline"],
                                     r["disp_offset"]).numpy()
    ref = jrectify.depth_to_disparity(jnp.asarray(z), rj["K_new"],
                                      rj["baseline"], rj["disp_offset"])
    assert _rel(got, ref) < 1e-5
    xy = RNG.uniform(0, 200, (50, 2)).astype(np.float32)
    d = RNG.uniform(5, 20, 50).astype(np.float32)
    got = rectify.rect_pixels_to_world(_t(xy), _t(d), r["K_new"],
                                       r["R_new"], r["C0"]).numpy()
    ref = jrectify.rect_pixels_to_world(jnp.asarray(xy), jnp.asarray(d),
                                        rj["K_new"], rj["R_new"], rj["C0"])
    assert _rel(got, ref) < 1e-5


# -- image warps ------------------------------------------------------------------

@pytest.mark.parametrize("channels", [None, 3])
def test_warp_homography(turned_rig, channels):
    K, E0, E1, I0, _ = turned_rig
    img = I0 if channels is None else np.stack([I0, 0.5 * I0, 1 - I0], -1)
    Hm = rectify.rectify_pair(K, E0, K, E1, image_size=(W, H))["H1"]
    got = image.warp_homography(_t(img), Hm, H, W).numpy()
    ref = jimage.warp_homography(jnp.asarray(img), jnp.asarray(Hm), H, W)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_undistort_image(flat_rig):
    K, _, _, I0, _ = flat_rig
    got = image.undistort_image(_t(I0), K, DIST).numpy()
    ref = jimage.undistort_image(jnp.asarray(I0), jnp.asarray(K),
                                 jgeom.pad_distortion(jnp.asarray(DIST)))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("channels", [None, 3])
def test_resize_downscale_2(channels):
    shape = (101, 157) if channels is None else (101, 157, channels)
    img = RNG.uniform(size=shape).astype(np.float32)
    got = image.resize(_t(img), (50, 78)).numpy()
    ref = jimage.resize(jnp.asarray(img), (50, 78))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_make_homography_and_geometry(turned_rig):
    K, E0, E1, _, _ = turned_rig
    got = image.make_homography(K, E0[:3, :3], 1.1 * K, E1[:3, :3])
    ref = jimage.make_homography(jnp.asarray(K), jnp.asarray(E0[:3, :3]),
                                 jnp.asarray(1.1 * K),
                                 jnp.asarray(E1[:3, :3]))
    assert _rel(got, ref) < 1e-6
    np.testing.assert_array_equal(geometry.pad_distortion(DIST).numpy(),
                                  jgeom.pad_distortion(jnp.asarray(DIST)))
    xn = RNG.uniform(-0.6, 0.6, (40, 2)).astype(np.float32)
    d8 = np.r_[DIST, [0.001, -0.0005, 0.0002]].astype(np.float32)
    np.testing.assert_allclose(
        geometry.distort_normalized(_t(xn), d8).numpy(),
        jgeom.distort_normalized(jnp.asarray(xn), jnp.asarray(d8)),
        atol=1e-6)
    np.testing.assert_array_equal(
        geometry.scale_intrinsics(_t(K), 0.5).numpy(),
        jgeom.scale_intrinsics(jnp.asarray(K), 0.5))


# -- PlaneSweepStereo ------------------------------------------------------------

CASES = {
    # name: (rig, stereo kwargs, colour)
    "rectified_lr": ("turned_rig", dict(method="rectified", lr_check=True),
                     False),
    "homography": ("flat_rig", dict(method="homography"), False),
    "downscale2_rgb": ("turned_rig", dict(method="rectified", downscale=2),
                       True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def stereo_runs(request):
    rig, kwargs, colour = CASES[request.param]
    K, E0, E1, I0, I1 = request.getfixturevalue(rig)
    if colour:
        # distinct channels whose luma is a scaled copy of the texture
        I0, I1 = (np.stack([x, 0.5 * x, 0.25 * x], -1) for x in (I0, I1))
    imgs = [(x * 255).astype(np.uint8) for x in (I0, I1)]
    jcams = [JCamera.create(width=W, height=H, K=K, dist=DIST, extrinsics=E)
             for E in (E0, E1)]
    cams = [Camera.create(width=c.width, height=c.height, K=c.K,
                          dist=c.dist, extrinsics=c.extrinsics)
            for c in jcams]
    args = dict(depth_min=5.0, depth_max=20.0, n_planes=64,
                cost_threshold=0.4, uniqueness_threshold=0.99, **kwargs)
    ref = JPlaneSweepStereo(jcams, imgs, **args)
    got = PlaneSweepStereo(cams, imgs, device="cpu", **args)
    return dict(got=got, res=got.run(), ref=ref, rres=ref.run(),
                image=imgs[0], camera=jcams[0])


def test_plane_sweep_stereo_matches_jax(stereo_runs):
    res, rres = stereo_runs["res"], stereo_runs["rres"]
    assert (res["valid"] == rres["valid"]).mean() >= 0.995
    both = res["valid"] & rres["valid"]
    assert both.mean() > 0.25
    rel = np.abs(res["depth"] - rres["depth"]) / np.abs(rres["depth"])
    assert rel[both].max() <= 1e-3
    assert np.median(np.abs(res["depth"][both] - 10.0)) < 0.1


def test_plane_sweep_stereo_point_cloud(stereo_runs, tmp_path):
    got, ref = stereo_runs["got"], stereo_runs["ref"]
    res, rres = stereo_runs["res"], stereo_runs["rres"]
    pts, colors = got.to_point_cloud()
    rpts, rcolors = ref.to_point_cloud()
    # the clouds list their valid pixels in row-major order
    both = res["valid"] & rres["valid"]
    mine = both[res["valid"]]
    theirs = both[rres["valid"]]
    assert _rel(pts[mine], rpts[theirs]) < 1e-3
    assert np.median(np.abs(pts[:, 2] - 10.0)) < 0.1
    assert (colors is None) == (rcolors is None)
    if colors is not None:
        # the port undistorts the colours as it does the gray image (the
        # JAX class samples them from the distorted image): compose the
        # expected colours from the JAX package's own ops
        cam = stereo_runs["camera"]
        rgb = jimage.undistort_image(
            jnp.asarray(stereo_runs["image"], jnp.float32) / 255.0,
            jnp.asarray(cam.K), jgeom.pad_distortion(jnp.asarray(cam.dist)))
        rgb = jimage.resize(rgb, res["depth"].shape)
        rgb = jimage.warp_homography(rgb, ref._rect["H0"], *res["depth"].shape)
        expect = np.asarray(rgb).reshape(-1, 3)[res["valid"].reshape(-1)]
        np.testing.assert_allclose(colors, expect, atol=1e-3)
        assert np.abs(colors[mine] - np.asarray(rcolors)[theirs]).max() > 1e-3
    write_ply(tmp_path / "cloud.ply", pts, colors)
    back, back_colors = read_ply(tmp_path / "cloud.ply")
    np.testing.assert_array_equal(back, pts.astype(np.float32))
    if colors is not None:
        np.testing.assert_array_equal(
            back_colors, (np.clip(colors, 0, 1) * 255).astype(np.uint8))


def test_ply_files_cross_read(tmp_path):
    from icepy4d_tpu.io import ply as jply

    xyz = RNG.normal(size=(37, 3)).astype(np.float32)
    rgb = RNG.integers(0, 256, (37, 3)).astype(np.uint8)
    for binary in (True, False):
        write_ply(tmp_path / "port.ply", xyz, rgb, binary=binary)
        jply.write_ply(tmp_path / "jax.ply", xyz, rgb, binary=binary)
        for a, b in (read_ply(tmp_path / "jax.ply"),
                     jply.read_ply(tmp_path / "port.ply")):
            np.testing.assert_allclose(a, xyz, rtol=1e-6)
            np.testing.assert_array_equal(b, rgb)
