"""The port's DSM, orthophoto, DEM of difference and binned statistics
== icepy4d_tpu's on the CPU, on seeded clouds of 8-20 k points and grids
of at most 128^2.

Cell counts and masks are equal cell by cell (the binning divides as
XLA does under `jit`: a true f32 division, no reciprocal); observed
cells' z is equal bit for bit (the scatter-add sums in the same order);
cells filled by the 3x3 diffusion are within 1e-5 (XLA's convolution
and PyTorch's sum the nine taps in different orders); the orthophoto
and the `VolumeReport` within 1e-5; `binned_statistic` counts equal,
mean and std within 1e-5. The CSV rows of `DemOfDifference` are equal
byte for byte.
"""

import sys

import numpy as np
import pytest

from icepy4d_tpu.core import Camera as JCamera
from icepy4d_tpu.post_processing import DemOfDifference as JDoD
from icepy4d_tpu.utils import binned_stats as JB
from icepy4d_tpu.utils import dsm_orthophoto as J
from icepy4d_tpu_torch.core import Camera
from icepy4d_tpu_torch.io import write_ply
from icepy4d_tpu_torch.post_processing import DemOfDifference
from icepy4d_tpu_torch.utils import binned_stats as PB
from icepy4d_tpu_torch.utils import dsm_orthophoto as P


def surface(n=12000, seed=0, hole=True, shift=0.0):
    """A smooth surface z(x, y) over [0, 12.7)^2, 1 cm of noise, with a
    round hole of radius 2 m (cells there are empty or filled)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 12.7, (n, 2))
    if hole:
        xy = xy[((xy[:, 0] - 6) ** 2 + (xy[:, 1] - 6) ** 2) > 4]
    z = 3 + 0.3 * np.sin(xy[:, 0]) + 0.2 * xy[:, 1] + shift \
        + rng.normal(0, 0.01, len(xy))
    p = np.c_[xy, z].astype(np.float32)
    p[:5, 2] = np.nan                                # non-finite points
    return p


def assert_dsm_equal(a, b):
    np.testing.assert_array_equal(b.count, a.count)
    np.testing.assert_array_equal(b.mask, a.mask)
    obs = a.count > 0
    np.testing.assert_array_equal(b.z[obs], a.z[obs])
    np.testing.assert_allclose(b.z, a.z, atol=1e-5, equal_nan=True)
    np.testing.assert_array_equal(b.xx, a.xx)
    np.testing.assert_array_equal(b.yy, a.yy)
    assert b.res == a.res


@pytest.mark.parametrize("res,fill", [(0.125, True), (0.25, True),
                                      (0.3, False)])
def test_build_dsm(res, fill):
    p = surface()
    a = J.build_dsm(p, res, fill_holes=fill)
    b = P.build_dsm(p, res, fill_holes=fill, device="cpu")
    assert_dsm_equal(a, b)
    assert a.z.shape[0] <= 128
    assert (a.mask.sum() > (a.count > 0).sum()) == fill


def test_build_dsm_limits_and_fill_iters():
    p = surface(seed=1)
    kw = dict(xlim=(1.0, 11.5), ylim=(-0.5, 12.0), fill_iters=3)
    assert_dsm_equal(J.build_dsm(p, 0.2, **kw),
                     P.build_dsm(p, 0.2, device="cpu", **kw))


def test_dem_of_difference():
    lim = dict(xlim=(0.0, 13.0), ylim=(0.0, 13.0))
    d0 = (J.build_dsm(surface(seed=2), 0.25, **lim),
          P.build_dsm(surface(seed=2), 0.25, device="cpu", **lim))
    d1 = (J.build_dsm(surface(seed=3, hole=False, shift=0.05), 0.25, **lim),
          P.build_dsm(surface(seed=3, hole=False, shift=0.05), 0.25,
                      device="cpu", **lim))
    dz_j, rep_j = J.dem_of_difference(d0[0], d1[0])
    dz_p, rep_p = P.dem_of_difference(d0[1], d1[1])
    np.testing.assert_allclose(dz_p, dz_j, atol=1e-5, equal_nan=True)
    for f in ("added", "removed", "net", "area", "mean_dz",
              "matching_percent", "avg_neighbors_per_cell"):
        np.testing.assert_allclose(getattr(rep_p, f), getattr(rep_j, f),
                                   rtol=1e-5, atol=1e-5)
    assert 0.04 < rep_p.mean_dz < 0.06 and rep_p.matching_percent < 100


def test_dsm_shape_mismatch_raises():
    a = P.build_dsm(surface(), 0.5, device="cpu")
    b = P.build_dsm(surface(), 0.25, device="cpu")
    with pytest.raises(ValueError, match="share shape"):
        P.dem_of_difference(a, b)


@pytest.mark.parametrize("direction", ["x", "y", "z"])
def test_dem_of_difference_class_csv(tmp_path, direction):
    """Paths and arrays, every direction: the reports agree and the two
    CSV writers' files are byte-equal."""
    c0 = surface(8000, seed=4, hole=False)[5:]
    c1 = surface(8000, seed=5, hole=False, shift=-0.02)[5:]
    write_ply(tmp_path / "cloud_2022_07_01.ply", c0)
    write_ply(tmp_path / "cloud_2022_07_06.ply", c1)
    paths = [str(tmp_path / "cloud_2022_07_01.ply"),
             str(tmp_path / "cloud_2022_07_06.ply")]
    for pkg, make in (("jax", lambda *a, **k: JDoD(*a, **k)),
                      ("torch", lambda *a, **k: DemOfDifference(
                          *a, device="cpu", **k))):
        d = make(*paths, dsm_step=0.3, direction=direction)
        d.write_result_row(tmp_path / f"{pkg}_rows.csv")
        d.write_result_to_file(tmp_path / f"{pkg}_vol.csv", label="a")
        arr = make(c0, c1, dsm_step=0.3, direction=direction)
        arr.write_result_row(tmp_path / f"{pkg}_rows.csv")
    for name in ("rows.csv", "vol.csv"):
        assert (tmp_path / f"torch_{name}").read_bytes() == \
            (tmp_path / f"jax_{name}").read_bytes()
    with pytest.raises(ValueError, match="direction"):
        DemOfDifference(c0, c1, direction="w", device="cpu")


def test_orthophoto():
    """A 640x480 frame of band-limited texture (gradients up to ~0.05 a
    pixel) looking down at the surface: the colours sampled at every
    cell within 1e-5, the valid cells equal. (The two packages' world to
    camera products round differently, by up to ~1e-4 px.)"""
    import cv2

    p = surface(20000, seed=6)
    dsm_j = J.build_dsm(p, 0.125)
    dsm_p = P.build_dsm(p, 0.125, device="cpu")
    rng = np.random.default_rng(7)
    img = cv2.GaussianBlur(rng.uniform(0, 255, (480, 640, 3)), (0, 0), 4)
    img = np.clip((img - 127.5) * 8 + 127.5, 0, 255).astype(np.uint8)
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    E = np.eye(4)
    E[:3, :3] = np.diag([1.0, -1.0, -1.0])           # looking down -z
    E[:3, 3] = -E[:3, :3] @ np.array([6.5, 6.0, 12.0])
    dist = np.array([0.01, -0.002, 0.0, 0.0])
    jc = JCamera.create(width=640, height=480, K=K, dist=dist,
                        extrinsics=E)
    pc = Camera.create(width=640, height=480, K=K, dist=dist, extrinsics=E)
    for im in (img, img[..., 0]):
        rgb_j, v_j = J.generate_orthophoto(im, dsm_j, jc)
        rgb_p, v_p = P.generate_orthophoto(im, dsm_p, pc, device="cpu")
        np.testing.assert_array_equal(v_p, v_j)
        np.testing.assert_allclose(rgb_p, rgb_j, atol=1e-5)
        assert 0.3 < v_p.mean() < 1.0


def test_save_dsm(tmp_path, monkeypatch):
    p = surface()
    a = J.build_dsm(p, 0.5)
    b = P.build_dsm(p, 0.5, device="cpu")
    J.save_dsm_npz(a, tmp_path / "j.npz")
    P.save_dsm_npz(b, tmp_path / "p.npz")
    with np.load(tmp_path / "j.npz") as fj, np.load(tmp_path / "p.npz") as fp:
        assert sorted(fj.files) == sorted(fp.files)
        for k in fj.files:
            np.testing.assert_allclose(fp[k], fj[k], atol=1e-5)
    monkeypatch.setitem(sys.modules, "rasterio", None)   # import raises
    assert P.save_dsm_geotiff(b, tmp_path / "p.tif") is False
    assert J.save_dsm_geotiff(a, tmp_path / "j.tif") is False


@pytest.mark.parametrize("nd,step,bounds", [
    (2, 0.5, None), (2, (0.25, 0.4), [(1.0, 11.0), (0.0, 12.0)]),
    (3, 0.75, None)])
def test_binned_statistic(nd, step, bounds):
    rng = np.random.default_rng(nd)
    coords = rng.uniform(0, 12, (15000, nd)).astype(np.float32)
    values = (np.sin(coords[:, 0]) + rng.normal(0, 0.1, len(coords))
              ).astype(np.float32)
    values[:7] = np.nan
    coords[7:10, 0] = np.nan
    a = JB.binned_statistic(coords, values, step, bounds)
    b = PB.binned_statistic(coords, values, step, bounds, device="cpu")
    np.testing.assert_array_equal(b["count"], a["count"])
    for k in ("mean", "std"):
        np.testing.assert_allclose(b[k], a[k], atol=1e-5, equal_nan=True)
    for ea, eb in zip(a["edges"], b["edges"]):
        np.testing.assert_array_equal(eb, ea)
    assert a["count"].sum() > 0.8 * len(coords)
