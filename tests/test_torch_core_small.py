"""The port's small core modules == icepy4d_tpu's.

Least-squares Helmert estimation (`least_squares/`): T within 1e-6 of
the world scale (the estimate refines centroid-relative float32
coordinates: measured 1.9e-10 relative at UTM scale), parameters to T
within 1e-6. EXIF intrinsics through a JPEG whose EXIF block is written
byte by byte, with the port's own copy of the sensor database. The
native batch EXIF scanner (compiled here with g++) against the Python
reader. The padded FeatureSet / PointSet against the JAX structs.
"""

from datetime import datetime

import numpy as np
import pytest

from icepy4d_tpu.core import FeatureSet as JFeatureSet
from icepy4d_tpu.core import PointSet as JPointSet
from icepy4d_tpu.core.images import Image as JImage
from icepy4d_tpu.core.sensor_width_database import \
    SensorWidthDatabase as JSensorWidthDatabase
from icepy4d_tpu.least_squares import (
    compute_residuals as j_residuals,
    estimate_similarity_least_squares as j_estimate,
    get_T_from_params as j_T)
from icepy4d_tpu_torch import FeatureSet, Features, Points, PointSet
from icepy4d_tpu_torch.core import ImageDS, SensorWidthDatabase
from icepy4d_tpu_torch.core.images import Image, read_exif_tags
from icepy4d_tpu_torch.core.sensor_width_database import BUNDLED_CSV
from icepy4d_tpu_torch.least_squares import (
    compute_residuals, estimate_similarity_least_squares, get_T_from_params)
from icepy4d_tpu_torch.native import exif, exif_scan_batch, native_available
from torch_port_inputs import exif_jpeg

UTM = np.array([5.1e5, 5.09e6, 1500.0])


def _points(seed=0, n=12, noise=0.01):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-50, 50, (n, 3)) + UTM
    p = np.array([0.01, -0.02, 0.3, 10.0, -5.0, 2.0, 1.001])
    T = j_T(p).astype(np.float64)
    x1 = (x0 - UTM) @ T[:3, :3].T + T[:3, 3] + UTM \
        + rng.normal(0, noise, (n, 3))
    return x0, x1, p


@pytest.mark.parametrize("weighted", [False, True])
def test_helmert_estimate(weighted):
    x0, x1, _ = _points()
    w = np.linspace(0.5, 1.5, 36).reshape(12, 3) if weighted else None
    T_j, rep_j = j_estimate(x0, x1, weights=w)
    T_p, rep_p = estimate_similarity_least_squares(x0, x1, weights=w,
                                                   device="cpu")
    scale = np.abs(UTM).max()
    np.testing.assert_allclose(T_p[:3, :3], T_j[:3, :3], atol=1e-6)
    np.testing.assert_allclose(T_p[:3, 3], T_j[:3, 3], atol=1e-6 * scale)
    np.testing.assert_allclose(rep_p["rmse"], rep_j["rmse"], rtol=1e-6)
    # seeded from a given T0
    T_j0, _ = j_estimate(x0, x1, T0=T_j)
    T_p0, _ = estimate_similarity_least_squares(x0, x1, T0=T_j,
                                                device="cpu")
    np.testing.assert_allclose(T_p0[:3, :3], T_j0[:3, :3], atol=1e-6)


def test_helmert_params_and_residuals():
    x0, x1, p = _points(seed=1)
    x0, x1 = x0 - UTM, x1 - UTM
    np.testing.assert_allclose(get_T_from_params(p, device="cpu"), j_T(p),
                               atol=1e-6)
    w = np.full((12, 3), 2.0)
    for weights in (None, w):
        r_j = j_residuals(p, x0, x1, weights)
        r_p = compute_residuals(p, x0, x1, weights, device="cpu")
        np.testing.assert_allclose(r_p, r_j, atol=1e-6 * np.abs(x1).max())


def test_sensor_database_is_the_ports_own_copy():
    assert BUNDLED_CSV.parts[-4] == "icepy4d_tpu_torch"
    ours, theirs = SensorWidthDatabase(), JSensorWidthDatabase()
    assert ours.table == theirs.table and len(ours.table) > 3000
    for make, model in (("Canon", "Canon EOS 6D"), ("NIKON", "NIKON D850"),
                        ("", "fc330"), ("Acer", "CE-5330")):
        assert ours.lookup(make, model) == theirs.lookup(make, model)
    with pytest.raises(LookupError):
        ours.lookup("nobody", "zz-unknown-zz")


def test_intrinsics_from_exif(tmp_path):
    img = np.random.default_rng(0).integers(0, 255, (60, 90, 3), np.uint8)
    path = tmp_path / "IMG_0001.jpg"
    exif_jpeg(path, img, "2022:07:28 10:11:12", make="NIKON CORPORATION",
              model="NIKON D850", focal_mm=35.0)
    tags = read_exif_tags(path)
    assert tags["Make"] == "NIKON CORPORATION" and tags["FocalLength"] == 35.0
    K = Image(path).get_intrinsics_from_exif()
    np.testing.assert_allclose(K, JImage(path).get_intrinsics_from_exif(),
                               rtol=1e-6)
    np.testing.assert_allclose(K[0, 0], 35.0 * 90 / 35.9, rtol=1e-6)
    plain = tmp_path / "plain.jpg"
    import cv2

    cv2.imwrite(str(plain), img)
    assert Image(plain).get_intrinsics_from_exif() is None
    exif_jpeg(tmp_path / "odd.jpg", img, "2022:07:28 10:11:12",
              make="Nobody", model="zz-unknown-zz")
    assert Image(tmp_path / "odd.jpg").get_intrinsics_from_exif() is None


def test_native_exif_scan(tmp_path):
    """The scanner built from native/exif_scan.cpp into the port's
    _build/ agrees with the Python reader; the prescan stamps ImageDS."""
    img = np.zeros((16, 24, 3), np.uint8)
    stamps = ["2022:07:28 10:11:12", "2022:07:29 08:00:00"]
    for i, s in enumerate(stamps):
        exif_jpeg(tmp_path / f"IMG_{i}.jpg", img, s, focal_mm=24.5 + i)
    import cv2

    cv2.imwrite(str(tmp_path / "IMG_9.jpg"), img)          # no EXIF
    files = sorted(tmp_path.glob("*.jpg"))
    assert native_available()
    lib = exif._SCANNER._lib_path()
    assert lib.parent.name == "_build" and lib.exists()
    dts, focals = exif_scan_batch(files)
    want = [datetime.strptime(s, "%Y:%m:%d %H:%M:%S") for s in stamps]
    assert dts == want + [None]
    np.testing.assert_allclose(focals[:2], [24.5, 25.5])
    assert np.isnan(focals[2])
    assert [Image(f).datetime for f in files] == dts
    ds = ImageDS(tmp_path)
    assert [im._datetime for im in ds] == dts


def test_feature_set():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 100, (11, 2)).astype(np.float32)
    descr = rng.normal(size=(11, 4)).astype(np.float32)
    score = rng.uniform(size=11).astype(np.float32)
    ids = np.arange(100, 111)
    for kw in ({}, {"capacity": 32}):
        got = FeatureSet.from_arrays(xy, descr=descr.T, score=score,
                                     track_id=ids, device="cpu", **kw)
        ref = JFeatureSet.from_arrays(xy, descr=descr.T, score=score,
                                      track_id=ids, **kw)
        for f in ("xy", "descr", "score", "track_id", "mask"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(ref, f)))
        assert got.capacity == ref.capacity and int(got.num_valid) == 11
    back = got.compact()
    np.testing.assert_array_equal(back.kpts_to_numpy(), xy)
    np.testing.assert_array_equal(back.track_ids_to_numpy(), ids)
    pad = Features.from_numpy(xy, descr=descr).to_padded(device="cpu")
    np.testing.assert_array_equal(pad.track_id.numpy()[:11], np.arange(11))
    with pytest.raises(ValueError):
        FeatureSet.from_arrays(xy, capacity=8, device="cpu")


def test_point_set():
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(5, 3)).astype(np.float32)
    col = rng.uniform(size=(5, 3)).astype(np.float32)
    got = PointSet.from_arrays(xyz, color=col, device="cpu")
    ref = JPointSet.from_arrays(xyz, color=col)
    for f in ("xyz", "color", "track_id", "mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    pts = Points()
    pts.append_points_from_numpy(xyz, colors=col)
    padded = pts.to_padded(capacity=16, device="cpu")
    assert padded.capacity == 16 and int(padded.num_valid) == 5
    assert padded.replace(mask=padded.mask[:0]).mask.numel() == 0
