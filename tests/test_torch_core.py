"""The port's host containers, files and sinks against icepy4d_tpu's:
targets, features, points, the epoch map's timestamp pairing (EXIF and
mtime), the EXIF reader, checkpoints, the YAML config and the two CSV
sinks (same columns and rows, values within 1e-6 relative)."""

import csv
import os
import time
from datetime import datetime

import cv2
import numpy as np
import pytest

from icepy4d_tpu.core import Camera as JCamera
from icepy4d_tpu.core import EpochDataMap as JEpochDataMap
from icepy4d_tpu.core import Features as JFeatures
from icepy4d_tpu.core import Points as JPoints
from icepy4d_tpu.core import Targets as JTargets
from icepy4d_tpu.core.images import Image as JImage
from icepy4d_tpu.io import export2textfile as jsinks
from icepy4d_tpu.utils.config import parse_cfg as j_parse_cfg
from icepy4d_tpu_torch.core import (Camera, Epoch, EpochDataMap, Epoches,
                                    Features, Image, Points, Targets)
from icepy4d_tpu_torch.core.images import read_exif_tags
from icepy4d_tpu_torch.io import export2textfile as sinks
from icepy4d_tpu_torch.utils.config import DotDict, parse_cfg
from torch_port_inputs import rotation_zyx


def _write(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def test_targets(tmp_path):
    _write(tmp_path / "a.csv", ["label", "x", "y"],
           [["T1", 10.5, 20.25], ["T3", 30.0, 40.0], ["T2", 1.0, 2.0]])
    _write(tmp_path / "b.csv", ["label", "x", "y"],
           [["T2", 5.0, 6.0], ["T1", 7.5, 8.5]])
    _write(tmp_path / "w.csv", ["label", "X", "Y", "Z"],
           [["T1", 1.0, 2.0, 3.0], ["T2", 4.0, 5.5, 6.0],
            ["T9", 7.0, 8.0, 9.0]])
    args = dict(im_file_path=[tmp_path / "a.csv", tmp_path / "b.csv"],
                obj_file_path=tmp_path / "w.csv")
    t, jt = Targets(**args), JTargets(**args)
    assert list(t.obj_coor["label"]) == list(jt.obj_coor["label"])
    labels = ["T2", "T1", "T3", "T7"]
    for got, ref in ((t.get_object_coor_by_label(labels),
                      jt.get_object_coor_by_label(labels)),
                     (t.get_image_coor_by_label(labels, 0),
                      jt.get_image_coor_by_label(labels, 0)),
                     (t.get_im_coor_by_label(labels, 1),
                      jt.get_im_coor_by_label(labels, 1))):
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[0].dtype == ref[0].dtype and got[1] == ref[1]
    t.scale_image_coordinates(0.2)
    jt.scale_image_coordinates(0.2)
    np.testing.assert_array_equal(t.get_im_coor_by_label(labels, 0)[0],
                                  jt.get_im_coor_by_label(labels, 0)[0])
    _write(tmp_path / "bad.csv", ["label", "u", "v"], [["T1", 1, 2]])
    for cls in (Targets, JTargets):
        with pytest.raises(ValueError, match="expected columns"):
            cls(im_file_path=[tmp_path / "bad.csv"])


def test_features_and_points():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 100, (20, 2))
    d = rng.normal(size=(20, 8)).astype(np.float32)
    s = rng.uniform(size=20)
    f, jf = Features(descr_dim=8), JFeatures(descr_dim=8)
    for feats in (f, jf):
        feats.append_features_from_numpy(xy[:10], descr=d[:10].T,
                                         scores=s[:10],
                                         track_ids=np.arange(100, 110))
        # colliding ids are re-assigned
        feats.append_features_from_numpy(xy[10:], descr=d[10:], scores=s[10:],
                                         track_ids=np.arange(105, 115))
        feats.filter_feature_by_mask(np.arange(20) % 3 != 0)
        feats.filter_feature_by_index([0, 2, 4, 6, 8, 10])
    for a, b in zip(f.to_numpy().values(), jf.to_numpy().values()):
        np.testing.assert_array_equal(a, b)
    assert f.get_track_ids() == jf.get_track_ids()
    assert f.last_track_id == jf.last_track_id and len(f) == len(jf) == 6
    tid = f.get_track_ids()[3]
    got, ref = f.get_feature_by_track_id(tid), jf.get_feature_by_track_id(tid)
    assert got.keys() == ref.keys() and got["x"] == ref["x"]
    for a, b in zip(f.get_features_as_dict().values(),
                    jf.get_features_as_dict().values()):
        np.testing.assert_array_equal(a, b)
    p, jp = Points(), JPoints()
    coords = rng.normal(size=(6, 3))
    for pts in (p, jp):
        pts.append_points_from_numpy(coords, track_ids=None,
                                     colors=np.full((6, 3), 128.0))
        pts.filter_point_by_mask([1, 1, 0, 1, 1, 1])
    np.testing.assert_array_equal(p.to_numpy(), jp.to_numpy())
    np.testing.assert_array_equal(p.colors_to_numpy(as_uint8=True),
                                  jp.colors_to_numpy(as_uint8=True))
    assert p.get_track_ids() == jp.get_track_ids()


def _jpeg_with_exif(path, tags: dict):
    from PIL import Image as PILImage

    im = PILImage.fromarray(np.full((16, 24, 3), 90, np.uint8))
    exif = PILImage.Exif()
    ifd = exif.get_ifd(0x8769)
    for tag, value in tags.items():
        if tag == 0x0132 or tag == 0x010F:
            exif[tag] = value
        else:
            ifd[tag] = value
    im.save(path, exif=exif)


@pytest.mark.parametrize("tags", [
    {0x9003: "2022:07:28 14:05:33", 0x0132: "2022:07:29 10:00:00"},
    {0x0132: "2021:05:01 08:30:00", 0x010F: "Canon"},
    {}])
def test_exif_datetime(tmp_path, tags):
    path = tmp_path / "img.jpg"
    _jpeg_with_exif(path, tags)
    assert Image(path).datetime == JImage(path).datetime
    if tags:
        assert Image(path).datetime is not None
        want = tags.get(0x9003, tags.get(0x0132))
        assert read_exif_tags(path).get(
            "DateTimeOriginal" if 0x9003 in tags else "DateTime") == want


def _season_tree(root):
    """Two camera folders of PNGs with mtimes; cam2's third frame is 2 h
    off and pairs with nothing at a 20-minute tolerance."""
    base = time.mktime((2022, 7, 28, 12, 0, 0, 0, 0, -1))
    offsets = {"cam1": [0, 3600, 7200], "cam2": [30, 3650, 14400]}
    for cam, offs in offsets.items():
        d = root / cam
        d.mkdir(parents=True)
        for i, off in enumerate(offs):
            p = d / f"IMG_{i}.png"
            cv2.imwrite(str(p), np.full((8, 8), 10 * i, np.uint8))
            os.utime(p, (base + off, base + off))


def test_epoch_map_pairing_and_pickle(tmp_path):
    _season_tree(tmp_path / "img")
    kw = dict(time_tolerance_sec=1200, use_mtime_fallback=True)
    m = EpochDataMap(tmp_path / "img", **kw)
    csv_port = (tmp_path / "img" / "epoch_map.csv").read_text()
    jm = JEpochDataMap(tmp_path / "img", **kw)
    assert csv_port == (tmp_path / "img" / "epoch_map.csv").read_text()
    assert len(m) == len(jm) == 2 and m.cameras == jm.cameras
    for ep in range(len(m)):
        assert m.get_timestamp(ep) == jm.get_timestamp(ep)
        assert {c: im.name for c, im in m.get_images(ep).items()} == \
            {c: im.name for c, im in jm.get_images(ep).items()}
    assert len(EpochDataMap(tmp_path / "img", write_csv=False)) == 0

    images = m.get_images(1)
    cams = {c: Camera.create(width=8, height=8) for c in images}
    feats = {c: Features.from_numpy(np.ones((3, 2)), descr=np.ones((3, 4)))
             for c in images}
    ep = Epoch(m.get_timestamp(1), images=images, cameras=cams,
               features=feats, epoch_dir=tmp_path / "res")
    assert images["cam1"].value.shape == (8, 8, 3)
    ep.flag("ba_rmse", "degraded", ba_rmse_px=3.0)
    ep.flag("few_inliers", "failed")
    ep.flag("ba_failed", "degraded")
    path = ep.save_pickle()
    back = Epoch.read_pickle(path)
    assert back.quality == {"status": "failed",
                            "flags": ["ba_rmse", "few_inliers", "ba_failed"],
                            "stats": {"ba_rmse_px": 3.0}}
    assert back.date_str == "2022-07-28_13-00-00" == ep.date_str
    assert back.images["cam1"]._value is None      # pixels are not pickled
    np.testing.assert_array_equal(back.images["cam1"].value,
                                  images["cam1"].value)
    np.testing.assert_array_equal(back.features["cam2"].kpts_to_numpy(),
                                  feats["cam2"].kpts_to_numpy())
    eps = Epoches()
    assert eps.add_epoch(back) == 0 and eps.add_epoch(ep) == 1
    assert eps.get_epoch_by_date("2022-07-28_13-00-00") is ep
    assert eps.get_epoch_id(datetime(2022, 7, 28, 13)) == 1


def test_config(tmp_path):
    (tmp_path / "img" / "cam1").mkdir(parents=True)
    (tmp_path / "img" / "cam2").mkdir()
    (tmp_path / "cfg.yaml").write_text(
        "paths:\n  image_dir: img\n  results_dir: res\n"
        "georef:\n  camera_centers_world: [[1, 2, 3], [4, 5, 6]]\n"
        "proc:\n  epoch_to_process: [1, 3]\n")
    cfg, jcfg = parse_cfg(tmp_path / "cfg.yaml"), j_parse_cfg(
        tmp_path / "cfg.yaml")
    assert cfg.paths.image_dir == jcfg.paths.image_dir
    assert cfg.paths.camera_names == jcfg.paths.camera_names
    assert cfg.proc.epoch_to_process == jcfg.proc.epoch_to_process == [1, 2, 3]
    np.testing.assert_array_equal(cfg.georef.camera_centers_world,
                                  jcfg.georef.camera_centers_world)
    d = DotDict.wrap({"a": {"b": [{"c": 1}]}})
    assert d.a.b[0].c == 1
    with pytest.raises(AttributeError):
        d.missing


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_csv_sinks(tmp_path):
    rng = np.random.default_rng(3)
    K = np.array([[900.0, 0, 320], [0, 900.0, 240], [0, 0, 1]], np.float32)
    exts = []
    for i in range(2):
        E = np.eye(4, dtype=np.float32)
        E[:3, :3] = rotation_zyx(0.1 * i, -0.05, 0.02 * i)
        E[:3, 3] = [-1.0 * i, 0.2, 0.5]
        exts.append(E)
    X = np.c_[rng.uniform(-3, 3, (40, 2)), rng.uniform(8, 12, 40)].astype(
        np.float32)
    dist = np.array([-0.05, 0.01, 0, 0, 0], np.float32)
    cams = {f"cam{i + 1}": Camera.create(width=640, height=480, K=K,
                                         dist=dist, extrinsics=E)
            for i, E in enumerate(exts)}
    jcams = {f"cam{i + 1}": JCamera.create(width=640, height=480, K=K,
                                           dist=dist, extrinsics=E)
             for i, E in enumerate(exts)}
    obs = {n: c.project_point(X) + rng.normal(0, 0.5, (40, 2))
           for n, c in cams.items()}
    obs["cam2"][:3] = np.nan
    for label in ("2022-07-28_12-00-00", "2022-07-29_12-00-00"):
        r = sinks.write_reprojection_error_to_file(
            tmp_path / "res.csv", label, cams, X, obs)
        jr = jsinks.write_reprojection_error_to_file(
            tmp_path / "jres.csv", label, jcams, X, obs)
        assert r == pytest.approx(jr, rel=1e-6)
        sinks.write_cameras_to_file(tmp_path / "cams.csv", label, cams)
        jsinks.write_cameras_to_file(tmp_path / "jcams.csv", label, jcams)
    for name in ("res", "cams"):
        got, ref = _rows(tmp_path / f"{name}.csv"), \
            _rows(tmp_path / f"j{name}.csv")
        assert got[0] == ref[0] and len(got) == len(ref) == 3
        for g, r in zip(got[1:], ref[1:]):
            assert g[0] == r[0]
            np.testing.assert_allclose(np.float64(g[1:]), np.float64(r[1:]),
                                       rtol=1e-6, atol=1e-12)
    feats = {n: Features.from_numpy(o[:5]) for n, o in obs.items()}
    sinks.export_keypoints(tmp_path / "k.txt", feats)
    jsinks.export_keypoints(tmp_path / "jk.txt", feats)
    assert (tmp_path / "k.txt").read_text() == \
        (tmp_path / "jk.txt").read_text()
    sinks.export_points3D(tmp_path / "p.txt", X)
    jsinks.export_points3D(tmp_path / "jp.txt", X)
    assert (tmp_path / "p.txt").read_text() == \
        (tmp_path / "jp.txt").read_text()
