"""The port's homography warping, match plot and match writer against
icepy4d_tpu's.

`homography_from_cameras` and `smooth_euler_angles` agree to float32;
the warped images of both packages are within 1 grey level on >= 99% of
the pixels; `plot_matches_cv2` draws the same mosaic; with equal
putatives `save_mkpts_as_txt` writes the same text. Both pipelines'
`do_homography_warping` write one warped image an epoch, the reference
epoch's own warp near identity (> 50% non-zero, as
tests/test_pipeline.py:519 holds the JAX package), and `other.do_viz`
writes matches.png and both keypoint files in each epoch's directory."""

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from icepy4d_tpu import Pipeline as JPipeline
from icepy4d_tpu.core.camera import Camera as JCamera
from icepy4d_tpu.matching import GeometricVerification as JGV
from icepy4d_tpu.matching import LightGlueMatcher as JLightGlueMatcher
from icepy4d_tpu.utils import homography as jh
from icepy4d_tpu.utils.config import DotDict as JDotDict
from icepy4d_tpu.visualization import plot_matches_cv2 as j_plot_matches_cv2
from icepy4d_tpu_torch.core import Camera
from icepy4d_tpu_torch.matching import (GeometricVerification,
                                        LightGlueMatcher)
from icepy4d_tpu_torch.pipeline import Pipeline
from icepy4d_tpu_torch.utils import homography as h
from icepy4d_tpu_torch.visualization import plot_matches_cv2
from torch_port_inputs import (REPO_WEIGHTS, StereoSeason, rotation_zyx,
                               shifted_pair)

K = np.array([[500.0, 0, 200], [0, 505.0, 150], [0, 0, 1]], np.float32)
OPTIONS = {"superpoint_weights": str(REPO_WEIGHTS / "superpoint_synthetic.npz"),
           "lightglue_weights": str(REPO_WEIGHTS / "lightglue_synthetic.npz"),
           "activation_dtype": "float32"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cams(angles):
    out = []
    for yaw, pitch, roll in angles:
        E = np.eye(4, dtype=np.float32)
        E[:3, :3] = rotation_zyx(yaw, pitch, roll)
        E[:3, 3] = [0.2, -0.1, 0.05]
        out.append((E, Camera.create(width=400, height=300, K=K,
                                     extrinsics=E),
                    JCamera.create(width=400, height=300, K=K,
                                   extrinsics=E)))
    return out


def test_homography_from_cameras():
    (_, c0, j0), (_, c1, j1) = _cams([(0.0, 0.0, 0.0), (0.03, -0.02, 0.01)])
    np.testing.assert_allclose(h.homography_from_cameras(c0, c1),
                               jh.homography_from_cameras(j0, j1),
                               rtol=1e-6, atol=1e-9)


def test_smooth_euler_angles():
    a = np.random.default_rng(0).normal(size=(7, 3))
    for window in (0, 1, 2, 5):
        np.testing.assert_array_equal(h.smooth_euler_angles(a, window),
                                      jh.smooth_euler_angles(a, window))


@pytest.mark.parametrize("rgb", [False, True])
def test_warp_image_to_reference(rgb):
    img0, _ = shifted_pair(300, 400)
    img = np.stack([img0, img0[::-1], 255 - img0], -1) if rgb else img0
    (_, ref, jref), (_, cam, jcam) = _cams([(0.0, 0.0, 0.0),
                                           (0.02, -0.015, 0.01)])
    got = h.warp_image_to_reference(img, cam, ref, device="cpu")
    want = np.asarray(jh.warp_image_to_reference(img, jcam, jref))
    assert got.shape == want.shape == img.shape
    grey = np.abs(got - want) * 255
    assert (grey <= 1.0).mean() >= 0.99
    assert (got > 0).mean() > 0.5


def test_plot_matches_cv2(tmp_path):
    img0, img1 = shifted_pair(120, 160)
    rng = np.random.default_rng(1)
    p0 = rng.uniform([0, 0], [160, 120], (40, 2)).astype(np.float32)
    p1 = p0 + [5.0, -3.0]
    got = plot_matches_cv2(img0, img1, p0, p1, path=tmp_path / "a.png")
    want = j_plot_matches_cv2(img0, img1, p0, p1, path=tmp_path / "b.png")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png")),
                                  cv2.imread(str(tmp_path / "b.png")))
    # float images in [0, 1], more matches than lines
    f0 = img0.astype(np.float32) / 255
    np.testing.assert_array_equal(
        plot_matches_cv2(f0, f0, p0, p0, max_lines=7),
        j_plot_matches_cv2(f0, f0, p0, p0, max_lines=7))


def test_save_mkpts_as_txt(tmp_path):
    """The matcher's do_viz_matches and save_dir: matches.png and the
    keypoint files, whose text equals the JAX matcher's (same putatives,
    no verification)."""
    img0, img1 = shifted_pair()
    opts = dict(OPTIONS, max_keypoints=256)
    m = LightGlueMatcher(opts, device="cpu")
    jm = JLightGlueMatcher(opts)
    m.match(img0, img1, geometric_verification=GeometricVerification.NONE,
            do_viz_matches=True, save_dir=str(tmp_path / "port"))
    jm.match(img0, img1, geometric_verification=JGV.NONE,
             do_viz_matches=True, save_dir=str(tmp_path / "jax"))
    assert len(m.mkpts0) > 50
    for name in ("keypoints_0.txt", "keypoints_1.txt"):
        got = (tmp_path / "port" / name).read_text()
        assert got == (tmp_path / "jax" / name).read_text()
        assert got.startswith("# x,y\n")
    mosaic = cv2.imread(str(tmp_path / "port" / "matches.png"))
    assert mosaic.shape == (img0.shape[0], 2 * img0.shape[1], 3)


@pytest.fixture(scope="module")
def season(tmp_path_factory):
    root = tmp_path_factory.mktemp("season")
    cfg = StereoSeason(480, 640, 640.0).write(root, n_epochs=3,
                                              max_keypoints=256,
                                              options=OPTIONS)
    cfg["proc"].update(do_homography_warping=True, save_checkpoints=False,
                       do_ba=False, do_recovery=False)
    cfg["other"]["do_viz"] = True
    return root, cfg


def _cfg(season, name):
    root, cfg = season
    cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in cfg.items()}
    cfg["paths"]["results_dir"] = str(root / name)
    return cfg


def test_pipeline_warping_and_viz(season):
    pipe = Pipeline(_cfg(season, "port"), device="cpu")
    eps = list(pipe.run())
    JPipeline(JDotDict.wrap(_cfg(season, "jax"))).run()
    root = season[0]
    for name in ("port", "jax"):
        warped = sorted((root / name / "warped").glob("warped_*.jpg"))
        assert [p.name for p in warped] == [
            f"warped_{i:03d}.jpg" for i in range(3)]
    # each package warps with its own cameras (without the BA their RO
    # consensus differs by ~0.2 degrees, a 2-px shift of the texture):
    # the images are held by coverage, the warp itself on equal inputs
    # above
    for i in range(3):
        got, want = (cv2.imread(str(root / n / "warped" / f"warped_{i:03d}"
                                                            ".jpg"))
                     for n in ("port", "jax"))
        assert got.shape == want.shape == (480, 640, 3)
        assert abs((got > 0).mean() - (want > 0).mean()) <= 0.01
        if i == 0:
            assert (got > 0).mean() > 0.5
    for e in eps:
        files = {p.name for p in Path(e.epoch_dir).iterdir()}
        assert {"matches.png", "keypoints_0.txt", "keypoints_1.txt"} <= files
