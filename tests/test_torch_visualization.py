"""The port's plots (`visualization/visualization.py`) ==
icepy4d_tpu's: cv2 renderings equal pixel for pixel, matplotlib figures
saved to files of the same size, the geometric helpers (camera
pyramids, colour maps) equal."""

from datetime import datetime
from types import SimpleNamespace

import numpy as np
import pytest

import icepy4d_tpu.visualization as JV
from icepy4d_tpu.core import Camera as JCamera
from icepy4d_tpu.core import Features as JFeatures
import icepy4d_tpu_torch.visualization as PV
from icepy4d_tpu_torch.core import Camera, Features

K = np.array([[150.0, 0, 80], [0, 150.0, 60], [0, 0, 1]])
E = np.eye(4)
E[:3, 3] = [0.5, -0.2, 1.0]


def image(color=False):
    rng = np.random.default_rng(0)
    im = rng.integers(0, 256, (120, 160, 3) if color else (120, 160),
                      dtype=np.uint8)
    return im


def points(n=12, seed=1):
    return np.random.default_rng(seed).uniform([5, 5], [150, 110], (n, 2))


def cams(mod_cam):
    return mod_cam.create(width=160, height=120, K=K, extrinsics=E)


def cv2_cases(tmp_path):
    lines = np.c_[np.full(5, 0.01), np.ones(5), -np.arange(5) * 20 - 10]
    return {
        "plot_matches_cv2": lambda m: m.plot_matches_cv2(
            image(), image(True), points(), points(seed=2) + 0.4),
        "plot_points_cv2": lambda m: m.plot_points_cv2(
            image(), points(), with_ids=True, color=(0, 255, 0)),
        "draw_epip_lines": lambda m: np.concatenate(m.draw_epip_lines(
            image(), image(), lines, points(5), points(5, seed=3)), 1),
        "imshow_cv2": lambda m: m.imshow_cv2(image(True), resize_to=80),
    }


@pytest.mark.parametrize("name", ["plot_matches_cv2", "plot_points_cv2",
                                  "draw_epip_lines", "imshow_cv2"])
def test_cv2_plots(name, tmp_path):
    case = cv2_cases(tmp_path)[name]
    np.testing.assert_array_equal(case(PV), case(JV))


def test_plot_matches_epoch(tmp_path):
    out = {}
    for tag, mod, feat in (("j", JV, JFeatures), ("p", PV, Features)):
        ep = SimpleNamespace(
            images={c: SimpleNamespace(value=image(c == "cam2"))
                    for c in ("cam1", "cam2")},
            features={"cam1": feat.from_numpy(points()),
                      "cam2": feat.from_numpy(points(seed=2))},
            date_str=datetime(2022, 7, 28).strftime("%Y_%m_%d"))
        out[tag] = mod.plot_matches_epoch(ep, tmp_path / tag)
    assert out["p"].name == out["j"].name
    assert out["p"].read_bytes() == out["j"].read_bytes()


def mpl_cases(tmp_path):
    csv = tmp_path / "cams.csv"
    csv.write_text("epoch,cam_a_f,cam_a_omega,cam_a_phi,cam_a_kappa\n"
                   "0,6000,0.1,0.2,0.3\n1,6001,0.15,0.25,0.2\n")
    xyz = np.random.default_rng(4).uniform(-1, 1, (300, 3))
    rgb = np.random.default_rng(5).integers(0, 256, (300, 3))

    def pair(m):
        fig, ax = m.plot_image_pair(image(), image(True))
        m.plot_keypoints(points(), points(seed=2), axes=ax)
        m.draw_matches(ax, points(), points(seed=2), color="r")
        return fig

    return {
        "plot_matches": lambda m, p: m.plot_matches(
            image(), image(), points(), points(seed=2), path=p),
        "image_pair": lambda m, p: pair(m).savefig(p, dpi=100),
        "plot_points": lambda m, p: m.plot_points(image(), points(),
                                                  title="t", path=p),
        "plot_features": lambda m, p: m.plot_features(
            image(), (JFeatures if m is JV else Features).from_numpy(
                points()), path=p),
        "plot_projections": lambda m, p: m.plot_projections(
            xyz + [0, 0, 3], cams(JCamera if m is JV else Camera), image(),
            path=p),
        "plot_projection_error": lambda m, p: m.plot_projection_error(
            points(), points() + 0.5, image(), path=p),
        "display_point_cloud": lambda m, p: m.display_point_cloud(
            xyz, rgb, cameras=[cams(JCamera if m is JV else Camera)],
            path=p, view=(20, 30)),
        "display_pc_inliers": lambda m, p: m.display_pc_inliers(
            xyz, np.arange(250), path=p),
        "plot_camera_time_series": lambda m, p: m.plot_camera_time_series(
            csv, path=p),
        "focal_length": lambda m, p: m.make_focal_length_variation_plot(
            {"a": [6000, 6001, 5999]}, path=p),
        "camera_angles": lambda m, p: m.make_camera_angles_plot(
            {"a": {"omega": [0.1, 0.2], "phi": [0.0, 0.1],
                   "kappa": [1.0, 1.1]}}, path=p),
        "plot_feature": lambda m, p: m.plot_feature(image(), (50, 60),
                                                    zoom=20, path=p),
    }


@pytest.mark.parametrize("name", [
    "plot_matches", "image_pair", "plot_points", "plot_features",
    "plot_projections", "plot_projection_error", "display_point_cloud",
    "display_pc_inliers", "plot_camera_time_series", "focal_length",
    "camera_angles", "plot_feature"])
def test_matplotlib_plots(name, tmp_path):
    case = mpl_cases(tmp_path)[name]
    case(JV, tmp_path / "j.png")
    case(PV, tmp_path / "p.png")
    assert (tmp_path / "p.png").stat().st_size == \
        (tmp_path / "j.png").stat().st_size


def test_geometry_helpers():
    for a, b in zip(JV.make_camera_pyramid(cams(JCamera), 2.0),
                    PV.make_camera_pyramid(cams(Camera), 2.0)):
        np.testing.assert_allclose(b, a, atol=1e-6)
    np.testing.assert_array_equal(PV.pose2pyramid(np.linalg.inv(E)),
                                  JV.pose2pyramid(np.linalg.inv(E)))
    v = np.linspace(-1, 3, 17)
    np.testing.assert_array_equal(PV.get_colors(v, "jet", 0, 2),
                                  JV.get_colors(v, "jet", 0, 2))
