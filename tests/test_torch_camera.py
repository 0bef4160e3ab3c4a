"""Port Camera and calibration files against icepy4d_tpu's on the same
numpy state (the JAX Camera's leaves carried across as they are)."""

import numpy as np
import pytest

from icepy4d_tpu.core.calibration import Calibration as JCalibration
from icepy4d_tpu.core.camera import Camera as JCamera
from icepy4d_tpu_torch.core import Calibration, Camera
from icepy4d_tpu_torch.ops import geometry_np
from torch_port_inputs import rotation_zyx

RNG = np.random.default_rng(5)


def _camera_pair():
    K = np.array([[3000.0, 2.5, 3006.0], [0, 3010.0, 2004.0], [0, 0, 1]],
                 np.float32)
    E = np.eye(4, dtype=np.float32)
    E[:3, :3] = rotation_zyx(0.3, -0.1, 0.05)
    E[:3, 3] = [1.5, -0.4, 12.0]
    dist = np.array([-0.08, 0.05, 0.001, -0.0007, 0.01], np.float32)
    jcam = JCamera.create(width=6012, height=4008, K=K, dist=dist,
                          extrinsics=E)
    cam = Camera.create(width=jcam.width, height=jcam.height, K=jcam.K,
                        dist=jcam.dist, extrinsics=jcam.extrinsics)
    return cam, jcam


def test_camera_state_and_properties():
    cam, jcam = _camera_pair()
    for name in ("K", "dist", "extrinsics", "R", "t", "pose", "C", "P"):
        np.testing.assert_allclose(getattr(cam, name),
                                   np.asarray(getattr(jcam, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(cam.euler_angles, jcam.euler_angles,
                               atol=1e-7)
    assert (cam.width, cam.height) == (jcam.width, jcam.height)
    for got, ref in zip(cam.factor_P(), jcam.factor_P()):
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)


def test_camera_project_and_undistort():
    cam, jcam = _camera_pair()
    X = np.c_[RNG.uniform(-5, 5, (200, 2)), RNG.uniform(-4, 30, 200)]
    np.testing.assert_allclose(cam.project_point(X), jcam.project_point(X),
                               rtol=1e-6, atol=1e-3)
    uv = RNG.uniform([0, 0], [6012, 4008], (200, 2))
    np.testing.assert_allclose(cam.undistort_points(uv),
                               jcam.undistort_points(uv), atol=1e-3)


def test_camera_updates_are_immutable():
    cam, jcam = _camera_pair()
    pose = np.linalg.inv(cam.extrinsics)
    pose[:3, 3] += [0.5, 0.0, -1.0]
    moved = cam.update_from_pose(pose)
    np.testing.assert_allclose(moved.extrinsics,
                               jcam.update_from_pose(pose).extrinsics,
                               atol=1e-5)
    assert moved is not cam and not np.allclose(moved.C, cam.C)
    np.testing.assert_array_equal(cam.update_dist([0.1, 0.2]).dist,
                                  jcam.update_dist([0.1, 0.2]).dist)
    np.testing.assert_array_equal(cam.update_K(2 * cam.K).K,
                                  jcam.update_K(2 * jcam.K).K)
    np.testing.assert_allclose(
        Camera.extrinsics_to_pose(cam.extrinsics),
        JCamera.extrinsics_to_pose(jcam.extrinsics), atol=1e-5)
    np.testing.assert_array_equal(
        Camera.Rt_to_extrinsics(cam.R, cam.t), cam.extrinsics)
    with pytest.raises(AttributeError):
        cam.K = cam.K


def test_geometry_np_rotations():
    from icepy4d_tpu.ops import geometry_np as jgeometry_np

    for rvec in ([0.0, 0.0, 0.0], [0.2, -0.5, 0.1], [np.pi, 0.0, 0.0]):
        R = geometry_np.rodrigues_to_matrix(rvec)
        np.testing.assert_array_equal(R, jgeometry_np.rodrigues_to_matrix(rvec))
        np.testing.assert_array_equal(geometry_np.matrix_to_rodrigues(R),
                                      jgeometry_np.matrix_to_rodrigues(R))


CALIB_TXT = {
    15: "6012 4008 6000 0 3006 0 6000 2004 0 0 1 -0.05 0.02 0.001 -0.001",
    16: "6012,4008,6000,0,3006,0,6000,2004,0,0,1,-0.05,0.02,0.001,-0.001,0.003",
    19: ("6012 4008 6000 0 3006 0 6000 2004 0 0 1 -0.05 0.02 0.001 -0.001 "
         "0.003 0.0001 -0.0002 0.0003"),
}

AGISOFT_XML = """<?xml version="1.0"?>
<calibration>
  <width>6012</width><height>4008</height><f>6005.5</f>
  <cx>-12.5</cx><cy>7.25</cy><b1>1.5</b1>
  <k1>-0.05</k1><k2>0.02</k2><k3>0.003</k3><p1>0.001</p1><p2>-0.001</p2>
</calibration>
"""

OPENCV_XML = """<?xml version="1.0"?>
<opencv_storage>
  <image_Width>6012</image_Width><image_Height>4008</image_Height>
  <Camera_Matrix type_id="opencv-matrix"><rows>3</rows><cols>3</cols>
    <dt>d</dt><data>6000. 0. 3006. 0. 6000. 2004. 0. 0. 1.</data>
  </Camera_Matrix>
  <Distortion_Coefficients type_id="opencv-matrix"><rows>5</rows><cols>1</cols>
    <dt>d</dt><data>-0.05 0.02 0.001 -0.001 0.003</data>
  </Distortion_Coefficients>
</opencv_storage>
"""


@pytest.mark.parametrize("name,text", [
    ("cam15.txt", CALIB_TXT[15]), ("cam16.txt", CALIB_TXT[16]),
    ("cam19.txt", CALIB_TXT[19]), ("agisoft.xml", AGISOFT_XML),
    ("opencv.xml", OPENCV_XML)])
def test_calibration_files(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    got, ref = Calibration(path), JCalibration(path)
    assert (got.width, got.height) == (ref.width, ref.height)
    np.testing.assert_array_equal(got.K, ref.K)
    np.testing.assert_array_equal(got.dist, ref.dist)
    cam, jcam = got.to_camera(), ref.to_camera()
    np.testing.assert_array_equal(cam.K, jcam.K)
    np.testing.assert_array_equal(cam.dist, jcam.dist)
    np.testing.assert_array_equal(Camera.create(calib_path=path).dist,
                                  jcam.dist)


def test_calibration_rejects_bad_field_count(tmp_path):
    path = tmp_path / "bad.txt"
    path.write_text("6012 4008 6000 0 3006")
    with pytest.raises(ValueError, match="fields"):
        Calibration(path)
