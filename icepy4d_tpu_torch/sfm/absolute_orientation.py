"""Absolute orientation (georeferencing).

Counterpart of `icepy4d_tpu/sfm/absolute_orientation.py`:
`AbsoluteOrientation` estimates the 7-parameter Helmert similarity that
maps the photogrammetric model onto surveyed world coordinates (the
host float64 Umeyama solve, optionally refined by Gauss-Newton), with
the camera centres as extra correspondences, and re-bases points and
cameras on it; `pose_from_known_center` orients a camera whose centre
is surveyed from two or more target bearings; `SpaceResection` resects
one camera by DLT-PnP RANSAC on the device. Everything else runs on the
host in float64 around centroid-relative coordinates: surveyed
coordinates are UTM-scale, where float32 keeps about half a metre.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from icepy4d_tpu_torch.core.camera import Camera
from icepy4d_tpu_torch.device import full_f32_matmul, resolve_device
from icepy4d_tpu_torch.ops import geometry_np as geom_np
from icepy4d_tpu_torch.ops import transforms as tf
from icepy4d_tpu_torch.ops.buckets import pad_bucket
from icepy4d_tpu_torch.ops.ransac import ransac_pnp

logger = logging.getLogger("icepy4d_tpu_torch")


class SpaceResection:
    """Single-camera pose from 3D-2D correspondences: DLT-PnP RANSAC
    (`ops.ransac.ransac_pnp`) on the undistorted observations.
    device: None runs on the card (and raises without one). After
    `estimate`, `inliers` holds the consensus as an (n,) bool array over
    the given points."""

    def __init__(self, camera: Camera, device=None) -> None:
        self.camera = camera
        self.device = resolve_device(device)
        self.inliers: np.ndarray | None = None

    def estimate(self, image_points: np.ndarray, object_points: np.ndarray,
                 reprojection_error: float = 3.0, seed: int = 0) -> Camera:
        """The camera with the resected pose; unchanged (with a warning)
        when fewer than 4 points are inliers. The object points are
        re-centred on their centroid in float64 (surveyed coordinates are
        UTM-scale) and the translation is moved back after the solve.
        Points are padded to the JAX package's bucket (at least 8 rows)
        and masked, so both draw their samples over one shape."""
        p2 = np.asarray(image_points, np.float32).reshape(-1, 2)
        p3 = np.asarray(object_points, np.float64).reshape(-1, 3)
        n = p2.shape[0]
        shift = p3.mean(axis=0) if n else np.zeros(3)
        cap = pad_bucket(n, floor=8)
        pts2d = np.zeros((cap, 2), np.float32)
        pts3d = np.zeros((cap, 3), np.float32)
        pts2d[:n] = self.camera.undistort_points(p2)
        pts3d[:n] = p3 - shift
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad(), full_f32_matmul():
            R, t, inliers = ransac_pnp(
                gen, torch.from_numpy(pts3d).to(dev),
                torch.from_numpy(pts2d).to(dev),
                torch.as_tensor(np.asarray(self.camera.K, np.float32),
                                device=dev),
                torch.arange(cap, device=dev) < n,
                threshold_px=float(reprojection_error))
        self.inliers = inliers[:n].cpu().numpy()
        n_inl = int(self.inliers.sum())
        if n_inl < 4:
            logger.warning("Space resection failed: %d inliers", n_inl)
            return self.camera
        logger.info("Space resection succeeded. Inliers: %d/%d", n_inl, cap)
        R = R.cpu().numpy().astype(np.float64)
        t = t.cpu().numpy().astype(np.float64) - R @ shift
        self.camera = self.camera.update_extrinsics(
            Camera.Rt_to_extrinsics(R, t))
        return self.camera


class AbsoluteOrientation:
    """v0 = model coordinates (given, or triangulated from image points),
    v1 = world coordinates; camera centres, when given, are appended as
    extra correspondences."""

    def __init__(self, cameras: tuple[Camera, ...],
                 points3d_final: np.ndarray,
                 points3d_orig: np.ndarray | None = None,
                 image_points: tuple[np.ndarray, ...] | None = None,
                 camera_centers_world: tuple[np.ndarray, ...] | None = None,
                 device=None) -> None:
        self.cameras = list(cameras)
        self.device = device
        if points3d_final is None or points3d_final.shape[1] != 3:
            raise ValueError("points3d_final must be (n, 3) world coordinates")
        self.v1 = np.asarray(points3d_final, np.float64)
        if points3d_orig is not None:
            self.v0 = np.asarray(points3d_orig, np.float64)
        elif image_points is not None:
            self.v0 = self.triangulate_image_points(image_points)
        else:
            raise ValueError("provide points3d_orig or image_points")
        self.tform: np.ndarray | None = None
        if camera_centers_world is not None:
            self.add_camera_centers_to_points(camera_centers_world)

    def add_camera_centers_to_points(self, camera_centers_world) -> None:
        """Append each camera's model-frame centre to v0 and its surveyed
        world coordinates to v1."""
        self.v0 = np.concatenate(
            [self.v0] + [np.asarray(cam.C, np.float64).reshape(1, 3)
                         for cam in self.cameras])
        self.v1 = np.concatenate(
            [self.v1] + [np.asarray(c, np.float64).reshape(1, 3)
                         for c in camera_centers_world])

    def triangulate_image_points(self, image_points) -> np.ndarray:
        from icepy4d_tpu_torch.sfm.triangulation import Triangulate

        t = Triangulate(self.cameras, list(image_points), device=self.device)
        return np.asarray(t.triangulate_two_views(), np.float64)

    def _centered(self):
        c0 = self.v0.mean(axis=0)
        c1 = self.v1.mean(axis=0)
        return c0, c1, self.v0 - c0, self.v1 - c1

    @staticmethod
    def _uncenter(Tc: np.ndarray, c0, c1) -> np.ndarray:
        """Centred-frame similarity -> full transform, composed in
        float64: T = Trans(c1) @ Tc @ Trans(-c0)."""
        T = np.eye(4)
        M = np.asarray(Tc[:3, :3], np.float64)
        T[:3, :3] = M
        T[:3, 3] = c1 + np.asarray(Tc[:3, 3], np.float64) - M @ c0
        return T

    def estimate_transformation_linear(self, estimate_scale: bool = True
                                       ) -> np.ndarray:
        """Umeyama SVD similarity v1 ~= T v0."""
        c0, c1, v0c, v1c = self._centered()
        Tc = np.asarray(geom_np.similarity_from_points(
            v0c, v1c, with_scale=estimate_scale), np.float64)
        self.tform = self._uncenter(Tc, c0, c1)
        return self.tform

    def estimate_transformation_least_squares(
            self, uncertainty: np.ndarray | None = None) -> np.ndarray:
        """Gauss-Newton refinement of the 7 Helmert parameters in float32
        on the centred points, weighted by 1 / uncertainty."""
        if self.tform is None:
            self.estimate_transformation_linear()

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32))

        weights = None if uncertainty is None \
            else f32(1.0 / np.asarray(uncertainty))
        c0, c1, v0c, v1c = self._centered()
        M = np.asarray(self.tform[:3, :3], np.float64)
        Tc0 = np.eye(4)
        Tc0[:3, :3] = M
        Tc0[:3, 3] = np.asarray(self.tform[:3, 3], np.float64) - c1 + M @ c0
        Tc = tf.refine_similarity_gauss_newton(
            f32(Tc0), f32(v0c), f32(v1c), weights=weights)
        self.tform = self._uncenter(Tc.numpy().astype(np.float64), c0, c1)
        return self.tform

    def extract_params_from_T(self, T: np.ndarray | None = None) -> dict:
        """T -> dict(rx, ry, rz, tx, ty, tz, m)."""
        if T is None:
            T = self.tform
        M = np.asarray(T[:3, :3], np.float64)
        m = float(np.cbrt(np.linalg.det(M)))
        ax, ay, az = (float(a) for a in geom_np.euler_from_matrix(M / m))
        return {"rx": ax, "ry": ay, "rz": az, "tx": float(T[0, 3]),
                "ty": float(T[1, 3]), "tz": float(T[2, 3]), "m": m}

    def apply_transformation(self, T: np.ndarray | None = None,
                             points3d: np.ndarray | None = None,
                             camera: Camera | None = None) -> np.ndarray:
        """Transform the points and re-base every camera pose, removing
        the scale from the rotation so that extrinsics stay rigid."""
        if T is None:
            T = self.tform
        if points3d is None:
            points3d = self.v1
        T64 = np.asarray(T, np.float64)
        self.v1 = np.asarray(points3d, np.float64) @ T64[:3, :3].T \
            + T64[:3, 3]

        def rebase(cam: Camera) -> Camera:
            pose = T64 @ np.asarray(cam.pose, np.float64)
            pose[:3, :3] = pose[:3, :3] / np.cbrt(np.linalg.det(pose[:3, :3]))
            return cam.update_extrinsics(Camera.pose_to_extrinsics(pose))

        if camera is not None:
            return rebase(camera)
        self.cameras = [rebase(c) for c in self.cameras]
        return self.v1


Absolute_orientation = AbsoluteOrientation
Space_resection = SpaceResection


def pose_from_known_center(camera: Camera, center: np.ndarray,
                           image_points: np.ndarray,
                           object_points: np.ndarray) -> Camera:
    """Camera pose from two or more target bearings when its centre is
    surveyed: the rotation is the Kabsch alignment of the undistorted
    observation bearings (camera frame) with the directions X - C (world
    frame), in float64."""
    center = np.asarray(center, np.float64).reshape(3)
    p2 = np.asarray(image_points, np.float64).reshape(-1, 2)
    X = np.asarray(object_points, np.float64).reshape(-1, 3)
    und = np.asarray(camera.undistort_points(np.asarray(p2, np.float32)),
                     np.float64).reshape(-1, 2)
    K = np.asarray(camera.K, np.float64)
    xn = (und - [K[0, 2], K[1, 2]]) / [K[0, 0], K[1, 1]]
    b_cam = np.concatenate([xn, np.ones((len(xn), 1))], axis=1)
    b_cam /= np.linalg.norm(b_cam, axis=1, keepdims=True)
    b_w = X - center
    b_w /= np.linalg.norm(b_w, axis=1, keepdims=True)
    U, _s, Vt = np.linalg.svd(b_cam.T @ b_w)
    R = U @ np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    E = np.eye(4)
    E[:3, :3] = R
    E[:3, 3] = -R @ center
    return Camera.create(width=camera.width, height=camera.height,
                         K=np.asarray(camera.K), dist=np.asarray(camera.dist),
                         extrinsics=E.astype(np.float32))
