"""Pinhole camera with host-numpy state.

Counterpart of `icepy4d_tpu/core/camera.py`: the same state (K, OpenCV
distortion, 4x4 world->camera extrinsics, image size), constructors,
derived quantities (R, t, pose, C, P, Euler angles) and immutable
updates, as a frozen dataclass. A JAX `Camera`'s numpy leaves carry
across as they are:
`Camera.create(K=cam.K, dist=cam.dist, extrinsics=cam.extrinsics, ...)`.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from icepy4d_tpu_torch.ops import geometry_np as geom_np


@dataclasses.dataclass(frozen=True, eq=False)
class Camera:
    K: np.ndarray           # (3, 3) intrinsics
    dist: np.ndarray        # (8,) k1, k2, p1, p2, k3, k4, k5, k6 (zero-padded)
    extrinsics: np.ndarray  # (4, 4) world -> camera
    width: int = 0
    height: int = 0

    # -- constructors ------------------------------------------------------
    @classmethod
    def create(cls, width: int = 0, height: int = 0, K=None, dist=None,
               extrinsics=None, calib_path: str | Path | None = None,
               ) -> "Camera":
        if calib_path is not None:
            from icepy4d_tpu_torch.core.calibration import Calibration

            return Calibration(calib_path).to_camera()
        if K is None:
            # rough default: focal = image width
            f = float(width) if width else 1.0
            K = np.array([[f, 0.0, width / 2.0], [0.0, f, height / 2.0],
                          [0, 0, 1]], np.float32)
        K = np.asarray(K, np.float32).reshape(3, 3)
        dist = np.zeros((8,), np.float32) if dist is None \
            else geom_np.pad_distortion(np.asarray(dist, np.float32))
        extrinsics = np.eye(4, dtype=np.float32) if extrinsics is None \
            else np.asarray(extrinsics, np.float32).reshape(4, 4)
        return cls(K=K, dist=dist, extrinsics=extrinsics, width=int(width),
                   height=int(height))

    def replace(self, **changes) -> "Camera":
        return dataclasses.replace(self, **changes)

    # -- derived quantities ------------------------------------------------
    @property
    def R(self) -> np.ndarray:
        return self.extrinsics[:3, :3]

    @property
    def t(self) -> np.ndarray:
        return self.extrinsics[:3, 3]

    @property
    def pose(self) -> np.ndarray:
        """Camera -> world 4x4 (inverse of extrinsics)."""
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = self.R.T
        pose[:3, 3] = -self.R.T @ self.t
        return pose

    @property
    def C(self) -> np.ndarray:
        """Projection centre in world coords."""
        return -self.R.T @ self.t

    @property
    def P(self) -> np.ndarray:
        """3x4 projection matrix K [R | t]."""
        return self.K @ self.extrinsics[:3, :]

    @property
    def euler_angles(self) -> tuple:
        """(omega, phi, kappa) of the camera-to-world rotation."""
        return tuple(np.asarray(a)
                     for a in geom_np.euler_from_matrix(self.R.T))

    # -- immutable updates -------------------------------------------------
    def update_K(self, K) -> "Camera":
        return self.replace(K=np.asarray(K, np.float32).reshape(3, 3))

    def update_dist(self, dist) -> "Camera":
        return self.replace(dist=geom_np.pad_distortion(dist))

    def update_extrinsics(self, extrinsics) -> "Camera":
        return self.replace(
            extrinsics=np.asarray(extrinsics, np.float32).reshape(4, 4))

    def update_from_pose(self, pose) -> "Camera":
        return self.update_extrinsics(Camera.pose_to_extrinsics(pose))

    @staticmethod
    def pose_to_extrinsics(pose) -> np.ndarray:
        pose = np.asarray(pose, np.float32).reshape(4, 4)
        R, C = pose[:3, :3], pose[:3, 3]
        ext = np.eye(4, dtype=np.float32)
        ext[:3, :3] = R.T
        ext[:3, 3] = -R.T @ C
        return ext

    @staticmethod
    def extrinsics_to_pose(extrinsics) -> np.ndarray:
        return Camera.pose_to_extrinsics(extrinsics)  # an involution

    @staticmethod
    def Rt_to_extrinsics(R, t) -> np.ndarray:
        ext = np.eye(4, dtype=np.float32)
        ext[:3, :3] = np.asarray(R, np.float32)
        ext[:3, 3] = np.asarray(t, np.float32).reshape(3)
        return ext

    # -- compute -----------------------------------------------------------
    def project_point(self, points_3d) -> np.ndarray:
        """World (N, 3) -> pixel (N, 2), full distortion model."""
        pts = np.asarray(points_3d, np.float32).reshape(-1, 3)
        return geom_np.project_points(pts, self.K, self.extrinsics,
                                      self.dist)

    def undistort_points(self, points_2d) -> np.ndarray:
        pts = np.asarray(points_2d, np.float32).reshape(-1, 2)
        return geom_np.undistort_points(pts, self.K, self.dist)

    def factor_P(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Decompose P into K, R, t by an RQ decomposition, in float64
        (the precision a 3x3 RQ of large-focal matrices needs)."""
        P = np.asarray(self.P, np.float64)
        M = P[:, :3]
        # RQ through the QR of the reversed, transposed matrix
        Q, R_ = np.linalg.qr(np.flip(M, axis=0).T)
        Rq = np.flip(np.flip(R_.T, axis=0), axis=1)
        Qq = np.flip(Q.T, axis=0)
        # signs that make the diagonal of K positive
        s = np.sign(np.diag(Rq))
        K = Rq * s[None, :]
        R = Qq * s[:, None]
        t = np.linalg.solve(K, P[:, 3])
        return K / K[2, 2], R, t
