"""Relative orientation of a stereo pair.

Counterpart of `icepy4d_tpu/sfm/two_view_geometry.py`: the pose of
camera 1 relative to camera 0 from matched keypoints (essential RANSAC
on the device), optionally scaled by a world baseline, then chained onto
camera 0's world pose.
"""

from __future__ import annotations

import logging

import numpy as np

from icepy4d_tpu_torch.core.camera import Camera
from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.sfm.geometry import estimate_pose

logger = logging.getLogger("icepy4d_tpu_torch")


class RelativeOrientation:
    """cameras: [cam0, cam1] (cam0's extrinsics required); features:
    [kpts0 (n, 2), kpts1 (n, 2)] matched pixel coordinates. device: None
    runs the RANSAC on the card (and raises without one)."""

    def __init__(self, cameras: list[Camera], features: list[np.ndarray],
                 device=None) -> None:
        self.cameras = list(cameras)
        self.features = features
        self.device = resolve_device(device)

    def estimate_pose(self, threshold: float = 1.0,
                      confidence: float = 0.9999,
                      scale_factor: float | None = None,
                      scores: np.ndarray | None = None,
                      F_hint: np.ndarray | None = None) -> np.ndarray:
        """Estimate the relative pose and replace cameras[1]; returns the
        inlier mask over the input matches. R, t map cam0-frame
        coordinates to cam1's; cam1's world pose = cam0.pose @ relpose."""
        if self.cameras[0].extrinsics is None:
            raise ValueError("camera 0 extrinsics required")
        out = estimate_pose(
            self.features[0], self.features[1],
            np.asarray(self.cameras[0].K), np.asarray(self.cameras[1].K),
            thresh=threshold, conf=confidence, scores=scores, F_hint=F_hint,
            device=self.device)
        if out is None:
            raise ValueError("Not enough correspondences (<5) for relative "
                             "pose")
        R, t, valid = out
        logger.info("Relative Orientation - valid points: %d/%d",
                    valid.sum(), len(valid))
        if scale_factor is not None:
            t = t * scale_factor
        else:
            logger.warning("No scale factor provided; model up to scale.")
        cam1 = self.cameras[1].update_extrinsics(
            Camera.Rt_to_extrinsics(R, t))
        cam1_to_world = np.asarray(self.cameras[0].pose) @ np.asarray(
            cam1.pose)
        self.cameras[1] = cam1.update_extrinsics(
            Camera.pose_to_extrinsics(cam1_to_world))
        return valid

    def get_scale_factor_from_baseline(self, baseline_world: float) -> float:
        """World baseline / model baseline."""
        baseline = float(np.linalg.norm(
            np.asarray(self.cameras[0].C) - np.asarray(self.cameras[1].C)))
        return baseline_world / baseline
