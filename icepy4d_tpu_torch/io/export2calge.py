"""CALGE (geodetic least-squares adjustment) export (counterpart of
`icepy4d_tpu/io/export2calge.py`).

Keypoint image coordinates per camera in CALGE's fixed-width format,
optionally in the xi-eta photo frame (origin at the image centre, xi
right, eta up, in microns), and the approximate 3D coordinates block.
"""

from __future__ import annotations

import logging
from pathlib import Path

logger = logging.getLogger("icepy4d_tpu_torch")


def export_keypoints_for_calge(
    filename,
    features: dict,
    images: dict,
    image_size: tuple | None = None,
    pixel_size_micron: float | None = None,
) -> Path:
    """features/images: {cam_name: Features / Image}. image_size (h, w)
    required when pixel_size_micron is given."""
    filename = Path(filename)
    cams = list(features.keys())
    with open(filename, "w") as f:
        if pixel_size_micron is not None:
            if image_size is None:
                raise ValueError("image_size required for xi-eta export")
            f.write("image_name, feature_id, xi, eta\n")
        else:
            f.write("image_name, feature_id, x, y\n")
        for cam in cams:
            name = images[cam].name if cam in images else cam
            f.write(f"{name}\n")
            for fid, (x, y) in enumerate(features[cam].kpts_to_numpy()):
                if pixel_size_micron is not None:
                    h, w = image_size
                    xi = (x - w / 2) * pixel_size_micron
                    eta = (h / 2 - y) * pixel_size_micron
                    f.write(f"{fid:05}{xi:10.1f}{eta:15.1f} \n")
                else:
                    f.write(f"{fid:05}{x:10.1f}{y:15.1f} \n")
            f.write("-99\n")
    logger.info("CALGE keypoints written to %s", filename)
    return filename


def export_points3D_for_calge(filename, points) -> Path:
    """Approximate 3D coordinates block."""
    filename = Path(filename)
    xyz = points.to_numpy()
    ids = points.track_ids_to_numpy()
    with open(filename, "w") as f:
        for tid, (x, y, z) in zip(ids, xyz):
            f.write(f"{int(tid):05}{x:15.4f}{y:15.4f}{z:15.4f}\n")
        f.write("-99\n")
    return filename
