"""Camera calibration files.

Counterpart of `icepy4d_tpu/core/calibration.py`. Reads the OpenCV-style
txt format, one whitespace- or comma-separated row
  w h fx 0 cx 0 fy cy 0 0 1 k1 k2 p1 p2 [k3 [k4 k5 k6]]
(15, 16 or 19 fields), and Agisoft or OpenCV XML files.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np


def read_opencv_calibration(path: str | Path) -> tuple[int, int, np.ndarray, np.ndarray]:
    """Parse txt calibration -> (width, height, K 3x3, dist (n,))."""
    text = Path(path).read_text().strip()
    fields = [float(x) for x in re.split(r"[,\s]+", text) if x]
    if len(fields) not in (15, 16, 19):
        raise ValueError(
            f"Calibration file {path} has {len(fields)} fields; "
            "expected 15 (4 dist), 16 (5 dist) or 19 (8 dist)."
        )
    w, h = int(fields[0]), int(fields[1])
    K = np.array(fields[2:11], np.float32).reshape(3, 3)
    dist = np.array(fields[11:], np.float32)
    return w, h, K, dist


def read_xml_calibration(path: str | Path) -> tuple[int, int, np.ndarray, np.ndarray]:
    """Parse Agisoft/OpenCV XML calibration (f, cx, cy, k1..k3, p1, p2)."""
    root = ET.parse(str(path)).getroot()

    def grab(tag: str, default: float = 0.0) -> float:
        el = root.find(tag)
        return float(el.text) if el is not None and el.text else default

    if root.find("f") is not None:
        # Agisoft convention: cx/cy are offsets from the image centre.
        w = int(grab("width"))
        h = int(grab("height"))
        f = grab("f")
        cx = w / 2.0 + grab("cx")
        cy = h / 2.0 + grab("cy")
        K = np.array([[f, grab("b1"), cx], [0, f, cy], [0, 0, 1]], np.float32)
        dist = np.array(
            [grab("k1"), grab("k2"), grab("p1"), grab("p2"), grab("k3")],
            np.float32,
        )
    else:
        # OpenCV FileStorage layout: <image_Width>/<image_Height>,
        # Camera_Matrix/data,
        # Distortion_Coefficients/data (k1 k2 p1 p2 [k3 ...])
        w = int(grab("image_Width", grab("width")))
        h = int(grab("image_Height", grab("height")))
        cam = root.find("Camera_Matrix/data")
        if cam is None:
            raise ValueError(f"{path}: no Camera_Matrix/data element")
        K = np.array([float(x) for x in cam.text.split()],
                     np.float32).reshape(3, 3)
        dc = root.find("Distortion_Coefficients/data")
        dist = (np.array([float(x) for x in dc.text.split()], np.float32)
                if dc is not None and dc.text
                else np.zeros(5, np.float32))
    return w, h, K, dist


class Calibration:
    """Calibration loader; `to_camera()` builds a Camera."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        if self.path.suffix.lower() == ".xml":
            self.width, self.height, self.K, self.dist = read_xml_calibration(path)
        else:
            self.width, self.height, self.K, self.dist = read_opencv_calibration(path)

    def to_camera(self):
        from icepy4d_tpu_torch.core.camera import Camera

        return Camera.create(
            width=self.width, height=self.height, K=self.K, dist=self.dist
        )
