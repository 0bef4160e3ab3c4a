"""Match plotting with cv2 (counterpart of
`icepy4d_tpu/visualization/visualization.py::plot_matches_cv2`)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _to_bgr(im) -> np.ndarray:
    """uint8 BGR of a gray or colour image; float images in [0, 1] are
    scaled by 255, others clipped."""
    import cv2

    im = np.asarray(im)
    if im.dtype != np.uint8:
        im = np.clip(im, 0, 255).astype(np.uint8) if im.max() > 1 \
            else (im * 255).astype(np.uint8)
    if im.ndim == 2:
        im = cv2.cvtColor(im, cv2.COLOR_GRAY2BGR)
    return im


def plot_matches_cv2(image0, image1, pts0, pts1, path=None, point_size=3,
                     line_thickness=1, max_lines=1000) -> np.ndarray:
    """Side-by-side mosaic of two images with every k-th match drawn (at
    most about `max_lines`), each in a colour seeded by its index;
    written to `path` when given. Returns the BGR mosaic."""
    import cv2

    im0, im1 = _to_bgr(image0), _to_bgr(image1)
    h = max(im0.shape[0], im1.shape[0])
    mosaic = np.zeros((h, im0.shape[1] + im1.shape[1], 3), np.uint8)
    mosaic[:im0.shape[0], :im0.shape[1]] = im0
    mosaic[:im1.shape[0], im0.shape[1]:] = im1
    off = im0.shape[1]
    pts0 = np.asarray(pts0).astype(int)
    pts1 = np.asarray(pts1).astype(int)
    for i in range(0, len(pts0), max(1, len(pts0) // max_lines)):
        c = tuple(int(v) for v in np.random.default_rng(i).integers(
            64, 255, 3))
        p0 = tuple(int(v) for v in pts0[i])
        p1 = (int(pts1[i][0]) + off, int(pts1[i][1]))
        cv2.circle(mosaic, p0, point_size, c, -1)
        cv2.circle(mosaic, p1, point_size, c, -1)
        cv2.line(mosaic, p0, p1, c, line_thickness)
    if path is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(path), mosaic)
    return mosaic
