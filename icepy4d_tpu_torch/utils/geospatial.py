"""Geospatial predicates on the host with scipy (counterpart of
`icepy4d_tpu/utils/geospatial.py`)."""

from __future__ import annotations

import numpy as np
from scipy.spatial import ConvexHull, Delaunay


def ccw_sort_points(p: np.ndarray) -> np.ndarray:
    """Sort 2D points counter-clockwise around their barycenter."""
    p = np.asarray(p)
    d = p - p.mean(axis=0)
    return p[np.argsort(np.arctan2(d[:, 0], d[:, 1]))]


def point_in_rect(point, rect) -> bool:
    """Is a single 2D point inside [xmin, ymin, xmax, ymax]?"""
    return bool(rect[0] < point[0] < rect[2]
                and rect[1] < point[1] < rect[3])


def points_in_rect(points: np.ndarray, rect) -> np.ndarray:
    """(n,) bool mask of 2D points inside [xmin, ymin, xmax, ymax]."""
    points = np.asarray(points)
    rect = np.asarray(rect)
    return np.all(points > rect[:2], axis=1) & \
        np.all(points < rect[2:], axis=1)


def point_in_hull(p: np.ndarray, hull) -> np.ndarray:
    """(n,) bool: points inside the convex hull of `hull` points (or a
    prebuilt scipy Delaunay)."""
    if not isinstance(hull, Delaunay):
        hull = Delaunay(np.asarray(hull))
    return hull.find_simplex(np.asarray(p)) >= 0


def point_in_volume(points: np.ndarray, volume: np.ndarray) -> np.ndarray:
    """(n,) bool: 3D points inside the convex volume of `volume`."""
    return point_in_hull(points, volume)


def convex_hull_volume(points: np.ndarray) -> float:
    """Volume of the 3D convex hull of `points`."""
    return float(ConvexHull(np.asarray(points)).volume)


def select_features_by_rect(features, rect, inplace: bool = False):
    """Keep only the features whose keypoints fall inside `rect`.
    Returns the mask."""
    mask = points_in_rect(features.kpts_to_numpy(), rect)
    if inplace:
        features.filter_feature_by_mask(mask)
    return mask
