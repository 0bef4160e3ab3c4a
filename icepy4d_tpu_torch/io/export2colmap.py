"""COLMAP export of an epoch's solution (counterpart of
`icepy4d_tpu/io/export2colmap.py`).

A sparse text model (cameras.txt with the OPENCV model, images.txt with
world-to-camera quaternions, points3D.txt), a binary model, a COLMAP
project database, and hloc-style keypoint / match h5 files (h5py is
imported by `features_to_h5` only).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from icepy4d_tpu_torch.ops.transforms import quaternion_from_matrix

logger = logging.getLogger("icepy4d_tpu_torch")


def export_solution_to_colmap(
    export_dir,
    images: dict,
    cameras: dict,
    features: dict | None = None,
    points=None,
) -> Path:
    """Write a COLMAP sparse text model (cameras/images/points3D.txt)."""
    export_dir = Path(export_dir)
    export_dir.mkdir(parents=True, exist_ok=True)
    cams = list(cameras.keys())

    with open(export_dir / "cameras.txt", "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        for ci, c in enumerate(cams, start=1):
            cam = cameras[c]
            K = np.asarray(cam.K)
            d = np.asarray(cam.dist).ravel()
            # OPENCV model: fx fy cx cy k1 k2 p1 p2
            f.write(
                f"{ci} OPENCV {cam.width} {cam.height} "
                f"{K[0, 0]} {K[1, 1]} {K[0, 2]} {K[1, 2]} "
                f"{d[0]} {d[1]} {d[2]} {d[3]}\n")

    with open(export_dir / "images.txt", "w") as f:
        f.write("# Image list: IMAGE_ID QW QX QY QZ TX TY TZ "
                "CAMERA_ID NAME\n")
        for ci, c in enumerate(cams, start=1):
            cam = cameras[c]
            E = np.asarray(cam.extrinsics, np.float64)
            q = quaternion_from_matrix(torch.as_tensor(
                E[:3, :3], dtype=torch.float32)).numpy()
            t = E[:3, 3]
            name = images[c].name if c in images else f"{c}.jpg"
            f.write(f"{ci} {q[0]} {q[1]} {q[2]} {q[3]} "
                    f"{t[0]} {t[1]} {t[2]} {ci} {name}\n\n")

    with open(export_dir / "points3D.txt", "w") as f:
        f.write("# 3D point list: POINT3D_ID X Y Z R G B ERROR "
                "TRACK[] as (IMAGE_ID POINT2D_IDX)\n")
        if points is not None and len(points):
            xyz = points.to_numpy()
            col = points.colors_to_numpy(as_uint8=True)
            ids = points.track_ids_to_numpy()
            # tracks stay EMPTY: the images.txt records carry no 2-D
            # observations, and COLMAP validates track references
            # against them (a non-empty track into an empty image
            # crashes the loader)
            for i in range(len(xyz)):
                f.write(f"{int(ids[i])} {xyz[i][0]} {xyz[i][1]} "
                        f"{xyz[i][2]} {col[i][0]} {col[i][1]} "
                        f"{col[i][2]} 0.0\n")
    logger.info("COLMAP model written to %s", export_dir)
    return export_dir


def export_solution_to_colmap_binary(
    export_dir,
    images: dict,
    cameras: dict,
    points=None,
) -> Path:
    """Write a COLMAP sparse BINARY model (cameras/images/points3D.bin),
    which COLMAP's GUI / CLI load directly (io/colmap.py formats).
    """
    from icepy4d_tpu_torch.io.colmap import (ColmapCamera, ColmapImage,
                                             ColmapPoint3D, rotmat2qvec,
                                             write_model)

    export_dir = Path(export_dir)
    cams = list(cameras.keys())
    ccams, cimgs = {}, {}
    for ci, c in enumerate(cams, start=1):
        cam = cameras[c]
        K = np.asarray(cam.K)
        d = np.asarray(cam.dist).ravel()
        ccams[ci] = ColmapCamera(
            ci, "OPENCV", int(cam.width), int(cam.height),
            np.asarray([K[0, 0], K[1, 1], K[0, 2], K[1, 2],
                        d[0], d[1], d[2], d[3]], np.float64))
        E = np.asarray(cam.extrinsics, np.float64)
        name = images[c].name if c in images else f"{c}.jpg"
        cimgs[ci] = ColmapImage(ci, rotmat2qvec(E[:3, :3]), E[:3, 3],
                                ci, str(name))
    cpts = {}
    if points is not None and len(points):
        xyz = points.to_numpy()
        col = points.colors_to_numpy(as_uint8=True)
        ids = points.track_ids_to_numpy()
        # empty tracks: the image records carry no 2-D observations and
        # COLMAP dereferences track elements against them
        empty = np.zeros((0,), np.int32)
        for i in range(len(xyz)):
            cpts[int(ids[i])] = ColmapPoint3D(
                int(ids[i]), xyz[i].astype(np.float64), col[i], 0.0,
                empty, empty)
    write_model(ccams, cimgs, cpts, export_dir, ext=".bin")
    logger.info("COLMAP binary model written to %s", export_dir)
    return export_dir


def export_to_colmap_database(
    db_path,
    images: dict,
    cameras: dict,
    features: dict | None = None,
    matches: dict | None = None,
) -> Path:
    """Create a COLMAP project database (io/colmap.py::COLMAPDatabase)
    with cameras, images, keypoints and matches: the entry point for
    running COLMAP's own mapper on matches produced by this package.

    matches: {(cam_a, cam_b): (N, 2) int array of keypoint-row pairs}.
    """
    from icepy4d_tpu_torch.io.colmap import COLMAPDatabase

    db_path = Path(db_path)
    db_path.parent.mkdir(parents=True, exist_ok=True)
    if db_path.exists():
        db_path.unlink()
    db = COLMAPDatabase.connect(db_path)
    try:
        ids = {}
        for c, cam in cameras.items():
            K = np.asarray(cam.K)
            d = np.asarray(cam.dist).ravel()
            cam_id = db.add_camera(
                "OPENCV", cam.width, cam.height,
                [K[0, 0], K[1, 1], K[0, 2], K[1, 2],
                 d[0], d[1], d[2], d[3]], prior_focal_length=True)
            name = images[c].name if c in images else f"{c}.jpg"
            ids[c] = db.add_image(name, cam_id)
            if features is not None and c in features:
                db.add_keypoints(ids[c], features[c].kpts_to_numpy())
        for (a, b), m in (matches or {}).items():
            db.add_matches(ids[a], ids[b], np.asarray(m))
            db.add_two_view_geometry(ids[a], ids[b], np.asarray(m))
        db.commit()
    finally:
        db.close()
    logger.info("COLMAP database written to %s", db_path)
    return db_path


def features_to_h5(
    export_dir,
    images: dict,
    features: dict,
    matches: np.ndarray | None = None,
) -> tuple[Path, Path]:
    """hloc / IMC-style keypoints + matches h5.

    features.h5: per-image 'keypoints' (N, 2); matches.h5: group
    im0/im1 -> (M, 2) index pairs (defaults to the aligned identity,
    matching the framework's row-aligned feature storage).
    """
    import h5py

    export_dir = Path(export_dir)
    export_dir.mkdir(parents=True, exist_ok=True)
    cams = list(features.keys())
    feat_path = export_dir / "features.h5"
    match_path = export_dir / "matches.h5"

    with h5py.File(feat_path, "w") as f:
        for c in cams:
            name = images[c].name if c in images else c
            g = f.create_group(name)
            g.create_dataset("keypoints",
                             data=features[c].kpts_to_numpy())
            g.create_dataset("scores",
                             data=features[c].scores_to_numpy())
            g.create_dataset("descriptors",
                             data=features[c].descr_to_numpy())

    n = min(len(features[c]) for c in cams)
    if matches is None:
        matches = np.stack([np.arange(n), np.arange(n)], -1)
    with h5py.File(match_path, "w") as f:
        name0 = images[cams[0]].name if cams[0] in images else cams[0]
        name1 = images[cams[1]].name if cams[1] in images else cams[1]
        f.create_group(name0).create_dataset(name1, data=matches)
    return feat_path, match_path
