"""Bundler .out and ODM GCP files (counterpart of
`icepy4d_tpu/io/export2bundler.py`): the formats external SfM tools
(COLMAP, ODM, Metashape) import a solution from."""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from icepy4d_tpu_torch.ops.transforms import euler_matrix

logger = logging.getLogger("icepy4d_tpu_torch")


def write_bundler_out(
    export_dir,
    fname: str,
    images: dict,
    cameras: dict,
    features: dict,
    points,
) -> Path:
    """Write a Bundler v0.3 .out file + im_list.txt.

    Convention (Bundler spec): camera frame rotated 180
    deg about x (z looks BACKWARD), image coords centered at the
    principal image center with y up.
    """
    export_dir = Path(export_dir)
    export_dir.mkdir(parents=True, exist_ok=True)
    cams = list(cameras.keys())
    n_pts = len(features[cams[0]])
    w = cameras[cams[0]].width
    h = cameras[cams[0]].height

    Rx = euler_matrix(*torch.tensor([np.pi, 0.0, 0.0],
                                    dtype=torch.float32)).numpy()
    out = export_dir / f"{fname}.out"
    with open(out, "w") as f:
        f.write("# Bundle file v0.3\n")
        f.write(f"{len(cams)} {n_pts}\n")
        for c in cams:
            cam = cameras[c]
            pose = np.asarray(cam.pose, np.float64)
            pose[:3, :3] = pose[:3, :3] @ Rx
            E = np.linalg.inv(pose)
            R, t = E[:3, :3], E[:3, 3]
            K = np.asarray(cam.K)
            dist = np.asarray(cam.dist).ravel()
            f.write(f"{K[1, 1]:.10f} {dist[0]:.10f} {dist[1]:.10f}\n")
            for row in R:
                f.write(f"{row[0]:.10f} {row[1]:.10f} {row[2]:.10f}\n")
            f.write(f"{t[0]:.10f} {t[1]:.10f} {t[2]:.10f}\n")

        xyz = points.to_numpy()
        col = points.colors_to_numpy(as_uint8=True)
        im_xy = {}
        for c in cams:
            m = features[c].kpts_to_numpy().astype(np.float64).copy()
            m[:, 0] = m[:, 0] - w / 2 + 0.5
            m[:, 1] = h / 2 - m[:, 1] - 0.5
            im_xy[c] = m
        for i in range(n_pts):
            f.write(f"{xyz[i][0]} {xyz[i][1]} {xyz[i][2]}\n")
            f.write(f"{col[i][0]} {col[i][1]} {col[i][2]}\n")
            obs = " ".join(
                f"{ci} {i} {im_xy[c][i][0]:.4f} {im_xy[c][i][1]:.4f}"
                for ci, c in enumerate(cams))
            f.write(f"{len(cams)} {obs}\n")

    with open(export_dir / "im_list.txt", "w") as f:
        for c in cams:
            f.write(f"{images[c].path}\n")
    logger.info("Bundler solution written to %s", out)
    return out


def read_bundler_out(path) -> tuple[list, np.ndarray, list]:
    """Parse a Bundler .out: (cameras [{f,k1,k2,R,t}], points (N,3),
    observations per point)."""
    lines = Path(path).read_text().splitlines()
    lines = [ln for ln in lines if not ln.startswith("#")]
    n_cams, n_pts = map(int, lines[0].split())
    cur = 1
    cams = []
    for _ in range(n_cams):
        fk = list(map(float, lines[cur].split()))
        R = np.array([list(map(float, lines[cur + 1 + i].split()))
                      for i in range(3)])
        t = np.array(list(map(float, lines[cur + 4].split())))
        cams.append({"f": fk[0], "k1": fk[1], "k2": fk[2], "R": R, "t": t})
        cur += 5
    pts, obs = [], []
    for _ in range(n_pts):
        pts.append(list(map(float, lines[cur].split())))
        view = lines[cur + 2].split()
        n_views = int(view[0])
        obs.append([
            {"camera_idx": int(view[1 + 4 * v]),
             "key_idx": int(view[2 + 4 * v]),
             "x": float(view[3 + 4 * v]),
             "y": float(view[4 + 4 * v])}
            for v in range(n_views)])
        cur += 3
    return cams, np.asarray(pts), obs


def write_odm_gcps(
    export_dir,
    targets,
    images: dict,
    labels: list[str],
    fname: str = "gcps.txt",
    projection: str = "+proj=local",
) -> Path:
    """ODM-style GCP file: one line per (target, image) as
    'X Y Z x+0.5 y+0.5 image_name label 1'."""
    export_dir = Path(export_dir)
    export_dir.mkdir(parents=True, exist_ok=True)
    cams = list(images.keys())
    out = export_dir / fname
    world, found = targets.get_object_coor_by_label(labels)
    with open(out, "w") as f:
        f.write(projection + "\n")
        for i, c in enumerate(cams):
            xy, found_c = targets.get_image_coor_by_label(found, i)
            for lab, (X, Y, Z) in zip(found, world):
                if lab not in found_c:
                    continue
                j = found_c.index(lab)
                x, y = xy[j]
                f.write(f"{X} {Y} {Z} {x + 0.5:.4f} {y + 0.5:.4f} "
                        f"{images[c].name} {lab} 1\n")
    return out
