"""Point-cloud post-processing: polyline crop, cloud merge, meshing and
the DEM of difference (counterpart of
`icepy4d_tpu/post_processing/point_clouds.py`).

open3d is optional (`meshing_poisson(use_open3d=True)`); everything else
is numpy on the host or the port's device code.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np

from icepy4d_tpu_torch.io.ply import read_ply
from icepy4d_tpu_torch.utils.dsm_orthophoto import (build_dsm,
                                                    dem_of_difference)

logger = logging.getLogger("icepy4d_tpu_torch")


def _points_in_polygon(points_2d: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Vectorized even-odd rule point-in-polygon test."""
    x = points_2d[:, 0][:, None]
    y = points_2d[:, 1][:, None]
    x0, y0 = poly[:, 0][None], poly[:, 1][None]
    x1 = np.roll(poly[:, 0], -1)[None]
    y1 = np.roll(poly[:, 1], -1)[None]
    cond = (y0 <= y) != (y1 <= y)
    denom = np.where(y1 - y0 == 0, 1e-300, y1 - y0)
    xint = x0 + (y - y0) * (x1 - x0) / denom
    return (np.sum(cond & (x < xint), axis=1) % 2).astype(bool)


def filter_pcd_by_polyline(
    points: np.ndarray,
    polyline: np.ndarray,
    dir: str = "x-y",
    keep_inside: bool = True,
) -> np.ndarray:
    """Boolean mask of 3-D points whose projection along `dir`
    ('x-y' | 'x-z' | 'y-z') falls inside the 2-D polyline."""
    points = np.asarray(points)
    axes = {"x-y": (0, 1), "x-z": (0, 2), "y-z": (1, 2)}[dir]
    inside = _points_in_polygon(points[:, axes], np.asarray(polyline))
    return inside if keep_inside else ~inside


def read_and_merge_point_clouds(paths: list) -> tuple[np.ndarray,
                                                      np.ndarray | None]:
    """Concatenate PLY clouds (colours only if every cloud has them)."""
    pts, cols = [], []
    for p in paths:
        xyz, rgb = read_ply(Path(p))
        pts.append(xyz)
        cols.append(rgb)
    points = np.concatenate(pts, axis=0)
    colors = (np.concatenate([c for c in cols], axis=0)
              if all(c is not None for c in cols) else None)
    return points, colors


def mesh_from_dsm_grid(dsm) -> tuple[np.ndarray, np.ndarray]:
    """Triangulate a DSM grid into a mesh (vertices, faces): two
    triangles per grid square whose four corners are valid."""
    z = dsm.z
    h, w = z.shape
    verts = dsm.cell_xyz()   # shared grid-to-vertices convention
    valid = dsm.mask
    idx = np.arange(h * w).reshape(h, w)
    v00 = idx[:-1, :-1].ravel()
    v01 = idx[:-1, 1:].ravel()
    v10 = idx[1:, :-1].ravel()
    v11 = idx[1:, 1:].ravel()
    ok = (valid[:-1, :-1] & valid[:-1, 1:] & valid[1:, :-1]
          & valid[1:, 1:]).ravel()
    faces = np.concatenate([
        np.stack([v00[ok], v01[ok], v11[ok]], -1),
        np.stack([v00[ok], v11[ok], v10[ok]], -1),
    ])
    return verts, faces


def meshing_poisson(
    points: np.ndarray,
    colors: np.ndarray | None = None,
    depth: int = 9,
    density_quantile: float = 0.02,
    out_path=None,
    use_open3d: bool = False,
    device=None,
):
    """Poisson surface reconstruction.

    Default: the port's screened-Poisson pipeline (poisson.py: FFT solve
    on `device`, None: the card; marching tetrahedra on the host),
    returning (verts, faces). `use_open3d=True` runs open3d's Poisson
    when that package is installed (it returns the open3d mesh)."""
    if use_open3d:
        import open3d as o3d

        pcd = o3d.geometry.PointCloud(
            o3d.utility.Vector3dVector(np.asarray(points, np.float64)))
        if colors is not None:
            pcd.colors = o3d.utility.Vector3dVector(
                np.asarray(colors, np.float64))
        pcd.estimate_normals()
        mesh, dens = (o3d.geometry.TriangleMesh
                      .create_from_point_cloud_poisson(pcd, depth=depth))
        keep = np.asarray(dens) > np.quantile(np.asarray(dens),
                                              density_quantile)
        mesh.remove_vertices_by_mask(~keep)
        if out_path is not None:
            o3d.io.write_triangle_mesh(str(out_path), mesh)
        return mesh

    from icepy4d_tpu_torch.post_processing.poisson import poisson_reconstruct

    # an octree depth of 9 would be a 512^3 uniform grid; the grid costs
    # D^3, so the depth is capped at 8
    verts, faces, _dens = poisson_reconstruct(
        points, depth=min(int(depth), 8),
        density_quantile=density_quantile, device=device)
    if out_path is not None:
        write_mesh_ply(out_path, verts, faces)
    return verts, faces


def write_mesh_ply(path, verts: np.ndarray, faces: np.ndarray) -> None:
    """ASCII PLY mesh writer."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in verts:
            f.write(f"{v[0]:.4f} {v[1]:.4f} {v[2]:.4f}\n")
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")


class DemOfDifference:
    """DEMs of two point clouds on a shared grid and their volume change
    (cloudComPy's ComputeVolume25D in the upstream scripts).

    `pcd0` / `pcd1` are (N, 3) arrays or PLY paths. `direction` picks the
    rasterization axis: "x" grids over (y, z), "y" over (x, z), "z" over
    (x, y). The DSMs are built on `device` (None: the card)."""

    _PERM = {"x": (1, 2, 0), "y": (0, 2, 1), "z": (0, 1, 2)}

    def __init__(self, pcd0, pcd1, dsm_step: float = 1.0,
                 xlim=None, ylim=None, direction: str = "z", device=None):
        self.names = ["", ""]
        pts = []
        for i, p in enumerate((pcd0, pcd1)):
            if isinstance(p, (str, Path)):
                self.names[i] = Path(p).stem
                p = read_ply(p)[0]
            pts.append(np.asarray(p, np.float32))
        if direction not in self._PERM:
            raise ValueError(f"direction must be x|y|z, got {direction}")
        perm = list(self._PERM[direction])
        p0 = pts[0][:, perm]
        p1 = pts[1][:, perm]
        both = np.concatenate([p0, p1])
        if xlim is None:
            xlim = (float(np.floor(both[:, 0].min())),
                    float(np.ceil(both[:, 0].max())))
        if ylim is None:
            ylim = (float(np.floor(both[:, 1].min())),
                    float(np.ceil(both[:, 1].max())))
        self.dsm0 = build_dsm(p0, dsm_step, xlim=xlim, ylim=ylim,
                              device=device)
        self.dsm1 = build_dsm(p1, dsm_step, xlim=xlim, ylim=ylim,
                              device=device)
        self.dz = None
        self.report = None

    def compute_volume(self):
        self.dz, self.report = dem_of_difference(self.dsm0, self.dsm1)
        return self.report

    def write_result_to_file(self, path, label: str = "") -> None:
        if self.report is None:
            self.compute_volume()
        new = not os.path.exists(path)
        with open(path, "a") as f:
            if new:
                f.write("label,volume_added_m3,volume_removed_m3,"
                        "net_m3,area_m2,mean_dz_m\n")
            r = self.report
            f.write(f"{label},{r.added:.3f},{r.removed:.3f},"
                    f"{r.net:.3f},{r.area:.3f},{r.mean_dz:.5f}\n")

    def write_result_row(self, fname, mode: str = "a+",
                         header: bool = True) -> None:
        """The upstream CSV row: pcd0,pcd1,volume,addedVolume,
        removedVolume,surface,matchingPercent,averageNeighborsPerCell."""
        if self.report is None:
            self.compute_volume()
        write_header = header and not (
            os.path.exists(fname) and mode in ("a", "a+"))
        with open(fname, mode) as f:
            if write_header:
                f.write("pcd0,pcd1,volume,addedVolume,removedVolume,"
                        "surface,matchingPercent,"
                        "averageNeighborsPerCell\n")
            r = self.report
            f.write(f"{self.names[0]},{self.names[1]},{r.net:.4f},"
                    f"{r.added:.4f},{r.removed:.4f},{r.area:.4f},"
                    f"{r.matching_percent:.1f},"
                    f"{r.avg_neighbors_per_cell:.1f}\n")
