"""Voxelize epoch point clouds to a fixed grid, one scatter-add on the
card a cloud; writes the filled voxels' x,y,z,r,g,b txt and, with
--mesh, a cube mesh PLY:

  python -m icepy4d_tpu_torch voxelization "res/point_clouds/dense_*.ply" \
      --voxel-size 0.2 --bb-min -100 130 60 --bb-max 30 330 120 \
      --out res/voxels [--mesh]
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path

from icepy4d_tpu_torch.device import resolve_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m icepy4d_tpu_torch voxelization")
    ap.add_argument("pattern", help="glob for point clouds")
    ap.add_argument("--voxel-size", type=float, default=0.2)
    ap.add_argument("--bb-min", type=float, nargs=3, default=None)
    ap.add_argument("--bb-max", type=float, nargs=3, default=None)
    ap.add_argument("--out", default="res/voxels")
    ap.add_argument("--mesh", action="store_true",
                    help="also write a cube mesh PLY per cloud")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def main(argv=None):
    """Returns {cloud path: VoxelGrid}."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)

    from icepy4d_tpu_torch.io.ply import read_ply
    from icepy4d_tpu_torch.post_processing import (voxel_mesh, voxelize,
                                                   write_voxel_centers)
    from icepy4d_tpu_torch.post_processing.point_clouds import write_mesh_ply

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    grids = {}
    for fp in sorted(glob.glob(args.pattern)):
        fp = Path(fp)
        pts, cols = read_ply(fp)
        grid = voxelize(pts, cols, voxel_size=args.voxel_size,
                        bb_min=args.bb_min, bb_max=args.bb_max, device=dev)
        fout = out_dir / f"{fp.stem}_voxel_{args.voxel_size}m.txt"
        write_voxel_centers(grid, fout)
        print(f"{fp.name}: {len(grid.centers)} filled voxels -> {fout}")
        if args.mesh:
            verts, faces, _ = voxel_mesh(grid)
            write_mesh_ply(out_dir / f"{fp.stem}_vox_mesh.ply",
                           verts, faces)
        grids[str(fp)] = grid
    return grids


if __name__ == "__main__":
    main()
