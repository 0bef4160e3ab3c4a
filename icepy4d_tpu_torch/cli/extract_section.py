"""Detect the glacier top border in each epoch cloud and build its time
series: merges the matching sparse cloud, optionally crops to a
polygon, detects the border from kNN covariance features on the card
(linearity, verticality and height percentile bands), and writes the
border clouds and the top_border_coords.txt series of their centres:

  python -m icepy4d_tpu_torch extract_section "res/point_clouds/dense_*.ply" \
      --out res/detect_top_border [--polyline poly.csv] [--k 32] \
      [--ylims 224 228]
"""

from __future__ import annotations

import argparse
import glob
import re
from pathlib import Path

from icepy4d_tpu_torch.device import resolve_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m icepy4d_tpu_torch extract_section")
    ap.add_argument("pattern", help="glob for dense point clouds")
    ap.add_argument("--out", default="res/detect_top_border")
    ap.add_argument("--polyline", default=None,
                    help="CSV polygon to crop each cloud first")
    ap.add_argument("--k", type=int, default=32,
                    help="kNN size for geometric features")
    ap.add_argument("--ylims", type=float, nargs=2, default=None)
    ap.add_argument("--x-halfwidth", type=float, default=10.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def main(argv=None):
    """Returns {cloud path: border mask over its (merged, cropped)
    points}."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)

    import numpy as np

    from icepy4d_tpu_torch.io.ply import read_ply, write_ply
    from icepy4d_tpu_torch.post_processing import (border_statistics,
                                                   detect_border,
                                                   filter_pcd_by_polyline,
                                                   write_border_time_series)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    masks = {}
    for fp in sorted(glob.glob(args.pattern)):
        fp = Path(fp)
        pts, cols = read_ply(fp)
        # merge the matching sparse cloud when there is one
        sparse = Path(str(fp).replace("dense", "sparse"))
        if sparse.exists() and sparse != fp:
            sp, sc = read_ply(sparse)
            pts = np.concatenate([pts, sp])
            if cols is not None and sc is not None:
                cols = np.concatenate([cols, sc])
        if args.polyline:
            poly = np.loadtxt(args.polyline, delimiter=",")
            m = filter_pcd_by_polyline(pts, poly)
            pts = pts[m]
            cols = cols[m] if cols is not None else None
        mask = detect_border(pts, k=args.k, device=dev)
        border = pts[mask]
        m = re.search(r"(\d{4}[-_]\d{2}[-_]\d{2}.*)$", fp.stem)
        date = m.group(1) if m else fp.stem
        write_ply(out_dir / f"border_{date}.ply", border)
        rows.append((fp.name, date, border_statistics(
            border, y_lims=args.ylims, x_halfwidth=args.x_halfwidth)))
        print(f"{fp.name}: {mask.sum()} border points")
        masks[str(fp)] = mask
    fout = write_border_time_series(rows, out_dir / "top_border_coords.txt")
    print(f"wrote {fout}")
    return masks


if __name__ == "__main__":
    main()
