"""Render an epoch-by-epoch animation of the evolving point cloud,
headless: each epoch cloud over an optional static base cloud with a
fixed orthographic camera, one PNG an epoch, and an animated GIF with
--gif when Pillow is there:

  python -m icepy4d_tpu_torch dynamic_visualization \
      "res/point_clouds/dense_*.ply" --out res/dynamic_viz \
      [--base base.ply] [--polyline poly.csv] [--elev 0 --azim -90] [--gif]
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path

from icepy4d_tpu_torch.device import resolve_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m icepy4d_tpu_torch dynamic_visualization")
    ap.add_argument("pattern", help="glob for per-epoch clouds")
    ap.add_argument("--out", default="res/dynamic_viz")
    ap.add_argument("--base", default=None,
                    help="static base cloud drawn under every frame")
    ap.add_argument("--polyline", default=None,
                    help="CSV polygon crop applied to every epoch cloud")
    ap.add_argument("--elev", type=float, default=0.0)
    ap.add_argument("--azim", type=float, default=-90.0)
    ap.add_argument("--color", type=float, nargs=3,
                    default=[1.0, 0.0, 0.0])
    ap.add_argument("--max-points", type=int, default=200_000)
    ap.add_argument("--gif", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def main(argv=None):
    """Returns the rendered frames' paths."""
    args = parser().parse_args(argv)
    resolve_device(args.device)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    from icepy4d_tpu_torch.io.ply import read_ply
    from icepy4d_tpu_torch.post_processing import filter_pcd_by_polyline
    from icepy4d_tpu_torch.post_processing.analysis import set_axes_equal

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    base = None
    if args.base:
        base, _ = read_ply(args.base)
        if len(base) > args.max_points:
            base = base[:: len(base) // args.max_points + 1]
    poly = (np.loadtxt(args.polyline, delimiter=",")
            if args.polyline else None)

    frames = []
    for fp in sorted(glob.glob(args.pattern)):
        fp = Path(fp)
        pts, _ = read_ply(fp)
        if poly is not None:
            pts = pts[filter_pcd_by_polyline(pts, poly)]
        if len(pts) > args.max_points:
            pts = pts[:: len(pts) // args.max_points + 1]
        fig = plt.figure(figsize=(12, 7))
        ax = fig.add_subplot(projection="3d")
        if base is not None:
            ax.scatter(base[:, 0], base[:, 1], base[:, 2],
                       s=1, c="gray", alpha=0.3)
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1,
                   color=tuple(args.color), alpha=0.8)
        ax.set_title(fp.stem)
        ax.view_init(elev=args.elev, azim=args.azim)
        ax.set_proj_type("ortho")
        set_axes_equal(ax)
        frame = out_dir / f"frame_{fp.stem}.png"
        fig.savefig(frame, dpi=120)
        plt.close(fig)
        frames.append(frame)
        print(f"rendered {frame.name}")

    if args.gif and frames:
        try:
            from PIL import Image

            imgs = [Image.open(f) for f in frames]
            imgs[0].save(out_dir / "animation.gif", save_all=True,
                         append_images=imgs[1:], duration=400, loop=0)
            print(f"wrote {out_dir / 'animation.gif'}")
        except ImportError:
            print("Pillow unavailable — PNG frames only")
    return frames


if __name__ == "__main__":
    main()
