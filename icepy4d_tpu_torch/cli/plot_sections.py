"""Plot cross sections of epoch point clouds: each section is the
planar slab of a cloud around a station along an axis, drawn headless
to a PNG in an orthographic view:

  python -m icepy4d_tpu_torch plot_sections "res/monthly_pcd/*.ply" \
      --axis y --stations 200 225 250 --thickness 2 --out sections.png
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path

from icepy4d_tpu_torch.device import resolve_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m icepy4d_tpu_torch plot_sections")
    ap.add_argument("pattern", help="glob for point clouds (one section "
                                    "set per cloud) ")
    ap.add_argument("--axis", default="y", choices=["x", "y", "z"])
    ap.add_argument("--stations", type=float, nargs="+", required=True)
    ap.add_argument("--thickness", type=float, default=1.0)
    ap.add_argument("--out", default="sections.png")
    ap.add_argument("--elev", type=float, default=0.0)
    ap.add_argument("--azim", type=float, default=-90.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def main(argv=None):
    """Returns {"<cloud>@<axis>=<station>": (M, 3) section}."""
    args = parser().parse_args(argv)
    resolve_device(args.device)

    from icepy4d_tpu_torch.io.ply import read_ply
    from icepy4d_tpu_torch.post_processing import (extract_sections,
                                                   plot_sections)

    sections = {}
    for fp in sorted(glob.glob(args.pattern)):
        fp = Path(fp)
        pts, _ = read_ply(fp)
        for st, sec in extract_sections(pts, args.axis, args.stations,
                                        args.thickness).items():
            sections[f"{fp.stem}@{args.axis}={st:g}"] = sec
    plot_sections(sections, elev=args.elev, azim=args.azim, out=args.out)
    print(f"wrote {args.out} ({len(sections)} sections)")
    return sections


if __name__ == "__main__":
    main()
