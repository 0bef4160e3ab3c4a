"""Transform point clouds between the Belvedere local and UTM frames
with the site's 4x4 roto-translation:

  python -m icepy4d_tpu_torch pcd_rototranslation "res/monthly_pcd/*.ply" \
      --mode loc2utm [--suffix _utm]
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path

from icepy4d_tpu_torch.device import resolve_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m icepy4d_tpu_torch pcd_rototranslation")
    ap.add_argument("pattern", help="glob for point clouds")
    ap.add_argument("--mode", choices=["loc2utm", "utm2loc"],
                    default="loc2utm")
    ap.add_argument("--suffix", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def main(argv=None):
    """Returns the written paths."""
    args = parser().parse_args(argv)
    resolve_device(args.device)

    from icepy4d_tpu_torch.io.ply import read_ply, write_ply
    from icepy4d_tpu_torch.utils.rototranslation import (belvedere_loc2utm,
                                                         belvedere_utm2loc)

    fn = belvedere_loc2utm if args.mode == "loc2utm" else belvedere_utm2loc
    suffix = args.suffix or ("_utm" if args.mode == "loc2utm" else "_loc")
    written = []
    for fp in sorted(glob.glob(args.pattern)):
        fp = Path(fp)
        pts, cols = read_ply(fp)
        out = fp.with_name(f"{fp.stem}{suffix}.ply")
        write_ply(out, fn(pts), cols)
        print(f"{fp.name} -> {out.name}")
        written.append(out)
    return written


if __name__ == "__main__":
    main()
