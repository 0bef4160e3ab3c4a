"""Merge a stereo DSM into a larger base DEM and report the volume
change, on `.npz` DSMs written by `build_dem`:

  python -m icepy4d_tpu_torch update_dem base.npz update.npz \
      --out merged.npz

Grids of one shape and extent are differenced cell by cell; a smaller
update grid of the same resolution is placed by its coordinates.
"""

from __future__ import annotations

import argparse

import numpy as np

from icepy4d_tpu_torch.device import resolve_device


def load(path):
    from icepy4d_tpu_torch.utils.dsm_orthophoto import DSM

    d = np.load(path)
    return DSM(z=d["z"], mask=d["mask"], xx=d["xx"], yy=d["yy"],
               res=float(d["res"]))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m icepy4d_tpu_torch update_dem")
    ap.add_argument("base")
    ap.add_argument("update")
    ap.add_argument("--out", default="merged.npz")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def main(argv=None):
    """Returns the merged DSM."""
    args = parser().parse_args(argv)
    resolve_device(args.device)

    from icepy4d_tpu_torch.utils import dem_of_difference, save_dsm_npz
    from icepy4d_tpu_torch.utils.dsm_orthophoto import DSM

    base = load(args.base)
    upd = load(args.update)
    same_grid = (base.z.shape == upd.z.shape
                 and np.allclose(base.xx, upd.xx)
                 and np.allclose(base.yy, upd.yy))
    if same_grid:
        dz, rep = dem_of_difference(base, upd)
        print(f"volume added {rep.added:.1f} m3, removed "
              f"{rep.removed:.1f} m3, net {rep.net:.1f} m3 over "
              f"{rep.area:.0f} m2")
        z = np.where(upd.mask, upd.z, base.z)
        mask = base.mask | upd.mask
    else:
        # the update (a stereo DSM) usually covers a sub-extent of the
        # base DEM, anywhere inside it: place it by its coordinates
        if not np.isclose(base.res, upd.res):
            raise SystemExit(
                f"grid resolutions differ ({base.res} vs {upd.res}); "
                "regrid the update first")
        i0 = int(round((upd.yy[0] - base.yy[0]) / base.res))
        j0 = int(round((upd.xx[0] - base.xx[0]) / base.res))
        uh, uw = upd.z.shape
        if (i0 < 0 or j0 < 0 or i0 + uh > base.z.shape[0]
                or j0 + uw > base.z.shape[1]):
            raise SystemExit(
                "update grid extends outside the base DEM "
                f"(offset {i0},{j0}, size {uh}x{uw} vs "
                f"base {base.z.shape})")
        z = base.z.copy()
        mask = base.mask.copy()
        sub = (slice(i0, i0 + uh), slice(j0, j0 + uw))
        z[sub] = np.where(upd.mask, upd.z, base.z[sub])
        mask[sub] = base.mask[sub] | upd.mask
    merged = DSM(z=z, mask=mask, xx=base.xx, yy=base.yy, res=base.res)
    save_dsm_npz(merged, args.out)
    print(f"merged DEM -> {args.out}")
    return merged


if __name__ == "__main__":
    main()
