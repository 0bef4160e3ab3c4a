"""Build a DSM (and optionally a GeoTIFF) from a point cloud, binned on
the card:

  python -m icepy4d_tpu_torch build_dem cloud.ply --step 0.5 \
      --out dem.npz [--utm2loc] [--geotiff dem.tif]
"""

from __future__ import annotations

import argparse

import numpy as np

from icepy4d_tpu_torch.device import resolve_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m icepy4d_tpu_torch build_dem")
    ap.add_argument("cloud", help="PLY point cloud")
    ap.add_argument("--step", type=float, default=0.5)
    ap.add_argument("--out", default="dem.npz")
    ap.add_argument("--geotiff", default=None)
    ap.add_argument("--utm2loc", action="store_true",
                    help="convert Belvedere UTM coords to the local frame")
    ap.add_argument("--fill-iters", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def main(argv=None):
    """Returns the DSM."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)

    from icepy4d_tpu_torch.io.ply import read_ply
    from icepy4d_tpu_torch.utils import build_dsm, save_dsm_npz
    from icepy4d_tpu_torch.utils.dsm_orthophoto import save_dsm_geotiff
    from icepy4d_tpu_torch.utils.rototranslation import belvedere_utm2loc

    pts, _ = read_ply(args.cloud)
    if args.utm2loc:
        pts = belvedere_utm2loc(pts)
    dsm = build_dsm(pts.astype(np.float32), dsm_step=args.step,
                    fill_iters=args.fill_iters, device=dev)
    save_dsm_npz(dsm, args.out)
    print(f"DSM {dsm.z.shape} at {args.step} m -> {args.out}")
    if args.geotiff:
        ok = save_dsm_geotiff(dsm, args.geotiff)
        print(f"GeoTIFF: {'written' if ok else 'rasterio unavailable'}")
    return dsm


if __name__ == "__main__":
    main()
