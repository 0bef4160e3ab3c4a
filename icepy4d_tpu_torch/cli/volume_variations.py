"""Volume variation time series between epoch point clouds: pairs
clouds `--tstep` days apart, takes the DEM of difference of each pair
on the card, writes the CSV schema of the upstream workflow and saves
the daily and cumulative plots:

  python -m icepy4d_tpu_torch volume_variations \
      "res/point_clouds_meshed/sampled*.ply" --out res/volumes_variations \
      --tstep 5 --grid-step 0.3 --dir x
"""

from __future__ import annotations

import argparse
import glob
import json
from pathlib import Path

from icepy4d_tpu_torch.device import resolve_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m icepy4d_tpu_torch volume_variations")
    ap.add_argument("pattern", help="glob for epoch point clouds")
    ap.add_argument("--out", default="res/volumes_variations")
    ap.add_argument("--tstep", type=int, default=5)
    ap.add_argument("--grid-step", type=float, default=0.3)
    ap.add_argument("--dir", default="x", choices=["x", "y", "z"])
    ap.add_argument("--base-name", default=None,
                    help="cloud-name prefix before the date "
                         "(default: inferred from the pattern)")
    ap.add_argument("--date-format", default="%Y_%m_%d")
    ap.add_argument("--no-plots", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def main(argv=None):
    """Returns the pandas DataFrame of the pairs."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)

    from icepy4d_tpu_torch.post_processing import volume_variations

    pcd_list = sorted(glob.glob(args.pattern))
    if not pcd_list:
        raise SystemExit(f"no clouds match {args.pattern}")
    base = args.base_name
    if base is None:
        base = Path(args.pattern).name.split("*")[0].rstrip("_")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    # the run's parameters; the device does not change the result
    params = {k: v for k, v in vars(args).items() if k != "device"}
    with open(out_dir / "parameters.json", "w") as f:
        json.dump(params, f, indent=4)
    df = volume_variations(
        pcd_list, t_step=args.tstep, grid_step=args.grid_step,
        direction=args.dir, out_dir=out_dir, base_name=base,
        date_format=args.date_format, make_plots=not args.no_plots,
        device=dev)
    print(df[["pcd0", "pcd1", "volume", "matchingPercent"]]
          .to_string(index=False))
    return df


if __name__ == "__main__":
    main()
