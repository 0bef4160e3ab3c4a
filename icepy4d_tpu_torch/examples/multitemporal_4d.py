"""Multitemporal 4D walkthrough: run the pipeline over a season of
stereo epochs with temporal tracking on the card, then assemble the
tracked points' time series, their displacements and, with --dense, a
DEM of difference between the first and the last epoch's dense clouds:

  python -m icepy4d_tpu_torch.examples.multitemporal_4d --assets DIR \
      [--out OUT] [--matcher nn] [--dense] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.examples import asset_dir
from icepy4d_tpu_torch.examples.single_epoch_stereo import CENTERS, TARGETS


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m icepy4d_tpu_torch.examples.multitemporal_4d")
    ap.add_argument("--assets", required=True,
                    help="asset folder: img/<cam>/, calib/<cam>.txt, "
                         "targets/")
    ap.add_argument("--out", default="res/multitemporal")
    ap.add_argument("--matcher", default="nn")
    ap.add_argument("--quality", default="high")
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def config(assets: Path, out: str, matcher: str, quality: str,
           dense: bool):
    """The walkthrough's Pipeline config over the asset folder."""
    from icepy4d_tpu_torch.utils.config import DotDict

    return DotDict.wrap({
        "paths": {"image_dir": str(assets / "img"),
                  "calibration_dir": str(assets / "calib"),
                  "results_dir": out},
        "proc": {"epoch_to_process": "all", "do_tracking": True,
                 "do_ba": True, "do_dense": bool(dense),
                 "save_checkpoints": True,
                 "load_existing_results": False},
        "georef": {
            "camera_centers_world": np.array(CENTERS, np.float32),
            "target_dir": str(assets / "targets"),
            "target_world_file": "target_world.csv",
            "targets_to_use": list(TARGETS),
        },
        "other": {"pydegensac_threshold": 2.0},
        "matching": {"matcher": matcher, "quality": quality,
                     "tile_selection": "none", "max_keypoints": 4096},
        "ba": {"camera_location_accuracy": 0.5, "max_iters": 60},
        "dense": {"n_planes": 128, "downscale": 2},
    })


def main(argv=None):
    """Returns the processed Epoches."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    A = asset_dir(args.assets)

    from icepy4d_tpu_torch.pipeline import Pipeline
    from icepy4d_tpu_torch.utils import (compute_displacements,
                                         tracked_points_time_series,
                                         tracked_time_series_to_df)

    pipe = Pipeline(config(A, args.out, args.matcher, args.quality,
                           args.dense), device=dev)
    epoches = pipe.run()
    print(f"processed {len(epoches)} epochs")

    # 4D products: tracked-point time series + displacement table
    series = tracked_points_time_series(epoches, min_tracked_epoches=2)
    print(f"{len(series)} points tracked over >=2 epochs")
    if series:
        df = tracked_time_series_to_df(series, epoches)
        df.to_csv(Path(args.out) / "tracked_points.csv", index=False)
        disp = compute_displacements(series)
        disp.to_csv(Path(args.out) / "displacements.csv", index=False)
        print(disp.describe().loc[["mean", "max"]][["displacement"]])

    # DEM of difference between the first and the last dense clouds
    if args.dense and len(epoches) >= 2:
        from icepy4d_tpu_torch.post_processing import DemOfDifference

        first, last = epoches[0], epoches[len(epoches) - 1]
        if first.point_cloud is not None and last.point_cloud is not None \
                and len(first.point_cloud) and len(last.point_cloud):
            dod = DemOfDifference(first.point_cloud.points,
                                  last.point_cloud.points, dsm_step=2.0,
                                  device=dev)
            rep = dod.compute_volume()
            dod.write_result_to_file(Path(args.out) / "volumes.csv",
                                     label=f"{first.date_str}->"
                                     f"{last.date_str}")
            print(f"volume change: +{rep.added:.0f} / -{rep.removed:.0f} "
                  f"m3 over {rep.area:.0f} m2")
    return epoches


if __name__ == "__main__":
    main()
