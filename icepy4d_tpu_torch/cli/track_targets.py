"""Track GCP targets across a season by OC template matching, one
batched FFT correlation on the card a slave image:

  python -m icepy4d_tpu_torch track_targets --master master.jpg \
      --images "data/img/cam1/*.jpg" --targets targets.csv \
      --out res/targets [--template 32 --search 128 --snr 7]

targets.csv: label,x,y rows with the target positions in the master.
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path

import numpy as np

from icepy4d_tpu_torch.device import resolve_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m icepy4d_tpu_torch track_targets")
    ap.add_argument("--master", required=True)
    ap.add_argument("--images", required=True,
                    help="glob of slave images")
    ap.add_argument("--targets", required=True,
                    help="csv with label,x,y in the master image")
    ap.add_argument("--out", default="res/targets")
    ap.add_argument("--template", type=int, default=32)
    ap.add_argument("--search", type=int, default=128)
    ap.add_argument("--snr", type=float, default=7.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def main(argv=None):
    """Returns {image stem: {"xy", "snr", "ok"}}."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)

    import pandas as pd

    from icepy4d_tpu_torch.utils.track_targets import TrackTargets

    df = pd.read_csv(args.targets)
    xy = df[["x", "y"]].to_numpy(np.float64)
    names = df["label"].tolist()
    images = sorted(glob.glob(args.images))
    if not images:
        raise SystemExit(f"no images match {args.images!r}")

    tt = TrackTargets(
        Path(args.master), [Path(p) for p in images], xy,
        target_names=names, out_dir=args.out,
        template_width=args.template, search_width=args.search,
        snr_threshold=args.snr, verbose=True, device=dev)
    results = tt.track()
    n_ok = sum(int(r["ok"].sum()) for r in results.values())
    print(f"tracked {n_ok} target observations over {len(results)} "
          f"images -> {args.out}")
    return results


if __name__ == "__main__":
    main()
