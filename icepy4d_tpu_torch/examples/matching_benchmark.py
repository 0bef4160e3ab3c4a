"""Matcher comparison on one stereo pair: each matcher on the same pair
with tiled matching and geometric verification, cold and warm wall
times and inlier counts, printed beside the card's name and power
limit:

  python -m icepy4d_tpu_torch.examples.matching_benchmark --assets DIR \
      [--quality high] [--grid 2 3] [--weights-dir DIR] [--device cpu]

The pair is the first frame of `DIR/img/cam1` and of `DIR/img/cam2`.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from icepy4d_tpu_torch.device import card_line, resolve_device
from icepy4d_tpu_torch.examples import asset_dir


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m icepy4d_tpu_torch.examples.matching_benchmark")
    ap.add_argument("--assets", required=True,
                    help="asset folder with img/cam1/ and img/cam2/")
    ap.add_argument("--quality", default="high")
    ap.add_argument("--grid", type=int, nargs=2, default=[2, 3])
    ap.add_argument("--max-keypoints", type=int, default=4096)
    ap.add_argument("--weights-dir", default=None,
                    help="dir with superpoint_v1.pth etc. (optional)")
    ap.add_argument("--out", default=None,
                    help="optional dir for saved matches/plots")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    """Returns {matcher: {"cold_s", "warm_s", "inliers"}}."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    A = asset_dir(args.assets)

    import cv2

    from icepy4d_tpu_torch.matching import (GeometricVerification,
                                            LightGlueMatcher, LoFTRMatcher,
                                            NearestNeighborMatcher, Quality,
                                            SemiDenseMatcher,
                                            SuperGlueMatcher, TileSelection)

    img0 = cv2.imread(str(sorted((A / "img" / "cam1").glob("*"))[0]),
                      cv2.IMREAD_GRAYSCALE)
    img1 = cv2.imread(str(sorted((A / "img" / "cam2").glob("*"))[0]),
                      cv2.IMREAD_GRAYSCALE)

    opts = {"max_keypoints": args.max_keypoints}
    wd = Path(args.weights_dir) if args.weights_dir else None

    def weights(key: str, name: str) -> dict:
        return ({key: str(wd / name)} if wd is not None
                and (wd / name).exists() else {})

    opts.update(weights("superpoint_weights", "superpoint_v1.pth"))
    matchers = {
        "NearestNeighbor": NearestNeighborMatcher(dict(opts), device=dev),
        "SemiDense": SemiDenseMatcher(dict(opts), device=dev),
        "LightGlue": LightGlueMatcher(dict(
            opts, **weights("lightglue_weights", "superpoint_lightglue.pth")),
            device=dev),
        "SuperGlue": SuperGlueMatcher(dict(opts), device=dev),
        "LoFTR": LoFTRMatcher(dict(
            opts, **weights("loftr_weights", "outdoor_ds.ckpt")),
            device=dev),
    }
    kwargs = dict(
        quality=Quality[args.quality.upper()],
        tile_selection=TileSelection.PRESELECTION,
        grid=list(args.grid), overlap=100, threshold=2.0,
        geometric_verification=GeometricVerification.PYDEGENSAC,
    )

    print(f"device: {card_line(dev)}")
    print(f"{'matcher':<16} {'cold s':>8} {'warm s':>8} {'inliers':>8}")
    results = {}
    for name, m in matchers.items():
        _sync(dev)
        t0 = time.perf_counter()
        m.match(img0, img1, **kwargs)
        _sync(dev)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        m.match(img0, img1, **kwargs)
        _sync(dev)
        warm = time.perf_counter() - t0
        print(f"{name:<16} {cold:>8.2f} {warm:>8.2f} "
              f"{len(m.mkpts0):>8d}")
        results[name] = {"cold_s": cold, "warm_s": warm,
                         "inliers": len(m.mkpts0)}
        if args.out:
            m.save_mkpts_as_txt(Path(args.out) / name)
    return results


if __name__ == "__main__":
    main()
