#!/usr/bin/env python3
"""How far the port's DEGENSAC consensus moves with its seed on one
epoch's putative matches of `chip_smoke.py`'s synthetic season.

    python3 scripts/degensac_seeds.py [--out-dir chiprun_out]

For texture cells of 10 px and of 24 px (`chip_smoke.SEASON_CELL_PX`)
it renders the season (`chip_smoke.season_config`), runs the Pipeline's
match of epoch 1 with geometric verification off (the same matcher call
and settings as the season phase), and runs the matcher's PYDEGENSAC
(`geometric_verification` at 1 px, confidence 0.9999, the match
confidences as guidance) on those putatives for seeds 0-15; seed 0 is
the one the Pipeline uses. Prints one JSON line per cell size with the
putative count and the inlier count of each seed, and writes the
putatives to `<out-dir>/season_putatives_<cell>px_epoch1.npz` (mkpts0,
mkpts1, mconf, inliers: the counts by seed).
`tests/test_torch_degensac_seeds.py` runs the JAX package's DEGENSAC
on such a file. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
CELLS_PX = (10, 24)
EPOCH = 1
SEEDS = 16


def putatives(chip_smoke, cell_px: float, ep: int):
    """(mkpts0, mkpts1, mconf) of the season's epoch `ep` before
    geometric verification."""
    from icepy4d_tpu_torch.pipeline import Pipeline

    with tempfile.TemporaryDirectory() as tmp:
        _, cfg = chip_smoke.season_config(torch.device("cuda"), tmp,
                                          n_epochs=ep + 1, cell_px=cell_px)
        cfg["matching"]["geometric_verification"] = "none"
        cfg["proc"].update(do_orientation=False, do_ba=False,
                           do_recovery=False, save_checkpoints=False)
        pipe = Pipeline(cfg)
        pipe.process_epoch(ep)
        m = pipe.matcher
        return m.mkpts0, m.mkpts1, m.mconf


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("degensac_seeds: no CUDA device")
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from icepy4d_tpu_torch.matching import (GeometricVerification,
                                            geometric_verification)

    print(chip_smoke.card_line())
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for cell in CELLS_PX:
        mk0, mk1, conf = putatives(chip_smoke, cell, EPOCH)
        counts = [int(geometric_verification(
            mk0, mk1, GeometricVerification.PYDEGENSAC, threshold=1.0,
            confidence=0.9999, seed=s, quiet=True, scores=conf)[1].sum())
            for s in range(SEEDS)]
        np.savez_compressed(
            out_dir / f"season_putatives_{cell}px_epoch{EPOCH}.npz",
            mkpts0=mk0, mkpts1=mk1, mconf=conf, inliers=np.array(counts))
        print(json.dumps({"cell_px": cell, "epoch": EPOCH,
                          "putative": len(mk0), "inliers_by_seed": counts}))


if __name__ == "__main__":
    main()
