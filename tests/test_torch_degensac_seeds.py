"""Both DEGENSACs on the putative matches of the full-size synthetic season.

The files in tests/data hold the putatives of epoch 1 of `chip_smoke.py`'s
season (6012x4008, 2x2 EXHAUSTIVE tiles, 4096 keypoints a tile), once
with 10-px and once with 24-px texture cells, as
`scripts/degensac_seeds.py` wrote them on an H100, with the port's
inlier count there for seeds 0-15. Both packages run the matcher's
PYDEGENSAC (1 px, confidence 0.9999, match confidences as guidance) on
them here. The two draw their samples from different generators, so
the counts are compared by seed only in spread:

- 24-px cells: every seed of both packages keeps a consensus within 1%
  of the card's median;
- 10-px cells: the consensus moves with the seed in the JAX package as
  it does in the port (the largest count over the first four seeds is
  more than twice the smallest in both), and neither exceeds the card's
  largest consensus by more than 2%: the swing lies in the putatives,
  not in the port.
"""

from pathlib import Path

import numpy as np
import pytest

from icepy4d_tpu.matching.enums import GeometricVerification as JGV
from icepy4d_tpu.matching.geometric_verification import (
    geometric_verification as jax_gv)
from icepy4d_tpu_torch.matching import (GeometricVerification,
                                        geometric_verification)

DATA = Path(__file__).resolve().parent / "data"


def _counts(cell: int, seeds: int):
    d = np.load(DATA / f"season_putatives_{cell}px_epoch1.npz")
    args = (d["mkpts0"], d["mkpts1"])
    kw = dict(threshold=1.0, confidence=0.9999, scores=d["mconf"],
              quiet=True)
    jax = [int(jax_gv(*args, JGV.PYDEGENSAC, seed=s, **kw)[1].sum())
           for s in range(seeds)]
    port = [int(geometric_verification(
        *args, GeometricVerification.PYDEGENSAC, seed=s, device="cpu",
        **kw)[1].sum()) for s in range(seeds)]
    return np.array(jax), np.array(port), d["inliers"]


@pytest.mark.parametrize("cell,seeds", [(24, 2), (10, 4)])
def test_degensac_seed_spread_matches_reference(cell, seeds):
    jax, port, card = _counts(cell, seeds)
    if cell == 24:
        ref = np.median(card)
        for counts in (jax, port, card):
            np.testing.assert_allclose(counts, ref, rtol=0.01)
    else:
        for counts in (jax, port):
            assert counts.max() > 2 * counts.min(), (jax, port)
            assert counts.max() <= 1.02 * card.max(), (jax, port, card)
