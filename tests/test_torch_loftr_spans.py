"""The spans and counters of a tiled `LoFTRMatcher.match`: the forward is
the matcher model (`match.model` under `match.matching`, no
`extraction`), its four stages are children of `match.model` whose keys
sum over the call's forwards, and `counters` counts the call's tile
pairs, bucket, forwards, tokens and kept matches. A `LoFTR` built alone
opens no span."""

import numpy as np
import pytest
import torch

from icepy4d_tpu_torch.matching import (GeometricVerification, LoFTRMatcher,
                                        Quality, TileSelection)
from icepy4d_tpu_torch.models.loftr import LoFTR

STAGES = ("backbone", "coarse", "coarse_match", "fine")


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(7)
    img0 = (rng.uniform(0, 255, (96, 128))).astype(np.uint8)
    return img0, np.roll(img0, (8, 8), axis=(0, 1))


def test_tiled_match_spans_and_counters(pair, monkeypatch):
    m = LoFTRMatcher({"seed": 1, "confidence_threshold": 1e-8,
                      "max_matches": 16}, device="cpu")
    # two tile pairs a forward: two forwards over the bucket of 4
    monkeypatch.setattr(m, "_pair_chunk", lambda bucket, th, tw: 2)
    m.match(*pair, quality=Quality.HIGH, tile_selection=TileSelection.GRID,
            grid=[2, 2], overlap=8,
            geometric_verification=GeometricVerification.NONE)
    spans = m.timer.spans
    names = [s.name for s in spans]
    assert "match.extraction" not in names
    model = names.index("match.model")
    assert spans[spans[model].parent].name == "match.matching"
    for stage in STAGES:
        mine = [s for s in spans if s.name == f"match.loftr.{stage}"]
        assert len(mine) == 2 and all(s.parent == model for s in mine)
        assert {s.key for s in mine} == {stage}
        assert m.timer.times[stage] == pytest.approx(
            sum(s.seconds for s in mine))
    assert sum(m.timer.times[s] for s in STAGES) <= m.timer.times["model"]
    # 2x2 GRID of 96x128 with overlap 8: tiles of 56x76, 7x10 cells
    c = m.counters
    assert (c["tile_pairs"], c["bucket"], c["forwards"],
            c["pairs_per_forward"], c["coarse_tokens"]) == (4, 4, 2, 2, 70)
    assert c["matches_kept"] >= len(m.mkpts0) > 0
    assert 0 <= c["pairs_at_cap"] <= 4
    assert c["pairs_at_cap"] * 16 <= c["matches_kept"] <= 4 * 16


def test_a_model_alone_opens_no_span():
    model = LoFTR(max_matches=8, device="cpu")
    assert model.timer is None
    img = torch.rand(1, 32, 32)
    model.match_batch(img, img, np.ones(1, bool))
