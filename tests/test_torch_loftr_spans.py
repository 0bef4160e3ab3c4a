"""The spans and counters of a tiled `LoFTRMatcher.match`: the forward is
the matcher model (`match.model` under `match.matching`, no
`extraction`), its four stages are children of `match.model` whose keys
sum over the call's forwards, and `counters` counts the call's tile
pairs, bucket, forwards, tokens and kept matches. A `LoFTR` built alone
opens no span. The tile pairs run unpadded, in forwards whose sizes
differ by at most one, and give what one tile pair a forward gives; on
a card, a forward at the chunk `_pair_chunk` picks allocates no more
than it budgets (python -m pytest --noconftest -m cuda
tests/test_torch_loftr_spans.py)."""

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
    # two tile pairs a forward: two forwards over the 4 tile pairs
    monkeypatch.setattr(m, "_pair_chunk", lambda n, th, tw: 2)
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


def _run(pair, monkeypatch, chunk):
    """A 2x3 GRID match (6 tile pairs) at `chunk` tile pairs a forward:
    the matcher, each forward's batch size and what the forwards
    returned, concatenated."""
    m = LoFTRMatcher({"seed": 1, "confidence_threshold": 1e-8,
                      "max_matches": 16}, device="cpu")
    monkeypatch.setattr(m, "_pair_chunk", lambda n, th, tw: min(n, chunk))
    inner = m.matcher.match_batch
    outs = []

    def match_batch(imgs0, imgs1, pair_valid):
        outs.append(inner(imgs0, imgs1, pair_valid))
        return outs[-1]

    monkeypatch.setattr(m.matcher, "match_batch", match_batch)
    m.match(*pair, quality=Quality.HIGH, tile_selection=TileSelection.GRID,
            grid=[3, 2], overlap=8,
            geometric_verification=GeometricVerification.NONE)
    sizes = [len(o["valid"]) for o in outs]
    return m, sizes, {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def test_tile_pairs_run_unpadded_in_even_forwards(pair, monkeypatch):
    m, sizes, got = _run(pair, monkeypatch, chunk=4)
    c = m.counters
    # 6 tile pairs at most 4 a forward: 2 forwards of 3, not 4 and 2
    assert (c["tile_pairs"], c["bucket"], c["forwards"],
            c["pairs_per_forward"]) == (6, 6, 2, 3)
    assert sizes == [3, 3]
    _, ones, want = _run(pair, monkeypatch, chunk=1)
    assert ones == [1] * 6
    assert got["valid"].any()
    # the same matches; a batch of 3 rounds its f32 products in another
    # order than a batch of 1, so the refined keypoints and the
    # confidences (scores times 1 / temperature inside exp) agree to f32
    # rounding
    for k in ("keypoints0", "valid"):
        assert torch.equal(got[k], want[k]), k
    torch.testing.assert_close(got["keypoints1"], want["keypoints1"],
                               rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got["confidence"], want["confidence"],
                               rtol=1e-4, atol=0.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_forward_stays_within_its_budget(cuda):
    """The benchmark cell's 5x5 GRID of 1600x1200 tiles: a forward at the
    chunk `_pair_chunk` picks for its 25 tile pairs allocates no more
    than the chunk's budgeted bytes, which fit half the free memory."""
    m = LoFTRMatcher({"seed": 1, "confidence_threshold": 1e-8,
                      "max_matches": 1024}, device=cuda)
    th, tw = 1200, 1600
    g = torch.Generator(device=cuda).manual_seed(0)
    warm = torch.rand(1, th, tw, generator=g, device=cuda)
    m.matcher.match_batch(warm, warm.roll(8, 2), np.ones(1, bool))
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    budget = (torch.cuda.mem_get_info(cuda)[0]
              + torch.cuda.memory_reserved(cuda)
              - torch.cuda.memory_allocated(cuda)) // 2
    chunk = m._pair_chunk(25, th, tw)
    budgeted = chunk * th * tw * m.CARD_BYTES_PER_PIXEL
    assert 1 < chunk < 25 and budgeted <= budget
    imgs = torch.rand(chunk, th, tw, generator=g, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    out = m.matcher.match_batch(imgs, imgs.roll(8, 2), np.ones(chunk, bool))
    torch.cuda.synchronize()
    used = torch.cuda.max_memory_allocated(cuda) - base
    assert out["valid"].any()
    assert used <= budgeted, (chunk, used, budgeted)
