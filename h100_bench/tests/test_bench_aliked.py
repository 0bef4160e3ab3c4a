"""The ALIKED-n16 cell on the CPU at the harness tests' size (240 x 320
frames, 2 x 2 EXHAUSTIVE tiles, 128 keypoints a tile): the loop runs,
reads its spans and counters and comes out correct; a planted fault in
the program comes out not correct; `aliked_flops.py` against a hand
count."""

import pytest

from h100_bench import aliked_flops, flops, spec
from h100_bench.tests import bench_tiny
from icepy4d_tpu_torch.models import aliked_n16 as port

WORKLOAD = "aliked_lightglue.exhaustive_pairs"
SPANS = ("aliked_backbone_s", "aliked_dcn_s", "aliked_head_s",
         "aliked_dkd_s", "aliked_sddh_s")


def test_the_tiny_cell_is_correct_and_reads_its_spans(capsys):
    rc, out, checks = bench_tiny.perform(WORKLOAD, trace=True)
    assert rc == 0 and out["correct"] is True
    bench = spec.load()
    config = spec.config(bench, "aliked_lightglue")
    assert set(checks) == set(config["limits"])
    for name in SPANS + ("dcn_roofline", "aliked_mfu", "extraction_s",
                         "model_s"):
        assert out["metrics"][name]["value"] > 0, name
    err = capsys.readouterr().err
    # 4 deformable convolutions an extraction (one chunk of the 4 tiles
    # of each frame on the CPU); 128 keypoints a tile
    assert "counters a pair (dcn, keypoints, offsets_clamped, " \
        "patches_clamped): 8,128-128," in err


def _zero_offsets(monkeypatch):
    """The deformable convolutions read the plain 3x3 taps."""
    inner = port.deform_conv3x3
    monkeypatch.setattr(port, "deform_conv3x3",
                        lambda x, off, w, b=None: inner(x, 0 * off, w, b))


def _swap_sddh_offsets(monkeypatch):
    """SDDH reads its 16 offsets as (y, x) for (x, y)."""
    inner = port._bilinear

    def bilinear(src, py, px, h, w, oy=0, ox=0):
        if src.shape[1] == port.DIM and py.dim() == 3:
            py, px = px, py
        return inner(src, py, px, h, w, oy, ox)

    monkeypatch.setattr(port, "_bilinear", bilinear)


def _hot_softargmax(monkeypatch):
    """DKD's soft-argmax at temperature 1 for 0.1."""
    monkeypatch.setattr(port, "TEMPERATURE", 1.0)


@pytest.mark.parametrize("fault", [_zero_offsets, _swap_sddh_offsets,
                                   _hot_softargmax])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    rc, out, _ = bench_tiny.perform(WORKLOAD)
    assert rc == 0 and out["correct"] is False


def test_flop_and_byte_counts_match_a_hand_count():
    """One tile of 60 x 90 (padded to 64 x 96), 10 keypoints."""
    cfg = spec.config(spec.load(), "aliked_lightglue")["extractor"]
    hand = 2 * (
        64 * 96 * (3 * 16 * 9 + 16 * 16 * 9)                   # block1
        + 32 * 48 * (16 * 32 * 9 + 32 * 32 * 9 + 16 * 32)      # block2
        + 8 * 12 * (32 * 18 * 9 + 32 * 64 * 9                  # block3
                    + 64 * 18 * 9 + 64 * 64 * 9 + 32 * 64)
        + 2 * 3 * (64 * 18 * 9 + 64 * 128 * 9                  # block4
                   + 128 * 18 * 9 + 128 * 128 * 9 + 64 * 128)
        + 64 * 96 * 16 * 32 + 32 * 48 * 32 * 32               # aggregation
        + 8 * 12 * 64 * 32 + 2 * 3 * 128 * 32
        + 64 * 96 * (128 * 8 + 8 * 4 * 9 + 4 * 4 * 9 + 4 * 9)  # score head
        + 10 * (128 * 9 * 32 + 32 * 32 + 2 * 16 * 128 * 128))  # SDDH
    assert aliked_flops.extractor_flops(cfg, 60, 90, 10) == hand
    dcn_bytes = 4 * (8 * 12 * (32 + 18 + 64) + 8 * 12 * (64 + 18 + 64)
                     + 2 * 3 * (64 + 18 + 128) + 2 * 3 * (128 + 18 + 128))
    assert aliked_flops.dcn_bytes(cfg, 60, 90) == dcn_bytes
    dcn = 2 * (8 * 12 * (32 * 18 * 9 + 32 * 64 * 9 + 64 * 18 * 9
                         + 64 * 64 * 9)
               + 2 * 3 * (64 * 18 * 9 + 64 * 128 * 9 + 128 * 18 * 9
                          + 128 * 128 * 9))
    assert aliked_flops.dcn_flops(cfg, 60, 90) == dcn
    assert flops.lower_bound(dcn_bytes, dcn)[1] == "bytes"
