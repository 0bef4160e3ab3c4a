"""Tiny CPU runs of each cell's loop, whole and with its timed path
broken underneath."""

import math

import numpy as np
import pytest
import torch

from h100_bench.reference.check import sampson
from h100_bench.tests import bench_tiny
from icepy4d_tpu_torch.matching import matchers
from icepy4d_tpu_torch.matching.matchers import ImageMatcherBase
from icepy4d_tpu_torch.models.lightglue import LightGlue
from icepy4d_tpu_torch.models.superglue import SuperGlue

WORKLOADS = ["sp_lightglue.pairs", "sp_superglue.pairs"]
MODELS = {"sp_lightglue.pairs": LightGlue, "sp_superglue.pairs": SuperGlue}


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [False, True])
def test_run_reports_its_metrics(workload, trace):
    rc, out, checks = bench_tiny.perform(workload, trace=trace)
    assert rc == 0
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert checks and all(math.isfinite(v) for v, _ in checks.values())
    names = set(out["metrics"])
    if trace:
        assert {"extraction_s", "matching_s", "device_idle.pairs",
                "match_mfu"} <= names
        # the CPU runs no kernel: no roofline share is read
        assert "nms_roofline" not in names
        assert out["device"]["window_s"] > 0
        assert len(out["breakdown"]["idle_gaps"]) <= 10
    else:
        assert names == {"setup_s", "pairs_per_min", "pair_s_p90"}


def _half_batch(monkeypatch):
    """Half of the tile pairs masked out before the matcher runs."""
    inner = ImageMatcherBase._match_pair_batch

    def half(self, feats0, feats1, idx0, idx1, pair_valid, size0, size1):
        pv = pair_valid.copy()
        pv[len(pv) // 2:] = False
        return inner(self, feats0, feats1, idx0, idx1, pv, size0, size1)

    monkeypatch.setattr(ImageMatcherBase, "_match_pair_batch", half)


def _altered(monkeypatch, model):
    """Every answer of the matcher moved one column where it is made."""
    inner = model.match

    def match(self, data, attn=None):
        out = dict(inner(self, data, attn))
        k = out["matches0"].shape[1]
        m0 = out["matches0"]
        out["matches0"] = torch.where(m0 >= 0, (m0 + 1) % k, m0)
        la = out["log_assignment"].clone()
        la[:, :-1, :-1] = la[:, :-1, :-1].roll(1, dims=2)
        out["log_assignment"] = la
        return out

    monkeypatch.setattr(model, "match", match)


def _keeps_nothing(monkeypatch):
    """Verification rejects every putative match."""
    inner = matchers.geometric_verification

    def verify(mk0, mk1, **kwargs):
        F, mask = inner(mk0, mk1, **kwargs)
        return F, np.zeros_like(mask)

    monkeypatch.setattr(matchers, "geometric_verification", verify)


def _wrong_f(monkeypatch):
    """Verification returns its F turned by 2 degrees about the centre of
    frame 0's matches, and the inliers of that wrong F."""
    inner = matchers.geometric_verification

    def verify(mk0, mk1, threshold=1.0, **kwargs):
        F, _ = inner(mk0, mk1, threshold=threshold, **kwargs)
        c, s = np.cos(np.radians(2.0)), np.sin(np.radians(2.0))
        cx, cy = mk0.mean(0)
        turn = np.array([[c, -s, cx - c * cx + s * cy],
                         [s, c, cy - s * cx - c * cy], [0.0, 0.0, 1.0]])
        wrong = F @ turn
        return wrong, sampson(wrong, mk0, mk1) < threshold

    monkeypatch.setattr(matchers, "geometric_verification", verify)


# verification only in the LightGlue cell: SuperGlue's random weights
# leave it fewer than the eight putatives it needs
@pytest.mark.parametrize("workload,fault", [
    *((w, f) for w in WORKLOADS for f in ("half_batch", "altered")),
    ("sp_lightglue.pairs", "keeps_nothing"),
    ("sp_lightglue.pairs", "wrong_f")])
def test_a_broken_path_is_not_correct(workload, fault, monkeypatch):
    if fault == "half_batch":
        _half_batch(monkeypatch)
    elif fault == "altered":
        _altered(monkeypatch, MODELS[workload])
    elif fault == "keeps_nothing":
        _keeps_nothing(monkeypatch)
    else:
        _wrong_f(monkeypatch)
    rc, out, checks = bench_tiny.perform(workload)
    assert rc == 0
    assert out["correct"] is False, checks
