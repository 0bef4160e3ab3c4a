"""LoFTR's plain reference against the port's `LoFTR.match_batch` on the
CPU in float32 (no TF32 here), on `random_tree` weights loaded through
`models.convert.loftr_params`, at 2 tile pairs of 96 x 128; and tiny
runs of the LoFTR cell whose program carries a planted fault, each of
which the check must find.

Tolerances, each above what float32 reorderings give and far below what
a slip in the arithmetic gives:
  backbone maps   1e-4 of their largest magnitude: the port's batch norm
                  is (x - mean) * (rsqrt(var + eps) * scale) + bias and
                  its upsampling an index-select lerp, the reference's
                  `F.batch_norm` and `F.interpolate`
  confidences     1e-4 relative to the largest: the port's position
                  encoding is float64 cast to float32, the reference's
                  float32 as published
  match sets      equal
  fine keypoints  1e-3 px (a fine cell is 2 px)
"""

import time

import numpy as np
import pytest
import torch

from h100_bench import run, spec, weights
from h100_bench.reference import loftr as ref
from h100_bench.reference import loftr_check as check
from h100_bench.tests import bench_tiny
from icepy4d_tpu_torch.models import loftr as port
from icepy4d_tpu_torch.models.convert import loftr_params

WORKLOAD = "loftr_outdoor.grid_pairs"
THR = 1e-8
F32 = {"backbone": "f32", "transformer": "f32", "similarity": "f32"}


def tiny_cell() -> tuple:
    """(BENCHMARK.json, config, traffic) of the LoFTR cell cut to the
    harness tests' frames: 240 x 320, 2 x 2 GRID tiles of 160 x 200."""
    bench = spec.load()
    c = spec.cell(bench, WORKLOAD)
    traffic = dict(spec.traffic(c["traffic"]), height=240, width=320,
                   focal_px=320.0, baseline_m=10.0, cell_px=10.0, grid=[2, 2],
                   overlap=20, pairs=2, check_pairs=1, trace_seconds=0.0)
    return bench, spec.config(bench, c["config"]), traffic


def perform() -> tuple:
    """A whole run of the cut-down cell on the CPU, one item long."""
    bench, config, traffic = tiny_cell()
    return run.perform(bench, WORKLOAD, config, traffic, bench_tiny.SEED,
                       1e-6, False, bench_tiny.CPU, time.perf_counter())


@pytest.fixture(scope="module")
def cfg():
    return tiny_cell()[1]["matcher"]


@pytest.fixture(scope="module")
def trees(cfg):
    gen = torch.Generator().manual_seed(3)
    tree = ref.random_tree(gen, "cpu", cfg)
    return tree, weights.to_host(tree)


@pytest.fixture(scope="module")
def images():
    gen = torch.Generator().manual_seed(5)
    low = torch.rand(2, 1, 12, 16, generator=gen)
    img0 = torch.nn.functional.interpolate(low, size=(96, 128),
                                           mode="bicubic").clamp(0, 1)[:, 0]
    img1 = torch.roll(img0, (8, 16), (1, 2))
    return img0, img1


@pytest.fixture(scope="module")
def model(trees):
    m = port.LoFTR(thr=THR, max_matches=64, precision="highest",
                   device="cpu")
    return m.load_state_dict(loftr_params(trees[1]))


def test_backbone_and_confidences_match(cfg, trees, images, model):
    img0, img1 = images
    with torch.inference_mode():
        pc, pf = model.net.backbone(img0[:, None])
        rc, rf = ref.backbone(trees[0]["backbone"], img0[:, None], "f32")
        for a, b in ((pc, rc), (pf, rf)):
            assert a.shape == b.shape
            assert (a - b).abs().max() <= 1e-4 * b.abs().max()
        cells = torch.ones(2, 12 * 16, dtype=torch.bool)
        c0, c1, *_ = model.coarse_features(img0, img1, cells, cells)
        conf = model.coarse_confidence(c0, c1, cells, cells)
    for p in range(2):
        r = ref.forward(trees[0], img0[p], img1[p], cfg, F32, THR, 64,
                        keep_conf=True)["conf_matrix"]
        assert (conf[p] - r).abs().max() <= 1e-4 * r.max()


def test_matches_and_fine_keypoints_match(cfg, trees, images, model):
    img0, img1 = images
    out = model.match_batch(img0, img1, np.ones(2, bool))
    n = 0
    for p in range(2):
        r = ref.forward(trees[0], img0[p], img1[p], cfg, F32, THR, 64)
        v = out["valid"][p]
        got = {tuple(k.tolist()): (kp1, c) for k, kp1, c in zip(
            out["keypoints0"][p][v], out["keypoints1"][p][v],
            out["confidence"][p][v])}
        want = {tuple(k.tolist()): (kp1, c) for k, kp1, c in zip(
            r["kpts0"], r["kpts1"], r["conf"])}
        assert got.keys() == want.keys()
        for k, (kp1, c) in want.items():
            assert (got[k][0] - kp1).abs().max() <= 1e-3
            assert abs(float(got[k][1] - c)) <= 1e-4 * float(c)
        n += len(want)
    assert n >= 20


def test_the_tiny_cell_is_correct():
    rc, out, checks = perform()
    assert rc == 0 and out["correct"] is True
    assert set(checks) == {"coarse_flip", "conf_err", "fine_px"}


def _shift_fine(monkeypatch):
    """Every refined frame-1 keypoint 1 px off."""
    inner = port.LoFTR._fine

    def fine(self, *args):
        out = inner(self, *args)
        out["keypoints1"] = out["keypoints1"] + 1.0
        return out

    monkeypatch.setattr(port.LoFTR, "_fine", fine)


def _drop_pair(monkeypatch):
    """The coarse matches of the batch's first tile pair dropped."""
    inner = port.LoFTR.match_batch

    def match_batch(self, *args):
        out = inner(self, *args)
        out["valid"] = out["valid"].clone()
        out["valid"][0] = False
        return out

    monkeypatch.setattr(port.LoFTR, "match_batch", match_batch)


def _bn_eps(monkeypatch):
    """Batch norm's eps 1e-3 for the published 1e-5."""
    monkeypatch.setattr(port, "BN_EPS", 1e-3)


@pytest.mark.parametrize("fault", [_shift_fine, _drop_pair, _bn_eps])
def test_a_planted_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    rc, out, checks = perform()
    assert rc == 0 and out["correct"] is False


def test_the_controls_round_the_reference_products():
    """`control` rounds every product's operands to bfloat16 and
    `stated` to the configuration's precisions (TF32); both then read
    above the float32 reference, bfloat16 the farther."""
    _, config, traffic = tiny_cell()
    tree = ref.random_tree(torch.Generator().manual_seed(3), "cpu",
                           config["matcher"])
    stated = config["matcher"]["precision"]
    bf16 = check.control(config, traffic, tree, "cpu")
    tf32 = check.stated(config, traffic, tree, "cpu")
    assert bf16.precisions == {k: "bf16" for k in stated}
    assert tf32.precisions == stated == {k: "tf32" for k in stated}
    gen = torch.Generator().manual_seed(5)
    low = torch.rand(1, 1, 24, 32, generator=gen)
    img0 = (255 * torch.nn.functional.interpolate(
        low, size=(240, 320), mode="bicubic").clamp(0, 1))[0, 0].to(
        torch.uint8).numpy()
    img1 = np.roll(img0, (10, 20), axis=(0, 1))
    ref_rec, got_bf16, got_tf32 = check.judge(
        check.Reference(config, traffic, tree, "cpu"), img0, img1,
        [check.reference_record(r, img0, img1) for r in (
            check.Reference(config, traffic, tree, "cpu"), bf16, tf32)])
    assert ref_rec["coarse_flip"] == ref_rec["conf_err"] == 0.0
    assert ref_rec["reference_matches"] > 0
    for k in ("conf_err", "fine_px"):
        assert 0.0 < got_tf32[k] < got_bf16[k]
