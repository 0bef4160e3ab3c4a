"""The benchmark's FLOP counts against `torch.utils.flop_counter` run over
its own plain references at small widths."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import flops
from h100_bench.reference import lightglue, superglue, superpoint

GEN = torch.Generator().manual_seed(0)


def dense(i, o):
    return {"kernel": torch.randn(i, o, generator=GEN) / i ** 0.5,
            "bias": torch.zeros(o)}


def counted(fn) -> float:
    with FlopCounterMode(display=False) as fc:
        fn()
    return float(fc.get_total_flops())


def test_superpoint():
    cfg = {"channels": [8, 8, 16, 16], "head_dim": 32, "descriptor_dim": 24}
    c1, c2, c3, c4 = cfg["channels"]
    shapes = {"conv1a": (1, c1), "conv1b": (c1, c1), "conv2a": (c1, c2),
              "conv2b": (c2, c2), "conv3a": (c2, c3), "conv3b": (c3, c3),
              "conv4a": (c3, c4), "conv4b": (c4, c4), "convPa": (c4, 32),
              "convDa": (c4, 32)}
    tree = {k: {"kernel": torch.randn(3, 3, i, o, generator=GEN),
                "bias": torch.zeros(o)} for k, (i, o) in shapes.items()}
    tree["convPb"] = {"kernel": torch.randn(1, 1, 32, 65, generator=GEN),
                      "bias": torch.zeros(65)}
    tree["convDb"] = {"kernel": torch.randn(1, 1, 32, 24, generator=GEN),
                      "bias": torch.zeros(24)}
    img = torch.rand(1, 64, 96, generator=GEN)
    got = counted(lambda: superpoint.dense_maps(tree, img))
    assert superpoint.flops(cfg, 64, 96) == pytest.approx(got, rel=0.05)


def _data(m, n, d):
    return {"kpts0": torch.rand(1, m, 2, generator=GEN) * 100,
            "kpts1": torch.rand(1, n, 2, generator=GEN) * 100,
            "desc0": torch.randn(1, m, d, generator=GEN),
            "desc1": torch.randn(1, n, d, generator=GEN),
            "scores0": torch.rand(1, m, generator=GEN),
            "scores1": torch.rand(1, n, generator=GEN),
            "mask0": torch.ones(1, m, dtype=torch.bool),
            "mask1": torch.ones(1, n, dtype=torch.bool),
            "size0": torch.tensor([[100.0, 100.0]]),
            "size1": torch.tensor([[100.0, 100.0]])}


def test_lightglue():
    d, heads, layers, m, n = 32, 4, 2, 40, 56
    cfg = {"descriptor_dim": d, "num_heads": heads, "n_layers": layers,
           "input_proj": True}

    def ffn():
        return {"dense1": dense(2 * d, 2 * d), "dense2": dense(2 * d, d),
                "norm": {"scale": torch.ones(2 * d),
                         "bias": torch.zeros(2 * d)}}

    tree = {"input_proj": dense(d, d),
            "posenc": {"Wr": {"kernel": torch.randn(2, d // heads // 2,
                                                    generator=GEN)}},
            "layers": [{"self_attn": {"Wqkv": dense(d, 3 * d),
                                      "out": dense(d, d), "ffn": ffn()},
                        "cross_attn": {"to_qk": dense(d, d),
                                       "to_v": dense(d, d),
                                       "out": dense(d, d), "ffn": ffn()}}
                       for _ in range(layers)],
            "assign": [{"final_proj": dense(d, d),
                        "matchability": dense(d, 1)} for _ in range(layers)]}
    prec = {"trunk": "f32", "attention": "f32", "assignment": "f32"}
    got = counted(lambda: lightglue.log_assignment(tree, _data(m, n, d),
                                                   prec, heads=heads))
    assert lightglue.flops(cfg, m, n) == pytest.approx(got, rel=0.05)


def test_superglue():
    d, heads, layers, m, n = 32, 4, 4, 40, 56
    cfg = {"descriptor_dim": d, "num_heads": heads, "gnn_layers": layers,
           "keypoint_encoder": [8, 16]}
    tree = superglue.random_tree(torch.Generator().manual_seed(1), "cpu", cfg)
    prec = {"trunk": "f32", "attention": "f32"}
    got = counted(lambda: superglue.log_assignment(
        tree, _data(m, n, d), prec, heads=heads, sinkhorn_iterations=3))
    assert superglue.flops(cfg, m, n) == pytest.approx(got, rel=0.05)


def test_bounds():
    # the LightGlue launch of PERF.md's kernel table: (16, 4, 4096, 4096)
    s, what = flops.lower_bound(
        flops.attention_bytes(16, 4, 4096, 4096, 64),
        flops.attention(16, 4, 4096, 4096, 64))
    assert what == "operations" and s == pytest.approx(0.278e-3, rel=0.01)
    s, what = flops.lower_bound(flops.nms_bytes(2, 2400, 3400), 0.0)
    assert what == "bytes" and s == pytest.approx(0.0390e-3, rel=0.01)
