"""The plain references against the port's plain paths on the CPU, in
float32 (the port's own CPU dispatch: no kernel), at small sizes."""

import numpy as np
import pytest
import torch

from h100_bench import weights
from h100_bench.reference import lightglue, superglue, superpoint
from icepy4d_tpu_torch.models.convert import (lightglue_params, load_params,
                                              superglue_params,
                                              superpoint_state_dict)
from icepy4d_tpu_torch.models.lightglue import LightGlue
from icepy4d_tpu_torch.models.superglue import SuperGlue
from icepy4d_tpu_torch.models.superpoint import SuperPoint

F32 = {"trunk": "f32", "attention": "f32", "assignment": "f32"}


def _npz(name):
    from h100_bench import spec

    return spec.ROOT / "weights" / name


def _pairs(m, n, d, gen):
    return {"kpts0": torch.rand(2, m, 2, generator=gen) * 300,
            "kpts1": torch.rand(2, n, 2, generator=gen) * 300,
            "desc0": torch.nn.functional.normalize(
                torch.randn(2, m, d, generator=gen), dim=-1),
            "desc1": torch.nn.functional.normalize(
                torch.randn(2, n, d, generator=gen), dim=-1),
            "scores0": torch.rand(2, m, generator=gen),
            "scores1": torch.rand(2, n, generator=gen),
            "mask0": torch.rand(2, m, generator=gen) > 0.1,
            "mask1": torch.rand(2, n, generator=gen) > 0.1,
            "size0": torch.tensor([[360.0, 280.0]] * 2),
            "size1": torch.tensor([[360.0, 280.0]] * 2)}


def test_superpoint_matches_the_port():
    tree = weights.to_device(weights.load_npz(_npz("superpoint_synthetic.npz")),
                             "cpu")["params"]
    sp = SuperPoint(max_keypoints=128, detection_threshold=0.0005,
                    nms_radius=4, device="cpu")
    sp.load_state_dict(superpoint_state_dict(load_params(
        _npz("superpoint_synthetic.npz"))))
    img = torch.rand(1, 96, 128, generator=torch.Generator().manual_seed(0))
    img = torch.nn.functional.avg_pool2d(img[None], 3, 1, 1)[0]
    port = sp.extract(img)
    ref = superpoint.extract(tree, img, 128, 0.0005, 4)
    key = [{tuple(p) for p in f["keypoints"][0][f["mask"][0]].tolist()}
           for f in (port, ref)]
    assert key[0] == key[1] and len(key[0]) > 50
    order = [np.lexsort(f["keypoints"][0].numpy().T) for f in (port, ref)]
    d0 = port["descriptors"][0][order[0]]
    d1 = ref["descriptors"][0][order[1]]
    assert torch.allclose(d0, d1, atol=1e-5)


def test_lightglue_matches_the_port():
    path = _npz("lightglue_synthetic.npz")
    tree = weights.to_device(weights.load_npz(path), "cpu")
    lg = LightGlue(activation_dtype="float32", device="cpu")
    lg.load_state_dict(lightglue_params(load_params(path)))
    data = _pairs(48, 64, 256, torch.Generator().manual_seed(1))
    port = lg.match(data)["log_assignment"]
    ref = lightglue.log_assignment(tree, data, F32)
    valid = port > -1e8
    assert torch.equal(valid, ref > -1e8)
    # both float32; sums run in another order (the port's attention
    # offsets by a power of two)
    assert (port - ref)[valid].abs().max() < 0.05


def test_superglue_matches_the_port():
    tree = superglue.random_tree(torch.Generator().manual_seed(2), "cpu", {
        "descriptor_dim": 256, "keypoint_encoder": [32, 64, 128, 256],
        "gnn_layers": 4})
    sg = SuperGlue(gnn_layers=4, sinkhorn_iterations=20, device="cpu")
    sg.load_state_dict(superglue_params(weights.to_host(tree)))
    data = _pairs(48, 64, 256, torch.Generator().manual_seed(3))
    port = sg.match(data)["log_assignment"]
    ref = superglue.log_assignment(tree, data, {"trunk": "f32",
                                                "attention": "f32"})
    valid = port > -1e8
    assert (port - ref)[valid].abs().max() < 1e-3


@pytest.mark.parametrize("precision,bits", [("tf32", 10), ("bf16", 7),
                                             ("fp8", 3)])
def test_rounding_keeps_the_mantissa_bits(precision, bits):
    from h100_bench.reference.precision import round_to

    x = torch.linspace(1.0, 2.0, 4097)
    err = (round_to(x, precision) - x).abs().max()
    assert err <= 2.0 ** -(bits + 1) + 1e-9
    assert err >= 2.0 ** -(bits + 2)
