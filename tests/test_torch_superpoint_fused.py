"""SuperPoint's fused trunk on the card against its plain trunk.

On a CUDA input with autograd off, `SuperPointNet.forward` runs each 3x3
convolution that a ReLU follows as one cuDNN convolution-bias-ReLU over
channels-last activations; elsewhere it runs the plain conv, bias and
ReLU in NCHW (the CPU side is held against the JAX package in
`test_torch_superpoint.py`); conv1a, one f32 input channel, runs as four
TF32 channels (`split_tf32`) where TF32 is on. Here the two run on the same (bundled)
weights and frames: with TF32 off the logits and descriptors agree to
1e-5 of their largest magnitude, and the heat maps as closely as the
softmax lets the logits' gap through; with TF32 on, and with bf16
activations, the fused side lies no further from the exact (f32, TF32
off) run than twice the plain side does. Also: every output
is finite, also where the fused op's output block last held NaN or inf
(cuDNN reads it as the graph's `z` operand, with alpha 0); a forward
that records a graph takes the plain path and its backward runs;
`fused_convs` counts 10 a forward.

The card's test runs where JAX is not installed:
python -m pytest --noconftest -m cuda tests/test_torch_superpoint_fused.py
"""

import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

from icepy4d_tpu_torch.device import full_f32_matmul
from icepy4d_tpu_torch.models.convert import (load_params,
                                              superpoint_state_dict)
from icepy4d_tpu_torch.models.superpoint import SuperPoint, SuperPointNet
from torch_port_inputs import shifted_pair

WEIGHTS = Path(__file__).resolve().parents[1] / "weights" / \
    "superpoint_synthetic.npz"
FUSED = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
         "conv4a", "conv4b", "convPa", "convDa")
CL = torch.channels_last


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state() -> dict:
    return superpoint_state_dict(load_params(WEIGHTS))


def _nets(dev, dtype):
    """(plain, fused): NCHW weights as training holds them, and
    channels-last ones as `SuperPoint` puts them on the card."""
    plain = SuperPointNet().to(dev, dtype)
    fused = SuperPointNet().to(dev, dtype, memory_format=CL)
    for net in (plain, fused):
        net.load_state_dict(_state())
        net.eval().requires_grad_(False)
    return plain, fused


def _frames(b, h, w, dev) -> torch.Tensor:
    a, c = shifted_pair(h, w)
    x = np.stack([a, c][:b]).astype(np.float32) / 255.0
    return torch.from_numpy(x)[:, None].to(dev)


def _run(net, x, fused: bool, tf32: bool, raw: bool = False):
    mode = torch.inference_mode() if fused else torch.enable_grad()
    with mode, (contextlib.nullcontext() if tf32 else full_f32_matmul()):
        return net(x, raw=raw)


def _diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return _diff(a, b) / float(b.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("bhw", [(1, 120, 200), (2, 200, 136)], ids=str)
@pytest.mark.parametrize("dtype,tf32", [
    (torch.float32, False), (torch.float32, True), (torch.bfloat16, False),
    (torch.bfloat16, True)], ids=["f32", "f32-tf32", "bf16", "bf16-tf32"])
def test_fused_trunk_equals_plain(cuda, bhw, dtype, tf32):
    x = _frames(*bhw, cuda)
    plain, fused = _nets(cuda, dtype)
    n0 = SuperPointNet.fused_convs
    heat_f, desc_f = _run(fused, x, True, tf32)
    assert SuperPointNet.fused_convs - n0 == len(FUSED)
    heat_p, desc_p = _run(plain, x, False, tf32)
    assert SuperPointNet.fused_convs - n0 == len(FUSED)

    b, h, w = bhw
    assert heat_f.shape == (b, h, w) and heat_f.is_contiguous()
    assert heat_f.dtype == desc_f.dtype == torch.float32
    assert desc_f.shape == (b, 256, h // 8, w // 8)
    assert desc_f.is_contiguous(memory_format=CL)
    for t in (heat_f, desc_f, heat_p, desc_p):
        assert torch.isfinite(t).all()

    if dtype == torch.float32 and not tf32:
        logits_f, _ = _run(fused, x, True, tf32, raw=True)
        logits_p, _ = _run(plain, x, False, tf32, raw=True)
        assert _gap(logits_f, logits_p) <= 1e-5
        assert _gap(desc_f, desc_p) <= 1e-5
        # a softmax moves no probability by more than twice the largest
        # change of a logit
        assert _diff(heat_f, heat_p) <= 2 * _diff(logits_f, logits_p)
        return
    exact, _ = _nets(cuda, torch.float32)
    heat_x, desc_x = _run(exact, x, False, False)
    for got, plain_out, want in ((heat_f, heat_p, heat_x),
                                 (desc_f, desc_p, desc_x)):
        need = _gap(plain_out, want)
        assert 0 < need and _gap(got, want) <= 2 * need, (
            _gap(got, want), need)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("fill", [float("nan"), float("inf")], ids=str)
def test_fused_layer_ignores_what_its_output_block_held(cuda, dtype, fill):
    """The fused op hands cuDNN its uninitialised output as `z`, with
    alpha 0: a block that last held NaN or inf must not reach the
    result. Each layer's output block is poisoned first and reused."""
    _, net = _nets(cuda, dtype)
    x = _frames(2, 96, 160, cuda).to(dtype).to(memory_format=CL)
    with torch.inference_mode():
        for name in FUSED:
            conv = getattr(net, name)
            if conv.in_channels != x.shape[1]:          # the heads' input
                x = torch.rand((2, conv.in_channels, 12, 20), device=cuda,
                               dtype=dtype).to(memory_format=CL)
            with full_f32_matmul():
                want = torch.relu(torch.conv2d(
                    x.contiguous(), conv.weight.contiguous(), conv.bias,
                    padding=1))
            junk = torch.full_like(want, fill, memory_format=CL)
            ptr = junk.data_ptr()
            del junk
            with full_f32_matmul():
                got = SuperPointNet._conv_relu_fused(conv, x)
            assert got.data_ptr() == ptr, name        # the poisoned block
            assert torch.isfinite(got).all(), name
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            assert _gap(got, want) <= tol, name
            x = got if name[-1] == "a" else torch.max_pool2d(got, 2, 2)


@pytest.mark.cuda
def test_grad_enabled_forward_takes_plain_path_and_backward_runs(cuda):
    net = SuperPointNet().to(cuda)
    net.load_state_dict(_state())
    x = _frames(2, 64, 96, cuda)
    n0 = SuperPointNet.fused_convs
    logits, desc = net(x, raw=True)
    assert SuperPointNet.fused_convs == n0
    assert logits.is_contiguous() and desc.is_contiguous()
    (logits.square().mean() + desc.sum()).backward()
    for p in net.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()
    assert float(net.conv1a.weight.grad.abs().sum()) > 0


@pytest.mark.cuda
def test_extract_and_describe_at_count_fused_convs(cuda):
    sp = SuperPoint(max_keypoints=128, device=cuda).load_state_dict(_state())
    assert sp.net.conv1b.weight.is_contiguous(memory_format=CL)
    images = _frames(2, 117, 150, cuda)[:, 0]       # padded to 120 x 152
    n0 = SuperPointNet.fused_convs
    out = sp.extract(images)
    assert SuperPointNet.fused_convs - n0 == len(FUSED)
    assert int(out["mask"].sum()) > 50
    assert torch.isfinite(out["descriptors"]).all()
    desc = sp.describe_at(images, out["keypoints"])
    assert SuperPointNet.fused_convs - n0 == 2 * len(FUSED)
    m = out["mask"]
    assert torch.allclose(desc[m], out["descriptors"][m], atol=1e-6)
