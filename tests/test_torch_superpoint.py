"""Port SuperPoint == icepy4d_tpu's on the same random weights, f32 at
"highest" matmul precision (1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.models.superpoint import SuperPoint as JSuperPoint
from icepy4d_tpu_torch.models.convert import superpoint_state_dict
from icepy4d_tpu_torch.models.superpoint import (SuperPoint, SuperPointNet,
                                               split_tf32)
from torch_port_inputs import shifted_pair, superpoint_tree


@pytest.fixture(scope="module")
def models():
    tree = superpoint_tree(seed=1)
    ref = JSuperPoint(max_keypoints=200, precision="highest")
    port = SuperPoint(max_keypoints=200, device="cpu").load_state_dict(
        superpoint_state_dict(tree))
    return ref, jax.tree.map(jnp.asarray, tree), port


@pytest.fixture(scope="module")
def images():
    a, b = shifted_pair(117, 150)       # not multiples of 8: pad band
    return (np.stack([a, b]) / 255.0).astype(np.float32)


def test_dense_outputs_match(models, images):
    ref, params, port = models
    x = np.pad(images, ((0, 0), (0, 3), (0, 2)))[..., None]
    with jax.default_matmul_precision("highest"):
        heat_j, desc_j = ref.net.apply(params, jnp.asarray(x))
    with torch.inference_mode():
        heat_p, desc_p = port.net(torch.from_numpy(x[..., 0])[:, None])
    np.testing.assert_allclose(heat_p.numpy(), np.asarray(heat_j),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(desc_p.permute(0, 2, 3, 1).numpy(),
                               np.asarray(desc_j), atol=1e-4, rtol=1e-4)


def test_extract_matches(models, images):
    ref, params, port = models
    out_j = ref.extract(params, jnp.asarray(images))
    out_p = port.extract(torch.from_numpy(images))
    mask = np.asarray(out_j["mask"])
    assert mask.sum() > 50
    np.testing.assert_array_equal(out_p["mask"].numpy(), mask)
    np.testing.assert_array_equal(out_p["keypoints"].numpy(),
                                  np.asarray(out_j["keypoints"]))
    np.testing.assert_allclose(out_p["scores"].numpy(),
                               np.asarray(out_j["scores"]), atol=1e-6)
    np.testing.assert_allclose(out_p["descriptors"].numpy(),
                               np.asarray(out_j["descriptors"]), atol=1e-4)


def _nchw_forward(net, x):
    """The trunk as plain NCHW conv, bias and ReLU layers."""
    relu = torch.nn.functional.relu
    pool = torch.nn.functional.max_pool2d
    for a, b in ((net.conv1a, net.conv1b), (net.conv2a, net.conv2b),
                 (net.conv3a, net.conv3b)):
        x = pool(relu(b(relu(a(x)))), 2, 2)
    x = relu(net.conv4b(relu(net.conv4a(x))))
    logits = net.convPb(relu(net.convPa(x)))
    desc = net.convDb(relu(net.convDa(x)))
    desc = desc / desc.norm(dim=1, keepdim=True).clamp_min(1e-12)
    heat = torch.nn.functional.pixel_shuffle(
        torch.softmax(logits, dim=1)[:, :64], 8)[:, 0]
    return heat, desc


@pytest.mark.parametrize("grad", [False, True], ids=["inference", "grad"])
def test_cpu_and_grad_forwards_stay_plain(models, images, grad):
    """A CPU input runs the plain NCHW trunk with autograd off or on, and
    counts no fused convolution (the fused one runs on the card only)."""
    _, _, port = models
    x = torch.from_numpy(np.pad(images, ((0, 0), (0, 3), (0, 2))))[:, None]
    n0 = SuperPointNet.fused_convs
    mode = torch.enable_grad() if grad else torch.inference_mode()
    with mode:
        heat, desc = port.net(x)
    assert SuperPointNet.fused_convs == n0
    with torch.no_grad():
        heat_r, desc_r = _nchw_forward(port.net, x)
    assert heat.is_contiguous() and desc.is_contiguous()
    assert torch.equal(heat.detach(), heat_r)
    assert torch.equal(desc.detach(), desc_r)


def _tf32_round(t):
    """f32 rounded to nearest on TF32's 10 mantissa bits, as the tensor
    cores read an operand."""
    return ((t.view(torch.int32) + (1 << 12)) & -(1 << 13)).view(
        torch.float32)


@pytest.mark.parametrize("bhw", [(2, 40, 56), (1, 24, 80)], ids=str)
def test_split_tf32_convolution_is_f32_close(bhw):
    """conv1a's four-channel form: hi + lo is x exactly, hi survives
    TF32 unrounded, and with every operand rounded to TF32 the split
    convolution stays within 2^-20 of the exact one, where the one
    channel rounded to TF32 lands near 2^-11."""
    g = torch.Generator().manual_seed(5)
    x = torch.rand((bhw[0], 1) + bhw[1:], generator=g).to(
        memory_format=torch.channels_last)
    w = torch.randn((64, 1, 3, 3), generator=g)
    x4, w4 = split_tf32(x, w)
    assert x4.shape == (bhw[0], 4) + bhw[1:] and w4.shape == (64, 4, 3, 3)
    assert x4.is_contiguous(memory_format=torch.channels_last)
    assert w4.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(x4[:, 0] + x4[:, 1], x[:, 0])
    assert torch.equal(_tf32_round(x4[:, 0]), x4[:, 0])
    assert torch.equal(_tf32_round(w4[:, 0]), w4[:, 0])

    def gap(xs, ws):
        got = torch.conv2d(_tf32_round(xs).double(),
                           _tf32_round(ws.contiguous()).double(), padding=1)
        return float((got - want).abs().max() / want.abs().max())

    want = torch.conv2d(x.double(), w.double(), padding=1)
    assert gap(x4, w4) <= 2.0 ** -20
    assert gap(x, w) >= 2.0 ** -14
