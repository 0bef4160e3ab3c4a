"""Port NMS (plain version of the CUDA kernel) == icepy4d_tpu's
simple_nms + border and its Pallas kernel in interpret mode, exactly;
and the kernel == its plain version on a CUDA device.

JAX is imported inside the parity tests only, so the card's tests run
where JAX is not installed:
python -m pytest --noconftest -m cuda tests/test_torch_nms.py
"""

import numpy as np
import pytest
import torch

from icepy4d_tpu_torch.models.superpoint import _topk_peaks
from icepy4d_tpu_torch.ops import nms


@pytest.fixture(scope="module")
def jsp():
    pytest.importorskip("jax")
    from icepy4d_tpu.models import superpoint

    return superpoint


def _jax_reference(heat, r, border, h0, w0):
    import jax.numpy as jnp
    from icepy4d_tpu.models.superpoint import simple_nms

    out = simple_nms(jnp.asarray(heat), r)
    h, w = heat.shape[1:]
    ys, xs = np.arange(h), np.arange(w)
    frame = ((ys < border) | (ys >= h0 - border))[:, None] | \
        ((xs < border) | (xs >= w0 - border))[None, :]
    return np.asarray(jnp.where(frame[None], 0.0, out))


def _heat(shape, seed=0):
    rng = np.random.default_rng(seed)
    heat = rng.uniform(0, 1, shape).astype(np.float32)
    # plateaus of exact ties, as softmax heatmaps have in flat regions
    heat[:, 10:20, 10:30] = 0.25
    return heat


@pytest.mark.parametrize("shape,pad", [((1, 296, 160), (3, 5)),
                                       ((2, 120, 88), (0, 0)),
                                       ((1, 72, 104), (7, 2))])
def test_plain_nms_equals_jax(jsp, shape, pad):
    heat = _heat(shape)
    h0, w0 = shape[1] - pad[0], shape[2] - pad[1]
    got = nms.fused_nms_border(torch.from_numpy(heat), 4, 4, h0, w0).numpy()
    np.testing.assert_array_equal(got, _jax_reference(heat, 4, 4, h0, w0))


def test_plain_nms_equals_pallas_interpret(jsp):
    import jax.numpy as jnp
    from icepy4d_tpu.ops.pallas_nms import fused_nms_border

    heat = _heat((1, 296, 160), seed=1)
    h0, w0 = 293, 155
    got = nms.fused_nms_border(torch.from_numpy(heat), 4, 4, h0, w0).numpy()
    ref = np.asarray(fused_nms_border(jnp.asarray(heat), 4, 4, h0, w0,
                                      interpret=True))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 61, 90)])
def test_topk_peaks_equal(jsp, shape):
    import jax.numpy as jnp

    heat = _jax_reference(_heat(shape, seed=2), 4, 4, *shape[1:])
    s_p, k_p = _topk_peaks(torch.tensor(heat), 128, 4)
    s_j, k_j = jsp._topk_peaks(jnp.asarray(heat), 128, 4)
    np.testing.assert_array_equal(k_p.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,r", [((2, 301, 517), 4), ((1, 64, 40), 2)])
def test_kernel_equals_plain(cuda, shape, r):
    heat = torch.from_numpy(_heat(shape)).to(cuda)
    h0, w0 = shape[1] - 5, shape[2] - 3
    got = nms.fused_nms_border(heat, r, 4, h0, w0)
    ref = nms.nms_border_plain(heat, r, 4, h0, w0)
    assert torch.equal(got, ref)
