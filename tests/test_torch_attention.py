"""Port masked attention (plain version of the CUDA kernel) against
icepy4d_tpu's XLA attention and its Pallas kernel in interpret mode; the
kernel against its plain bf16 version on a CUDA device.

JAX is imported inside the parity tests only, so the card's tests run
where JAX is not installed:
python -m pytest --noconftest -m cuda tests/test_torch_attention.py
"""

import numpy as np
import pytest
import torch

from icepy4d_tpu_torch.ops import attention


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from icepy4d_tpu.ops import attention as ref_attention

    return ref_attention


def _j(*arrays):
    import jax.numpy as jnp

    return [jnp.asarray(a) for a in arrays]


def _inputs(b=2, h=4, nq=128, nk=256, hd=64, seed=5, p_keep=0.7):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, nq, hd)).astype(np.float32)
    k = rng.normal(size=(b, h, nk, hd)).astype(np.float32)
    v = rng.normal(size=(b, h, nk, hd)).astype(np.float32)
    mask = rng.uniform(size=(b, nk)) < p_keep
    return q, k, v, mask


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def test_plain_f32_equals_xla(ref):
    q, k, v, mask = _inputs(nq=96, nk=200, hd=32)
    got = attention.masked_attention(*_t(q, k, v, mask)).numpy()
    want = np.asarray(ref._xla_attention(*_j(q, k, v, mask)))
    # every row has valid keys; f32 rounding in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_plain_bf16_equals_pallas_interpret(ref):
    q, k, v, mask = _inputs()
    got = attention.attention_plain(*_t(q, k, v, mask),
                                    operand_dtype=torch.bfloat16).numpy()
    want = np.asarray(ref.flash_attention(*_j(q, k, v, mask),
                                          interpret=True))
    # same bf16 contract; rounding to bf16 can fall on other sides of a
    # tie in the two frameworks, so relative to the output's scale
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-2, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fully_masked_row_gives_zeros(dtype):
    q, k, v, mask = _inputs(nq=16, nk=40)
    mask[1] = False
    out = attention.attention_plain(*_t(q, k, v, mask), operand_dtype=dtype)
    assert torch.count_nonzero(out[1]) == 0
    assert torch.count_nonzero(out[0]) > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk", [(128, 256), (77, 130), (200, 33)])
def test_kernel_equals_plain_bf16(cuda, nq, nk):
    q, k, v, mask = _inputs(nq=nq, nk=nk)
    mask[1] = False
    args = _t(q, k, v, mask, device=cuda)
    got = attention.masked_attention(*args)
    ref = attention.attention_plain(*args, operand_dtype=torch.bfloat16)
    assert torch.count_nonzero(got[1]) == 0
    # bf16 probabilities are rounded against the running max in the
    # kernel and the final max in the plain version
    err = (got - ref).abs().max() / ref.abs().max()
    assert err.item() <= 2e-3, err.item()
