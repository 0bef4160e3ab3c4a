"""Port masked attention (plain version of the CUDA kernel) against
icepy4d_tpu's XLA attention and its Pallas kernel in interpret mode; the
kernel against its plain bf16 version on a CUDA device, at the shapes a
tiled, pipelined kernel gets wrong (key and query tails around its
128-wide tiles, padding masks, runs of fully masked tiles, strided head
views); and what the kernel's wrapper rejects, which needs no card.

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


def _mask(mode: str, b: int, nk: int, seed: int = 11) -> np.ndarray:
    """prefix: each batch row keeps its first 1..nk keys (padding after);
    middle: keys nk/4 .. 3nk/4 masked, a run of whole tiles at nk >= 512;
    rand: each key kept with probability 0.7."""
    rng = np.random.default_rng(seed)
    if mode == "prefix":
        return np.arange(nk)[None] < rng.integers(1, nk + 1, (b, 1))
    if mode == "middle":
        mask = np.ones((b, nk), bool)
        mask[:, nk // 4: 3 * nk // 4] = False
        return mask
    return rng.uniform(size=(b, nk)) < 0.7


def _head_views(*tensors):
    """(B, H, N, hd) views of (B, N, H, hd) storage, as LightGlue's
    blocks pass q, k and v."""
    return [t.transpose(1, 2).contiguous().transpose(1, 2) for t in tensors]


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


@pytest.mark.parametrize("mode", ["prefix", "middle"])
def test_plain_on_head_views_equals_contiguous_and_xla(ref, mode):
    q, k, v, _ = _inputs(b=3, nq=72, nk=160)
    mask = _mask(mode, 3, 160)
    tq, tk, tv, tm = _t(q, k, v, mask)
    views = _head_views(tq, tk, tv)
    assert not any(t.is_contiguous() for t in views)
    got = attention.masked_attention(*views, tm).numpy()
    np.testing.assert_allclose(
        got, attention.masked_attention(tq, tk, tv, tm).numpy(),
        rtol=1e-5, atol=1e-5)
    want = np.asarray(ref._xla_attention(*_j(q, k, v, mask)))
    rows = mask.any(1)                 # every batch row has a valid key
    assert rows.all()
    np.testing.assert_allclose(got[rows], want[rows], rtol=1e-5, atol=1e-5)


def _bad_head_dim():
    q, k, v, mask = _t(*_inputs(nq=8, nk=16, hd=32))
    return q, k, v, mask


def _bad_key_shape():
    q, k, v, mask = _t(*_inputs(nq=8, nk=16))
    return q, k[:, :, :12], v, mask


def _bad_mask_shape():
    q, k, v, mask = _t(*_inputs(nq=8, nk=16))
    return q, k, v, mask[:, :12]


def _mixed_devices():
    q, k, v, mask = _t(*_inputs(nq=8, nk=16))
    return q.to("meta"), k, v, mask


def _cpu_tensors():
    return tuple(_t(*_inputs(nq=8, nk=16)))


@pytest.mark.parametrize("make,match", [
    (_bad_head_dim, "64"), (_bad_key_shape, "shape mismatch"),
    (_bad_mask_shape, "shape mismatch"), (_mixed_devices, "one device"),
    (_cpu_tensors, "CUDA")],
    ids=["head_dim", "key_shape", "mask_shape", "mixed_devices", "cpu"])
def test_kernel_wrapper_rejects_what_it_cannot_launch(make, match):
    """`flash_attention` is the kernel's wrapper: it never runs the plain
    version, whatever it is given."""
    with pytest.raises(ValueError, match=match):
        attention.flash_attention(*make())


def test_head_views_reach_the_kernel_without_a_copy():
    """The tensor maps take LightGlue's (B, N, H, hd) views by their
    strides; a view the maps cannot address (hd not unit-stride) is
    copied."""
    q = torch.zeros((2, 24, 4, 64, 3), dtype=torch.bfloat16)
    view = q[..., 0].transpose(1, 2)                  # stride 3 along hd
    ready = attention._tma_ready(view)
    assert ready.is_contiguous() and ready.data_ptr() != view.data_ptr()
    heads = torch.zeros((2, 24, 4, 64), dtype=torch.bfloat16).transpose(1, 2)
    ready = attention._tma_ready(heads)
    assert ready.data_ptr() == heads.data_ptr()
    assert attention._strides(ready) == [24 * 256, 64, 256]
    # a dim of size 1 carries no stride of its own
    assert attention._strides(torch.zeros((1, 1, 5, 64))) == [64, 64, 64]


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


def _check_kernel(cuda, b, h, nq, nk, mode, strided=False,
                  dtype=torch.float32):
    """Kernel vs plain bf16 at one shape; the last batch row is fully
    masked and must come out as zeros."""
    q, k, v, _ = _inputs(b=b, h=h, nq=nq, nk=nk, seed=nq + nk)
    mask = _mask(mode, b, nk)
    mask[-1] = False
    q, k, v, mask = _t(q, k, v, mask, device=cuda)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    if strided:
        q, k, v = _head_views(q, k, v)
    got = attention.masked_attention(q, k, v, mask)
    ref = attention.attention_plain(q, k, v, mask,
                                    operand_dtype=torch.bfloat16)
    assert got.shape == ref.shape and got.dtype == q.dtype
    assert torch.isfinite(got.float()).all()
    assert torch.count_nonzero(got[-1]) == 0
    err = (got[:-1].float() - ref[:-1].float()).abs().max() \
        / ref[:-1].float().abs().max()
    # a bf16 output adds its own rounding: two values that round to
    # neighbouring bf16 numbers differ by up to 2^-7 of the largest
    tol = 2e-3 if dtype == torch.float32 else 2e-3 + 2.0 ** -7
    assert err.item() <= tol, err.item()


@pytest.mark.cuda
@pytest.mark.parametrize("nk", [1, 63, 64, 65, 127, 128, 129, 4 * 128 + 5])
def test_kernel_key_tails(cuda, nk):
    _check_kernel(cuda, 3, 2, 129, nk, "rand")


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [1, 127, 129, 200])
def test_kernel_query_tails_with_padding_mask(cuda, nq):
    _check_kernel(cuda, 3, 2, nq, 300, "prefix")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("strided", [False, True],
                         ids=["contiguous", "head_views"])
@pytest.mark.parametrize("mode", ["prefix", "middle"])
def test_kernel_masked_tiles_and_head_views(cuda, mode, strided, dtype):
    """nk = 1024: the middle mask blanks tiles 2 to 5 whole, the prefix
    mask leaves whole tiles of padding at the end."""
    _check_kernel(cuda, 3, 4, 256, 1024, mode, strided, dtype)


ADAPTIVE_CAPS = (64, 128, 256, 512, 1024, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("nk", ADAPTIVE_CAPS)
@pytest.mark.parametrize("nq", ADAPTIVE_CAPS)
def test_kernel_adaptive_capacities(cuda, nq, nk):
    """The adaptive LightGlue's packed capacities (powers of two from 64,
    Nq != Nk included), head views as the blocks pass them, a padding
    mask behind each row's kept tokens: at Nk = 64 a partial 128-key
    tile, at Nq = 64 one of the two consumer warpgroups without rows."""
    _check_kernel(cuda, 4, 4, nq, nk, "prefix", strided=True)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk", [(512, 64), (512, 128), (2048, 64),
                                   (2048, 128)])
def test_kernel_as_far_from_f32_as_plain_bf16(cuda, nq, nk):
    """The inputs of chip_smoke.py's phase 3 at the four adaptive shapes
    where the kernel departs from plain bf16 by more than 2e-3 of the
    largest output (3.1e-3 at Nq = 512, Nk = 64 on an H100): the two
    bf16 versions sum q.k in other orders, so a probability on a bf16
    rounding boundary rounds apart in them, by 2^-8 of itself, and a row
    of a few valid keys moves by up to 3e-3. Neither is the nearer one:
    both lie as far from plain f32, within 1e-4 of the largest output,
    and that is the rule phase 3 holds these shapes to."""
    b, h = 16, 4
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((b, h, n, 64), generator=g, device=cuda)
               for n in (nq, nk, nk))
    g = torch.Generator(device=cuda).manual_seed(nk)
    n_valid = torch.randint(1, nk + 1, (b, 1), generator=g, device=cuda)
    mask = torch.arange(nk, device=cuda)[None] < n_valid
    mask[-1] = False
    q, k, v = _head_views(q, k, v)
    got = attention.masked_attention(q, k, v, mask)[:-1]
    bf16 = attention.attention_plain(q, k, v, mask,
                                     operand_dtype=torch.bfloat16)[:-1]
    f32 = attention.attention_plain(q, k, v, mask)[:-1]
    scale = bf16.abs().max().item()
    to32 = (got - f32).abs().max().item() / scale
    plain_to32 = (bf16 - f32).abs().max().item() / scale
    assert abs(to32 - plain_to32) <= 1e-4, (to32, plain_to32)
    # and neither bf16 version strays from f32 by more than a few 2^-8
    assert plain_to32 <= 3 * 2.0 ** -8, plain_to32
