"""Port NMS (plain version of the CUDA kernel) == icepy4d_tpu's
simple_nms + border and its Pallas kernel in interpret mode, exactly;
the invariants of the kernel's design (windows with a 5r halo, pools on
shrinking rows, masks as 32-pixel words), modelled in plain torch on
the CPU; and the kernel == its plain version on a CUDA device.

JAX is imported inside the parity tests only, so the card's tests run
where JAX is not installed:
python -m pytest --noconftest -m cuda tests/test_torch_nms.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import nms_cases, nms_map
from icepy4d_tpu_torch.models.superpoint import _topk_peaks
from icepy4d_tpu_torch.ops import nms

NEG_INF = float("-inf")


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


def _heat_kind(shape, kind):
    if kind == "negative":       # scores below zero, zeros and a plateau
        heat = _heat(shape) * 2 - 1
        heat[:, 30:50, 5:40] = 0.0
        heat[:, 5:9, 50:70] = -0.5
        return heat
    if kind == "all_equal":
        return np.full(shape, 0.3, np.float32)
    return _heat(shape)


@pytest.mark.parametrize("shape,pad,kind", [
    pytest.param((1, 296, 160), (3, 5), "ties", id="shape0-pad0"),
    pytest.param((2, 120, 88), (0, 0), "ties", id="shape1-pad1"),
    pytest.param((1, 72, 104), (7, 2), "ties", id="shape2-pad2"),
    pytest.param((2, 120, 88), (3, 5), "negative", id="negative"),
    pytest.param((1, 72, 104), (0, 3), "all_equal", id="all-equal")])
def test_plain_nms_equals_jax(jsp, shape, pad, kind):
    heat = _heat_kind(shape, kind)
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


# -- the kernel's design, modelled on the CPU ---------------------------------

def _design_map(h, w, seed=3):
    """(1, h, w) scores with negative values, zeros and plateaus of ties."""
    rng = np.random.default_rng(seed)
    heat = rng.uniform(-1, 1, (1, h, w)).astype(np.float32)
    heat[:, h // 3: h // 3 + 12, w // 4: w // 4 + 40] = 0.25
    heat[:, h // 2: h // 2 + 30, : w // 3] = 0.0
    heat[:, -9:, -50:] = -0.75
    heat[:, :, w // 2: w // 2 + 3] = 0.5        # a ridge across every tile row
    return torch.from_numpy(heat)


def _tiles(h, w, r):
    th, tw = nms.tile_shape(r)
    return [(ty, tx) for ty in range(0, h, th) for tx in range(0, w, tw)]


@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("hw", [(230, 420), (40, 100), (104, 192), (1, 7)])
def test_window_with_halo_reproduces_centre(r, hw):
    """simple_nms of a window cut with a 5r halo (clipped at the map's
    edge) equals the full map's result on the window's centre: interior,
    edge and corner tiles, and maps smaller than one tile."""
    heat = _design_map(*hw)
    full = nms.simple_nms(heat, r)
    th, tw = nms.tile_shape(r)
    halo = nms.N_POOLS * r
    assert (th + 2 * halo, tw + 2 * halo) == (nms.WIN_H, nms.WIN_W)
    for ty, tx in _tiles(*hw, r):
        y0, x0 = max(ty - halo, 0), max(tx - halo, 0)
        win = heat[:, y0: ty + th + halo, x0: tx + tw + halo]
        got = nms.simple_nms(win, r)[:, ty - y0: ty - y0 + th,
                                     tx - x0: tx - x0 + tw]
        assert torch.equal(got, full[:, ty: ty + th, tx: tx + tw]), (ty, tx)


def _pack(bits):
    """(rows, 32 n) bool -> (rows, n) int64 words holding 32 bits each,
    bit j of word q = column 32 q + j."""
    rows, cols = bits.shape
    weights = 1 << torch.arange(32, dtype=torch.int64)
    return (bits.reshape(rows, cols // 32, 32).to(torch.int64)
            * weights).sum(-1)


def _unpack(words):
    shifts = torch.arange(32, dtype=torch.int64)
    return ((words[..., None] >> shifts) & 1).bool().reshape(
        words.shape[0], -1)


def _dilate_words(words, r):
    """The kernel's mask pool on 32-pixel words: a vertical OR of 2r+1
    rows (rows outside count as 0), then shifts by 1..r both ways with
    the neighbouring words' bits carried across the seams."""
    rows, n = words.shape
    pad = F.pad(words, (0, 0, r, r))
    mid = torch.zeros_like(words)
    for dy in range(2 * r + 1):
        mid |= pad[dy: dy + rows]
    left = F.pad(mid, (1, 0))[:, :n]
    right = F.pad(mid, (0, 1))[:, 1:]
    out = mid.clone()
    for s in range(1, r + 1):
        out |= ((mid << s) | (left >> (32 - s))) & 0xFFFFFFFF   # funnel shift left
        out |= (mid >> s) | ((right << (32 - s)) & 0xFFFFFFFF)  # and right
    return out


@pytest.mark.parametrize("r", [0, 1, 2, 3, 4, 9])
def test_word_dilation_equals_max_pool(r):
    rng = np.random.default_rng(r)
    mask = torch.from_numpy(rng.uniform(size=(40, 160)) < 0.01)
    mask[:, 31] |= torch.from_numpy(rng.uniform(size=40) < 0.2)   # seams
    mask[:, 32] |= torch.from_numpy(rng.uniform(size=40) < 0.2)
    mask[5, 0] = mask[7, 159] = mask[0, 64] = mask[39, 95] = True
    ref = F.max_pool2d(mask[None, None].float(), 2 * r + 1, stride=1,
                       padding=r)[0, 0] > 0
    assert torch.equal(_unpack(_dilate_words(_pack(mask), r)), ref)


def _pool_rows(plane, r, lo, hi):
    """Rows [lo, hi) of the (2r+1)^2 max-pool of a window plane: rows
    come from the plane (lo - r >= 0), columns past the window's edge
    read as -inf."""
    assert lo - r >= 0 and hi + r <= plane.shape[0]
    return F.max_pool2d(plane[None, None, lo - r: hi + r], 2 * r + 1,
                        stride=1, padding=(0, r))[0, 0]


def _kernel_model(heat, r, border, h0, w0):
    """The kernel's computation, block by block and stage by stage, in
    plain torch: a WIN_H x WIN_W window with -inf outside the map, pool k
    on `stage_rows(r, k)` only, masks as packed words, suppressed scores
    formed from the score and the bit."""
    b, h, w = heat.shape
    th, tw = nms.tile_shape(r)
    halo = nms.N_POOLS * r
    out = torch.full_like(heat, float("nan"))
    ys = torch.arange(nms.WIN_H)[:, None]
    xs = torch.arange(nms.WIN_W)[None, :]
    for bi in range(b):
        for ty, tx in _tiles(h, w, r):
            gy, gx = ys + ty - halo, xs + tx - halo
            inmap = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
            X = torch.full((nms.WIN_H, nms.WIN_W), NEG_INF)
            X[inmap] = heat[bi][gy.expand_as(inmap)[inmap],
                                gx.expand_as(inmap)[inmap]]
            # rows never computed hold NaN (scores) or all-ones (masks):
            # a stage that read them would spoil the centre
            M = torch.ones_like(inmap)
            lo, hi = nms.stage_rows(r, 1)
            M[lo:hi] = (X[lo:hi] == _pool_rows(X, r, lo, hi)) & inmap[lo:hi]
            for rnd in (1, 2):
                lo, hi = nms.stage_rows(r, 2 * rnd)
                S = torch.ones_like(inmap)
                words = _pack(M)[lo - r: hi + r]
                S[lo:hi] = _unpack(_dilate_words(words, r))[r: r + hi - lo] \
                    & inmap[lo:hi]
                Y = torch.full_like(X, float("nan"))
                Y[lo:hi] = torch.where(S[lo:hi], 0.0, X[lo:hi])
                lo, hi = nms.stage_rows(r, 2 * rnd + 1)
                new = (X[lo:hi] == _pool_rows(Y, r, lo, hi)) & ~S[lo:hi]
                M[lo:hi] |= new & inmap[lo:hi]
            keep = (gy >= border) & (gy < h0 - border) & \
                (gx >= border) & (gx < w0 - border)
            res = torch.where(M & keep, X, 0.0)
            assert (lo, hi) == (halo, halo + th)
            nh, nw = min(th, h - ty), min(tw, w - tx)
            out[bi, ty: ty + nh, tx: tx + nw] = \
                res[halo: halo + nh, halo: halo + nw]
    return out


@pytest.mark.parametrize("r", [0, 1, 2, 4])
@pytest.mark.parametrize("hw,pad", [((230, 420), (5, 3)), ((40, 100), (0, 0)),
                                    ((104, 192), (0, 9)), ((3, 33), (0, 0)),
                                    ((65, 153), (2, 0))])
def test_staged_model_equals_plain(r, hw, pad):
    """Pools on shrinking rows, full window width, bit masks: the
    per-pool margins are enough at interior, edge and corner tiles."""
    heat = _design_map(*hw)
    h0, w0 = hw[0] - pad[0], hw[1] - pad[1]
    got = _kernel_model(heat, r, 4, h0, w0)
    assert torch.equal(got, nms.nms_border_plain(heat, r, 4, h0, w0))


def test_staged_model_needs_its_margins():
    """The model is sensitive: with one row less of halo per stage the
    centre is wrong somewhere on a map with long-range suppression."""
    heat = _design_map(230, 420)
    ref = nms.nms_border_plain(heat, 4, 4, 230, 420)
    real = nms.stage_rows
    try:
        nms.stage_rows = lambda r, k: (real(r, k)[0] + (k > 0),
                                       real(r, k)[1] - (k > 0))
        with pytest.raises(AssertionError):
            assert torch.equal(_kernel_model(heat, 4, 4, 230, 420), ref)
    finally:
        nms.stage_rows = real


def test_constants_match_source():
    """ops/nms.py's geometry is the kernel's."""
    src = (Path(nms.__file__).parents[1] / "csrc" / "nms.cu").read_text()
    flat = " ".join(src.split())

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", src).group(1))

    def constexpr(name):
        return re.search(rf"constexpr \w+ {name} =\s*([^;]+);", src).group(1)

    assert define("NMS_WIN_H") == nms.WIN_H
    assert define("NMS_WIN_WORDS") == nms.WIN_WORDS
    assert define("NMS_THREADS") == nms.THREADS
    assert constexpr("WIN_W") == "32 * WIN_WORDS" and \
        nms.WIN_W == 32 * nms.WIN_WORDS
    assert int(constexpr("RUN")) == nms.RUN
    assert int(constexpr("COL_RUN_MAX")) == nms.COL_RUN_MAX
    assert int(re.search(r"SMEM_LIMIT = (\d+) \* 1024;", src).group(1)) \
        * 1024 == nms.SMEM_LIMIT
    assert int(constexpr("MAX_RADIUS_CAP")) == 9
    assert "constexpr int HALO = 5 * R;" in src and nms.N_POOLS == 5
    assert "pad_cols(int r) { return 4 * ((r + 3) / 4); }" in flat
    assert "pitch(int r) { return WIN_W + 2 * pad_cols(r) + 4; }" in flat
    assert "return (size_t)WIN_H * (2 * pitch(r) * sizeof(float) + " \
        "2 * WIN_WORDS * sizeof(unsigned));" in flat
    for r in range(nms.MAX_RADIUS + 1):
        pad = 4 * ((r + 3) // 4)
        assert pad >= r and nms.pitch(r) == nms.WIN_W + 2 * pad + 4
        assert nms.pitch(r) % 8 == 4             # odd number of 16-byte vectors
        assert nms.smem_bytes(r) == nms.WIN_H * (2 * nms.pitch(r) * 4
                                                 + 2 * nms.WIN_WORDS * 4)
        assert nms.smem_bytes(r) <= nms.SMEM_LIMIT
        # a tile of at least one run each way; rows in pairs
        assert min(nms.tile_shape(r)) >= nms.RUN
    # column runs: equally many per thread, long enough for every stage
    assert [nms.col_run(n) for n in (96, 80, 64, 14, 8)] == [24, 20, 16, 8, 8]
    for r in range(1, nms.MAX_RADIUS + 1):
        for k in (1, 3, 5):
            lo, hi = nms.stage_rows(r, k)
            assert nms.RUN <= nms.col_run(hi - lo) <= min(nms.COL_RUN_MAX,
                                                          hi - lo)
    # a thread stays on one column, and on one run of columns
    assert nms.THREADS % nms.WIN_W == 0 and nms.WIN_H % 2 == 0
    assert nms.THREADS % (2 * nms.WIN_W // nms.RUN) == 0


@pytest.mark.parametrize("r", [-1, nms.MAX_RADIUS + 1])
def test_radius_outside_range_raises(r):
    """A radius the kernel is not built for raises before any launch."""
    with pytest.raises(ValueError, match="nms_radius"):
        nms.check_kernel_args(torch.zeros((1, 8, 8)), r)
    nms.check_kernel_args(torch.zeros((1, 8, 8)), nms.MAX_RADIUS)


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


@pytest.mark.cuda
@pytest.mark.parametrize("case", nms_cases(nms), ids=str)
def test_kernel_equals_plain_at_tile_edges(cuda, case):
    """The smoke run's shapes: around both tile sides, word seams,
    unaligned widths, every radius, h0 < H, each kind of map."""
    shape, r, pad, kind = case
    heat = nms_map(shape, cuda, kind)
    h0, w0 = shape[1] - pad[0], shape[2] - pad[1]
    got = nms.fused_nms_border(heat, r, 4, h0, w0)
    assert torch.equal(got, nms.nms_border_plain(heat, r, 4, h0, w0))
