"""LoFTR's dual-softmax coarse match (`ops/dual_softmax.py`).

Without a card: the CPU dispatch is the dense arithmetic, bit for bit;
`coarse_match` is the selection shared with the kernel path; the
log-domain identity the kernel computes with (row and column log-sum-exp,
64-row partials merged, -1e9 for masked cells and -inf for padding)
gives the dense product of softmaxes' argmaxes and maxima; and what the
kernel's wrapper rejects. On a card: the kernel against the plain
version at the benchmark cell's (2, 30000, 256) and at ragged sizes with
masks, its launches per LoFTR forward, and that it allocates no L0 x L1
matrix. The card's tests run where JAX is not installed:
python -m pytest --noconftest -m cuda tests/test_torch_dual_softmax.py
"""

import math

import numpy as np
import pytest
import torch

from icepy4d_tpu_torch.device import full_f32_matmul
from icepy4d_tpu_torch.models import loftr
from icepy4d_tpu_torch.ops import dual_softmax as ds

T = 0.1
D = 256
LOG2E = 1.4426950408889634


def _inputs(b, l0, l1, seed, device="cpu", p_keep=0.85, dead=True):
    """c0, c1 (f32, unit normal; a third of c1's rows are noisy copies of
    c0's, so that rows have clear best columns as trained features do)
    and cell masks. With `dead`, tile pair 1 has every column masked and
    tile pair 2 every row."""
    rng = np.random.default_rng(seed)
    c0 = rng.normal(size=(b, l0, D)).astype(np.float32)
    c1 = rng.normal(size=(b, l1, D)).astype(np.float32)
    n = min(l0, l1) // 3
    src = rng.permutation(l0)[:n]
    dst = rng.permutation(l1)[:n]
    c1[:, dst] = c0[:, src] + 0.3 * rng.normal(size=(b, n, D))
    m0 = rng.uniform(size=(b, l0)) < p_keep
    m1 = rng.uniform(size=(b, l1)) < p_keep
    if dead and b > 1:
        m1[1] = False
    if dead and b > 2:
        m0[2] = False
    return [torch.from_numpy(a).to(device) for a in (c0, c1, m0, m1)]


def _dense(c0, c1, m0, m1):
    """The LoFTR forward's dense dual softmax, as written before the
    kernel."""
    n0 = c0 / math.sqrt(D)
    n1 = c1 / math.sqrt(D)
    sim = torch.bmm(n0, n1.transpose(1, 2)).div_(T)
    sim.masked_fill_(~(m0[:, :, None] & m1[:, None, :]), -1e9)
    conf = torch.softmax(sim, 1)
    return conf.mul_(torch.softmax(sim, 2))


SHAPES = [(3, 48, 48), (3, 40, 72), (2, 130, 97)]


@pytest.mark.parametrize("b,l0,l1", SHAPES)
def test_cpu_dispatch_is_the_dense_arithmetic(b, l0, l1):
    c0, c1, m0, m1 = _inputs(b, l0, l1, seed=l0 + l1)
    launches = ds.KERNEL.launches
    bj, bv, bi = ds.best_matches(c0, c1, m0, m1, T)
    conf = _dense(c0, c1, m0, m1)
    assert torch.equal(bj, conf.argmax(2))
    assert torch.equal(bv, conf.amax(2))
    assert torch.equal(bi, conf.argmax(1))
    assert ds.KERNEL.launches == launches
    model = loftr.LoFTR(device="cpu")
    assert torch.equal(model.coarse_confidence(c0, c1, m0, m1), conf)


@pytest.mark.parametrize("b,l0,l1", SHAPES[:2])
def test_coarse_match_is_the_shared_selection(b, l0, l1):
    c0, c1, m0, m1 = _inputs(b, l0, l1, seed=3 * l0 + l1, dead=False)
    hw0 = (l0 // 8, 8)
    hw1 = (l1 // 8, 8)
    conf = _dense(c0, c1, m0, m1)
    got = loftr.coarse_match(conf, m0, m1, hw0, hw1, 1e-3, 1, 16)
    want = loftr.select_matches(conf.argmax(2), conf.amax(2),
                                conf.argmax(1), m0, m1, hw0, hw1, 1e-3, 1, 16)
    assert got[3].any()
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


def _lse_merge(m, l, m2, l2):
    """The kernel's merge of two (max, sum of 2^(x - max)) partials."""
    d = torch.where(m2 == -math.inf, math.inf, m - m2)
    e = torch.exp2(-d.abs())
    keep = d >= 0
    return torch.where(keep, m, m2), torch.where(keep, l + l2 * e, l * e + l2)


def _log_domain(c0, c1, m0, m1):
    """bj, bv, bi as the kernel computes them: scores in log2 units,
    masked cells at -1e9 * log2(e), rows padded to a multiple of 128 with
    -inf, the row log-sum-exp R, the column log-sum-exp C merged from
    64-row partials, then argmax and max of 2 s - C and argmax of
    2 s - R."""
    b, l0, d = c0.shape
    l1 = c1.shape[1]
    mt = torch.tensor(-1e9 * LOG2E, dtype=torch.float32)
    s = (torch.bmm(c0.double(), c1.double().transpose(1, 2)).float()
         * (LOG2E / (d * T)))
    s = torch.where(m0[:, :, None] & m1[:, None, :], s, mt)
    rows = -(-l0 // 128) * 128
    s = torch.cat([s, torch.full((b, rows - l0, l1), -math.inf)], 1)
    mx = s.amax(2)
    R = mx + torch.log2(torch.exp2(s - mx[..., None]).sum(2))
    m = torch.full((b, l1), -math.inf)
    l = torch.zeros(b, l1)
    for g in range(rows // 64):
        blk = s[:, 64 * g: 64 * g + 64]
        gm = blk.amax(1)
        use = torch.where(gm == -math.inf, 0.0, gm)
        m, l = _lse_merge(m, l, gm, torch.exp2(blk - use[:, None]).sum(1))
    C = m + torch.log2(l)
    s, R = s[:, :l0], R[:, :l0]
    v = 2 * s - C[:, None, :]
    vmax = v.amax(2)
    dead_row = R < 0.5 * mt
    bv = torch.where(dead_row,
                     torch.where(vmax > 1.5 * mt,
                                 (1.0 / torch.tensor(float(l0)))
                                 * (1.0 / torch.tensor(float(l1))), 0.0),
                     torch.exp2(vmax - R))
    return v.argmax(2), bv, (2 * s - R[..., None]).argmax(1)


def _clear(conf, dim, rtol=1e-4):
    """Rows (dim 2) or columns (dim 1) whose best confidence is normal and
    exceeds the second by more than rtol of it: their argmax is no near
    tie of rounding."""
    if conf.shape[dim] < 2:
        return conf.amax(dim) > 1e-30
    top = conf.topk(2, dim=dim).values
    a, b = top.select(dim, 0), top.select(dim, 1)
    return (a > 1e-30) & (a - b > rtol * a)


@pytest.mark.parametrize("b,l0,l1", SHAPES)
def test_log_domain_identity(b, l0, l1):
    c0, c1, m0, m1 = _inputs(b, l0, l1, seed=7 * l0 + l1)
    conf = _dense(c0, c1, m0, m1)
    bj, bv, bi = _log_domain(c0, c1, m0, m1)
    rows, cols = _clear(conf, 2), _clear(conf, 1)
    # tile pair 0 has live cells (the others are wholly masked)
    assert rows[0].float().mean() > 0.5 and cols[0].float().mean() > 0.5
    assert torch.equal(bj[rows], conf.argmax(2)[rows])
    assert torch.equal(bi[cols], conf.argmax(1)[cols])
    # masked rows and columns follow the dense path's uniform softmaxes:
    # the argmax of a wholly masked row is its first wholly masked column
    dead = ~m0 | ~m1.any(1, keepdim=True)
    assert torch.equal(bj[dead], conf.argmax(2)[dead])
    torch.testing.assert_close(bv, conf.amax(2), rtol=1e-4, atol=1e-30)


def test_kernel_wrapper_rejects_before_launch():
    c0, c1, m0, m1 = _inputs(1, 16, 24, seed=1, dead=False)
    launches = ds.KERNEL.launches
    with pytest.raises(ValueError, match="256"):
        ds.dual_softmax_kernel(c0[..., :128], c1[..., :128], m0, m1, T)
    with pytest.raises(ValueError, match="float32"):
        ds.dual_softmax_kernel(c0.double(), c1.double(), m0, m1, T)
    with pytest.raises(ValueError, match="float32"):
        ds.dual_softmax_kernel(c0.half(), c1.half(), m0, m1, T)
    with pytest.raises(ValueError, match="bool"):
        ds.dual_softmax_kernel(c0, c1, m0.float(), m1, T)
    with pytest.raises(ValueError, match="shape mismatch"):
        ds.dual_softmax_kernel(c0, c1, m0[:, :8], m1, T)
    with pytest.raises(ValueError, match="CUDA"):
        ds.dual_softmax_kernel(c0, c1, m0, m1, T)
    assert ds.KERNEL.launches == launches


# -- on a card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check_kernel(cuda, b, l0, l1, p_keep, dead):
    c0, c1, m0, m1 = _inputs(b, l0, l1, seed=l0 * 7 + l1, device=cuda,
                             p_keep=p_keep, dead=dead)
    launches = ds.KERNEL.launches
    bj, bv, bi = ds.best_matches(c0, c1, m0, m1, T)
    torch.cuda.synchronize()
    assert ds.KERNEL.launches == launches + 1
    with full_f32_matmul():
        conf = _dense(c0, c1, m0, m1)
    rows, cols = _clear(conf, 2), _clear(conf, 1)
    # argmaxes agree wherever the best two confidences are not a near tie
    # of f32 rounding (both sides round scores of magnitude ~10 at ~1e-6)
    assert torch.equal(bj[rows], conf.argmax(2)[rows])
    assert torch.equal(bi[cols], conf.argmax(1)[cols])
    dead_rows = ~m0 | ~m1.any(1, keepdim=True)
    assert torch.equal(bj[dead_rows], conf.argmax(2)[dead_rows])
    # bv = exp(2 s - C - R): ~1e-5 of rounding in the exponent on each
    # side becomes a relative error of bv
    torch.testing.assert_close(bv, conf.amax(2), rtol=1e-4, atol=1e-30)
    return rows.float().mean().item(), cols.float().mean().item()


@pytest.mark.cuda
def test_kernel_at_the_cell_shape(cuda):
    rows, cols = _check_kernel(cuda, 2, 30000, 30000, 1.0, dead=False)
    assert rows > 0.9 and cols > 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("b,l0,l1", [(1, 1000, 1337), (3, 517, 300),
                                     (3, 129, 1), (2, 1, 255)])
def test_kernel_ragged_and_masked(cuda, b, l0, l1):
    _check_kernel(cuda, b, l0, l1, 0.85, dead=True)


@pytest.mark.cuda
def test_kernel_allocates_no_similarity(cuda):
    b, l = 2, 30000
    c0, c1, m0, m1 = _inputs(b, l, l, seed=2, device=cuda, p_keep=1.0,
                             dead=False)
    ds.best_matches(c0, c1, m0, m1, T)     # built and warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    ds.best_matches(c0, c1, m0, m1, T)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(cuda) - base
    # one tile pair's L0 x L1 f32 matrix is 3.6 GB
    assert extra < l * l * 4 / 4


@pytest.mark.cuda
def test_every_forward_launches_the_kernel(cuda):
    # random weights: confidences lie near 1 / L (~1e-4), so a threshold
    # of 1e-8 keeps the mutual nearest neighbours (24 on the CPU)
    torch.manual_seed(0)
    model = loftr.LoFTR(thr=1e-8, max_matches=16, device=cuda)
    g = torch.Generator().manual_seed(0)
    imgs = torch.rand(2, 64, 96, generator=g).to(cuda)
    launches = ds.KERNEL.launches
    out = model.match_batch(imgs, imgs.roll(8, 2), np.ones(2, bool))
    assert ds.KERNEL.launches == launches + 1
    assert out["valid"].any()
    out = model.match_pair(imgs[0, :56], imgs[1, :, :80])
    assert ds.KERNEL.launches == launches + 2
    assert out["valid"].any()

    # the kernel's three vectors select what the dense confidences select
    cells = torch.ones((2, 8 * 12), dtype=torch.bool, device=cuda)
    with torch.inference_mode(), model._precision():
        c0, c1, _, _, hw0, hw1 = model.coarse_features(
            imgs, imgs.roll(8, 2), cells, cells)
        args = (cells, cells, hw0, hw1, model.thr, model.border_rm, 16)
        got = loftr.select_matches(
            *ds.best_matches(c0, c1, cells, cells,
                              model.dsmax_temperature), *args)
        with full_f32_matmul():
            want = loftr.coarse_match(
                model.coarse_confidence(c0, c1, cells, cells), *args)
        exact = model.coarse_confidence(c0.double(), c1.double(), cells,
                                        cells).amax(2)
    assert ds.KERNEL.launches == launches + 3
    assert got[3].any()
    for k in (0, 1, 3):
        assert torch.equal(got[k], want[k])
    # random weights give scores of ~85, which f32 rounds at ~1e-4 of a
    # confidence: the kernel's are held against f64 confidences, and
    # must be as close to them as the dense f32 path's are
    def rel_err(sel):
        ref = torch.gather(exact, 1, sel[0])[sel[3]]
        return ((sel[2][sel[3]].double() - ref).abs() / ref).max().item()

    assert rel_err(got) <= max(1e-4, rel_err(want))
