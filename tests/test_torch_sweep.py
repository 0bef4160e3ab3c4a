"""Port disparity sweep (plain version of the CUDA kernel) against
icepy4d_tpu's `_disparity_sweep` on XLA and its Pallas kernel in
interpret mode; and the kernel against its plain version on a CUDA
device.

Tolerances are those of tests/test_pallas_sweep.py: cost 1e-5 and
inbounds equal on every pixel; disparity and uniqueness 5e-3 px on every
pixel that is not a near tie. A near tie is a pixel whose best and
runner-up costs (over all hypotheses, as the port computes them) lie
within 1e-5: there a cost that rounds differently in its last bit (XLA
computes 1 / sqrt with an approximate rsqrt) can flip the argmin or the
second best, and the uniqueness ratio of two near-zero costs is itself
ill-conditioned.

JAX is imported inside the parity tests only, so the card's tests run
where JAX is not installed:
python -m pytest --noconftest -m cuda tests/test_torch_sweep.py
"""

import numpy as np
import pytest
import torch

from icepy4d_tpu_torch.ops import dense, sweep
from torch_port_inputs import sweep_pair

TIE = 1e-5
SHAPES = [(160, 200), (144, 256)]
# symmetric, negative only, straddling 0 (with an inexact step)
RANGES = [(-12.0, 12.0, 49), (-20.0, -4.0, 49), (-9.7, 3.1, 61)]


def _assert_sweeps_agree(got: dict, ref: dict, gap: np.ndarray,
                         max_tie_share: float = 0.05):
    got = {k: np.asarray(v) for k, v in got.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    np.testing.assert_allclose(got["cost"], ref["cost"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["inbounds"], ref["inbounds"])
    tie = gap <= TIE
    assert tie.mean() <= max_tie_share
    for key in ("disparity", "uniqueness"):
        err = np.abs(got[key] - ref[key])
        assert not np.any((err > 5e-3) & ~tie), \
            f"{key}: {np.sum((err > 5e-3) & ~tie)} off-tie pixels over 5e-3"


def _inputs(hw, rng_spec):
    h, w = hw
    lo, hi, n = rng_spec
    I0, I1 = sweep_pair(h, w)
    gap = dense.runner_up_gap(torch.from_numpy(I0), torch.from_numpy(I1),
                              lo, hi, n_disp=n).numpy()
    got = dense.disparity_sweep(torch.from_numpy(I0), torch.from_numpy(I1),
                                lo, hi, n_disp=n, window=7)
    return I0, I1, gap, {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("rng_spec", RANGES, ids=["sym", "neg", "straddle"])
@pytest.mark.parametrize("hw", SHAPES, ids=["160x200", "144x256"])
def test_plain_sweep_matches_xla(hw, rng_spec):
    import jax.numpy as jnp
    from icepy4d_tpu.ops.dense import _disparity_sweep

    I0, I1, gap, got = _inputs(hw, rng_spec)
    lo, hi, n = rng_spec
    ref = _disparity_sweep(jnp.asarray(I0), jnp.asarray(I1), jnp.float32(lo),
                           jnp.float32(hi), pad=dense._pad_bucket(lo, hi),
                           n_disp=n, window=7)
    _assert_sweeps_agree(got, ref, gap)


@pytest.mark.parametrize("rng_spec", RANGES, ids=["sym", "neg", "straddle"])
@pytest.mark.parametrize("hw", SHAPES, ids=["160x200", "144x256"])
def test_plain_sweep_matches_pallas_interpret(hw, rng_spec):
    import jax.numpy as jnp
    from icepy4d_tpu.ops.pallas_sweep import disparity_sweep_pallas

    I0, I1, gap, got = _inputs(hw, rng_spec)
    lo, hi, n = rng_spec
    ref = disparity_sweep_pallas(jnp.asarray(I0), jnp.asarray(I1),
                                 jnp.float32(lo), jnp.float32(hi),
                                 dense._pad_bucket(lo, hi), n_disp=n,
                                 window=7, interpret=True)
    _assert_sweeps_agree(got, ref, gap)


def test_plain_sweep_recovers_known_shift():
    I0, I1 = sweep_pair(160, 256, seed=3, shift=5.3)
    out = dense.disparity_sweep(torch.from_numpy(I0), torch.from_numpy(I1),
                                -12.0, 12.0, n_disp=49, window=7)
    d = out["disparity"].numpy()
    inb = out["inbounds"].numpy()
    center = d[20:-20, 30:-30][inb[20:-20, 30:-30]]
    assert abs(np.median(center) + 5.3) < 0.2


def test_hypotheses_match_xla():
    """disp_min + k * step rounds as XLA rounds it (a reciprocal
    multiply and an FMA), so x - d >= 0 flips at the same pixels."""
    import jax
    import jax.numpy as jnp

    for lo, hi, n in RANGES + [(200.0, 430.0, 128), (-3.3, 17.9, 96)]:
        xla = jax.jit(lambda a, b: a + jnp.arange(n, dtype=jnp.float32)
                      * ((b - a) / max(n - 1, 1)))(jnp.float32(lo),
                                                   jnp.float32(hi))
        lo32, step = dense.sweep_hypotheses(lo, hi, n)
        ours = dense._fma(torch.arange(n, dtype=torch.float32), step, lo32)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(xla))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hw,lo,hi,n,window", [
    ((67, 45), -6.0, 6.0, 25, 5),
    ((161, 203), -12.0, 12.0, 49, 7),
    ((161, 203), -20.0, -4.0, 49, 7),
    ((144, 256), -9.7, 3.1, 61, 7)])
def test_kernel_matches_plain(cuda, hw, lo, hi, n, window):
    I0, I1 = (torch.from_numpy(a).to(cuda) for a in sweep_pair(*hw))
    got = dense.disparity_sweep(I0, I1, lo, hi, n_disp=n, window=window)
    ref = dense.disparity_sweep_plain(I0, I1, lo, hi,
                                      dense._pad_bucket(lo, hi),
                                      n_disp=n, window=window)
    gap = dense.runner_up_gap(I0, I1, lo, hi, n_disp=n, window=window)
    _assert_sweeps_agree({k: v.cpu() for k, v in got.items()},
                         {k: v.cpu() for k, v in ref.items()},
                         gap.cpu().numpy())


# the kernel's tile: 16 output rows, 128 window columns, so 128 -
# (window - 1) output columns, in strips of 8 (csrc/sweep.cu)
@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(9, 300), (16, 122), (17, 123), (33, 121),
                                (50, 261), (15, 7)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_kernel_matches_plain_off_tile_sizes(cuda, hw):
    """H below one tile, H and W one more or less than a multiple of the
    tile, and a last strip with a single pixel; cost bitwise equal."""
    I0, I1 = (torch.from_numpy(a).to(cuda) for a in sweep_pair(*hw))
    lo, hi, n = -9.7, 3.1, 33
    got = dense.disparity_sweep(I0, I1, lo, hi, n_disp=n, window=7)
    ref = dense.disparity_sweep_plain(I0, I1, lo, hi,
                                      dense._pad_bucket(lo, hi),
                                      n_disp=n, window=7)
    assert torch.equal(got["cost"], ref["cost"])
    gap = dense.runner_up_gap(I0, I1, lo, hi, n_disp=n, window=7)
    _assert_sweeps_agree({k: v.cpu() for k, v in got.items()},
                         {k: v.cpu() for k, v in ref.items()},
                         gap.cpu().numpy(), max_tie_share=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("window", sweep.WINDOWS)
def test_kernel_matches_plain_every_window(cuda, window):
    I0, I1 = (torch.from_numpy(a).to(cuda) for a in sweep_pair(50, 261))
    lo, hi, n = -9.0, 9.0, 19
    got = dense.disparity_sweep(I0, I1, lo, hi, n_disp=n, window=window)
    ref = dense.disparity_sweep_plain(I0, I1, lo, hi,
                                      dense._pad_bucket(lo, hi),
                                      n_disp=n, window=window)
    assert torch.equal(got["cost"], ref["cost"])
    gap = dense.runner_up_gap(I0, I1, lo, hi, n_disp=n, window=window)
    _assert_sweeps_agree({k: v.cpu() for k, v in got.items()},
                         {k: v.cpu() for k, v in ref.items()},
                         gap.cpu().numpy(), max_tie_share=1.0)


def _call(device="meta", shape1=(8, 8), n_disp=4, window=7):
    return (torch.zeros((8, 8), device=device),
            torch.zeros(shape1, device=device), 0.0, 1.0, n_disp, window)


@pytest.mark.parametrize("args,match", [
    (_call(), "CUDA"), (_call(device="cpu"), "CUDA"),
    (_call(shape1=(8, 9)), "one shape"), (_call(window=4), "windows"),
    (_call(window=17), "windows"), (_call(n_disp=0), "n_disp")],
    ids=["meta", "cpu", "shape", "even_window", "wide_window", "n_disp"])
def test_kernel_wrapper_rejects_what_it_cannot_launch(args, match):
    """`disparity_sweep_kernel` is the kernel's wrapper: it never runs
    the plain version, whatever it is given."""
    with pytest.raises(ValueError, match=match):
        sweep.disparity_sweep_kernel(*args)


@pytest.mark.parametrize("window", [3, 5, 9, 11])
def test_plain_sweep_matches_xla_other_windows(window):
    """The plain version rounds as XLA does at every window the kernel is
    built for, not only the pipeline's 7."""
    import jax.numpy as jnp
    from icepy4d_tpu.ops.dense import _disparity_sweep

    lo, hi, n = -9.0, 9.0, 19
    I0, I1 = sweep_pair(50, 131)
    t0, t1 = torch.from_numpy(I0), torch.from_numpy(I1)
    gap = dense.runner_up_gap(t0, t1, lo, hi, n_disp=n, window=window)
    got = dense.disparity_sweep(t0, t1, lo, hi, n_disp=n, window=window)
    ref = _disparity_sweep(jnp.asarray(I0), jnp.asarray(I1), jnp.float32(lo),
                           jnp.float32(hi), pad=dense._pad_bucket(lo, hi),
                           n_disp=n, window=window)
    _assert_sweeps_agree({k: v.numpy() for k, v in got.items()}, ref,
                         gap.numpy())
