"""The port's FLOP counters and the small public members it shares with
the JAX package.

- `SuperPoint.extract_flops` and `LightGlue.match_flops` against
  `torch.utils.flop_counter.FlopCounterMode` on CPU forwards, within 5%
  (the counter sees the convolutions and matmuls the formulas count,
  plus LightGlue's rotary projection), for n_layers 1 and 2 and with the
  identity input projection of a state dict without input_proj.
- The SuperPoint count differs from the JAX package's by exactly the
  space-to-depth excess of its full-resolution convs:
  3 * (2 * 1 * c1 * 9 + 2 * c1 * c1 * 9) * h * w * batch; the LightGlue
  count equals the JAX one where the layers are the same.
- `Points.to_point_cloud`, `Tiler.extract_patch` and `Tiler.extract_all`
  equal their JAX counterparts.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from icepy4d_tpu_torch.models import LightGlue, SuperPoint


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("h,w,batch", [(64, 96, 1), (61, 90, 2)])
def test_superpoint_extract_flops(h, w, batch):
    sp = SuperPoint(max_keypoints=64, device="cpu")
    x = torch.rand(batch, h, w, generator=torch.Generator().manual_seed(0))
    assert sp.extract_flops(h, w, batch) == pytest.approx(
        counted(lambda: sp.extract(x)), rel=0.05)


def test_superpoint_flops_against_jax():
    """At sides that are multiples of 8 the only difference is the JAX
    count's space-to-depth conv1a/b; 169,608 against 394,248 FLOP a
    pixel at the default widths."""
    from icepy4d_tpu.models.superpoint import SuperPoint as JSuperPoint

    h, w, batch = 2400, 3400, 2
    c1 = 64
    port = SuperPoint(device="cpu").extract_flops(h, w, batch)
    jax = JSuperPoint().extract_flops(h, w, batch)
    assert jax - port == 3 * (2 * 1 * c1 * 9 + 2 * c1 * c1 * 9) * h * w \
        * batch
    assert port == 169608 * h * w * batch and jax == 394248 * h * w * batch


def match_data(b, m, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"kpts0": torch.rand(b, m, 2, generator=g) * 100,
            "kpts1": torch.rand(b, n, 2, generator=g) * 100,
            "desc0": torch.randn(b, m, 256, generator=g),
            "desc1": torch.randn(b, n, 256, generator=g),
            "mask0": torch.ones(b, m, dtype=torch.bool),
            "mask1": torch.ones(b, n, dtype=torch.bool),
            "size0": torch.full((b, 2), 100.0),
            "size1": torch.full((b, 2), 100.0)}


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("identity", [False, True],
                         ids=["input_proj", "identity"])
def test_lightglue_match_flops(n_layers, identity):
    from icepy4d_tpu.models.lightglue import LightGlue as JLightGlue

    lg = LightGlue(n_layers=n_layers, device="cpu")
    if identity:
        sd = {k: v for k, v in lg.state_dict().items()
              if not k.startswith("input_proj.")}
        lg.load_state_dict(sd)
        assert isinstance(lg.input_proj, torch.nn.Identity)
    b, m, n = 2, 64, 48
    data = match_data(b, m, n)
    got = lg.match_flops(b, m, n)
    assert got == pytest.approx(counted(lambda: lg.match(data)), rel=0.05)
    jax = JLightGlue(n_layers=n_layers).match_flops(b, m, n)
    assert jax - got == (2 * (m + n) * 256 * 256 * b if identity else 0)


def test_points_to_point_cloud():
    from icepy4d_tpu.core import Points as JPoints
    from icepy4d_tpu_torch.core import Points

    rng = np.random.default_rng(0)
    xyz = rng.uniform(-5, 5, (40, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (40, 3))
    clouds = []
    for cls in (JPoints, Points):
        p = cls()
        p.append_points_from_numpy(xyz, colors=rgb)
        clouds.append(p.to_point_cloud())
    j, t = clouds
    assert type(t).__module__ == "icepy4d_tpu_torch.core.point_cloud"
    np.testing.assert_array_equal(t.points, j.points)
    np.testing.assert_array_equal(t.get_colors(), j.get_colors())
    np.testing.assert_array_equal(t.get_colors(as_uint8=False),
                                  j.get_colors(as_uint8=False))


@pytest.mark.parametrize("grid,overlap,channels",
                         [([2, 3], 10, None), ([3, 2], 0, 3)])
def test_tiler_extract(grid, overlap, channels):
    from icepy4d_tpu.matching.tiling import Tiler as JTiler
    from icepy4d_tpu_torch.matching.tiling import Tiler

    shape = (57, 83) + ((channels,) if channels else ())
    img = np.random.default_rng(1).integers(0, 256, shape).astype(np.uint8)
    jt, pt = JTiler(grid=grid, overlap=overlap), Tiler(grid=grid,
                                                       overlap=overlap)
    assert pt.compute_limits_by_grid(img) == jt.compute_limits_by_grid(img)
    for i, lim in pt.limits.items():
        np.testing.assert_array_equal(pt.extract_patch(img, lim),
                                      jt.extract_patch(img, lim))
    tiles = pt.extract_all(torch.from_numpy(img))
    assert isinstance(tiles, torch.Tensor) and tiles.device.type == "cpu"
    np.testing.assert_array_equal(tiles.numpy(),
                                  np.asarray(jt.extract_all(img)))
    np.testing.assert_array_equal(pt.extract_all(img).numpy(),
                                  tiles.numpy())
