"""Port image ops and tiler == icepy4d_tpu's on the same inputs (1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.matching.tiling import Tiler as JTiler
from icepy4d_tpu.ops import image as jimage
from icepy4d_tpu_torch.matching.tiling import Tiler
from icepy4d_tpu_torch.ops import image

RNG = np.random.default_rng(0)


def _close(a, b, tol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_rgb_to_gray(dtype):
    rgb = RNG.uniform(0, 255, (37, 53, 3)).astype(dtype)
    _close(image.rgb_to_gray(torch.from_numpy(rgb)),
           jimage.rgb_to_gray(jnp.asarray(rgb)))


@pytest.mark.parametrize("quality", ["highest", "high", "medium", "low"])
def test_quality_resize(quality):
    img = RNG.uniform(size=(61, 83)).astype(np.float32)
    _close(image.quality_resize(torch.from_numpy(img), quality),
           jimage.quality_resize(jnp.asarray(img), quality))


def test_extract_tiles_and_tiler_limits():
    img = RNG.uniform(size=(200, 300)).astype(np.float32)
    port, ref = Tiler(grid=[2, 3], overlap=20), JTiler(grid=[2, 3], overlap=20)
    assert port.compute_limits_by_grid(img) == ref.compute_limits_by_grid(img)
    assert port.tile_size == ref.tile_size
    np.testing.assert_array_equal(port.tile_origins(), ref.tile_origins())
    th, tw = port.tile_size
    _close(image.extract_tiles(torch.from_numpy(img), port.tile_origins(),
                               th, tw),
           jimage.extract_tiles(jnp.asarray(img),
                                jnp.asarray(ref.tile_origins()), th, tw))


@pytest.mark.parametrize("channels", [None, 5])
def test_bilinear_sample(channels):
    shape = (23, 31) if channels is None else (23, 31, channels)
    img = RNG.uniform(size=shape).astype(np.float32)
    # includes out-of-bounds and exactly-integer coordinates
    xy = RNG.uniform(-2, 33, (97, 2)).astype(np.float32)
    xy[:5] = np.round(xy[:5])
    _close(image.bilinear_sample(torch.from_numpy(img), torch.from_numpy(xy)),
           jimage.bilinear_sample(jnp.asarray(img), jnp.asarray(xy)))
