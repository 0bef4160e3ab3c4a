"""The port's PointCloud == icepy4d_tpu's: the SOR mask is equal at
n = 3000 with row blocks smaller than the cloud (a last block padded in
the JAX package, cut short in the port), a PLY round trip keeps points
exactly and colours to the byte, and LAS export raises without laspy.
The port's SOR centres the cloud before its float32 distance expansion,
so the same cloud moved to the synthetic season's world frame (1.3 km
from the origin) keeps its mask."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.core.point_cloud import PointCloud as JPointCloud
from icepy4d_tpu.core.point_cloud import _sor_mask as j_sor_mask
from icepy4d_tpu_torch.core import PointCloud
from icepy4d_tpu_torch.core.point_cloud import _sor_mask


def _cloud(n=3000, n_out=60, seed=0):
    """A noisy plane with gross outliers."""
    rng = np.random.default_rng(seed)
    xyz = np.c_[rng.uniform(0, 10, (n, 2)), rng.normal(0, 0.02, n)]
    xyz[:n_out, 2] += rng.uniform(1, 3, n_out) * rng.choice([-1, 1], n_out)
    return xyz.astype(np.float32)


@pytest.mark.parametrize("knn,block", [(10, 1024), (6, 700)])
def test_sor_mask_matches_jax(knn, block):
    xyz = _cloud()
    ref = np.asarray(jax.jit(j_sor_mask, static_argnums=(1, 3))(
        jnp.asarray(xyz), knn, 3.0, block))
    got = _sor_mask(torch.from_numpy(xyz), knn, 3.0, block).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not got[:60].any() and got[60:].mean() > 0.99


def test_sor_mask_of_offset_cloud():
    from torch_port_inputs import SEASON_ORIGIN

    xyz = _cloud()
    at_origin = _sor_mask(torch.from_numpy(xyz), 10, 3.0).numpy()
    moved = (xyz + SEASON_ORIGIN).astype(np.float32)
    np.testing.assert_array_equal(
        _sor_mask(torch.from_numpy(moved), 10, 3.0).numpy(), at_origin)


def test_sor_filter_matches_jax():
    xyz = _cloud(seed=1)
    col = np.random.default_rng(2).uniform(0, 255, (len(xyz), 3))
    j = JPointCloud(points3d=xyz, points_col=col).sor_filter()
    p = PointCloud(points3d=xyz, points_col=col).sor_filter(device="cpu")
    np.testing.assert_array_equal(p.points, j.points)
    np.testing.assert_array_equal(p.colors, j.colors)


def test_ply_round_trip(tmp_path):
    xyz = _cloud(500)
    col = np.random.default_rng(3).integers(0, 256, (500, 3))
    pc = PointCloud(points3d=xyz, points_col=col.astype(np.float32))
    pc.write_ply(tmp_path / "c.ply")
    back = PointCloud(pcd_path=tmp_path / "c.ply")
    np.testing.assert_array_equal(back.points, xyz)
    np.testing.assert_array_equal(back.get_colors(), pc.get_colors())
    jback = JPointCloud(pcd_path=tmp_path / "c.ply")
    np.testing.assert_array_equal(jback.points, back.points)
    np.testing.assert_array_equal(jback.colors, back.colors)


def test_write_las_needs_laspy(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "laspy", None)   # import raises
    with pytest.raises(ImportError, match="laspy"):
        PointCloud(points3d=_cloud(100)).write_las(tmp_path / "c.las")
