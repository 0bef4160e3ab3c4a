"""The port's screened Poisson reconstruction (`post_processing/
poisson.py`) and meshing helpers == icepy4d_tpu's on the CPU, at depth 5.

- `estimate_normals`: oriented normals within 1e-4 on rows whose kNN
  sets agree (both orient by the same rule, so no sign is free);
- `_solve_chi`: the splatted density within 1e-5 and chi within 1e-4 of
  its largest magnitude (torch.fft and XLA's CPU FFT round apart);
  `_trilinear` and `_box_blur3` within 1e-5;
- `marching_tetrahedra` (host numpy in both) equal on the same field;
- `poisson_reconstruct`: face counts within 1% and the symmetric mean
  distance between the two vertex sets within 0.01 of a grid cell, never
  compared face by face;
- `mesh_from_dsm_grid` equal; `meshing_poisson` writes the same ASCII
  PLY header and counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from icepy4d_tpu.post_processing import point_clouds as JPC
from icepy4d_tpu.post_processing import poisson as J
from icepy4d_tpu.utils import dsm_orthophoto as JD
from icepy4d_tpu_torch.post_processing import point_clouds as PPC
from icepy4d_tpu_torch.post_processing import poisson as P
from icepy4d_tpu_torch.utils import dsm_orthophoto as PD


def sphere(n=6000, r=5.0, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * r, v


def height_field(n=6000, seed=3):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-10, 10, (n, 2))
    z = 2.0 * np.sin(xy[:, 0] * 0.4) + 1.5 * np.cos(xy[:, 1] * 0.3)
    return np.column_stack([xy, z])


def test_estimate_normals():
    from icepy4d_tpu.post_processing.analysis import _knn_indices as j_knn
    from icepy4d_tpu_torch.post_processing.analysis import (
        _knn_indices as p_knn)

    pts = height_field(4000) * 0.3
    p32 = pts.astype(np.float32)
    rows = np.array([set(a) == set(b) for a, b in zip(
        np.asarray(j_knn(jnp.asarray(p32), 16, 2048)),
        p_knn(torch.from_numpy(p32), 16).numpy())])
    assert rows.mean() > 0.99
    for vp in (None, np.array([0.0, 0.0, 30.0])):
        nj = J.estimate_normals(pts, k=16, viewpoint=vp)
        npp = P.estimate_normals(pts, k=16, viewpoint=vp, device="cpu")
        np.testing.assert_allclose(npp[rows], nj[rows], atol=1e-4)
        if vp is not None:
            assert (npp[:, 2] > 0).mean() > 0.99


def test_solve_chi_and_samplers():
    pts, nrm = sphere(4000)
    D = 32
    scale = (D - 1) / 14.0
    pts_g = ((pts + 7.0) * scale)[:, ::-1].astype(np.float32)
    nrm_g = (nrm[:, ::-1] * scale).astype(np.float32)
    chi_j, dens_j = J._solve_chi(jnp.asarray(pts_g), jnp.asarray(nrm_g), D,
                                 jnp.float32(1e-2))
    chi_p, dens_p = P._solve_chi(torch.from_numpy(pts_g.copy()),
                                 torch.from_numpy(nrm_g.copy()), D, 1e-2)
    chi_j, dens_j = np.asarray(chi_j), np.asarray(dens_j)
    np.testing.assert_allclose(dens_p.numpy(), dens_j, atol=1e-5)
    big = np.abs(chi_j).max()
    assert np.abs(chi_p.numpy() - chi_j).max() <= 1e-4 * big
    np.testing.assert_allclose(
        P._trilinear(torch.from_numpy(chi_j), torch.from_numpy(pts_g)).numpy(),
        np.asarray(J._trilinear(jnp.asarray(chi_j), jnp.asarray(pts_g))),
        atol=1e-5 * big)
    np.testing.assert_allclose(
        P._box_blur3(torch.from_numpy(dens_j)).numpy(),
        np.asarray(J._box_blur3(jnp.asarray(dens_j))), atol=1e-5)


def test_marching_tetrahedra_same_field():
    g = np.linspace(-1, 1, 20, dtype=np.float32)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    field = 0.7 - np.sqrt(x * x + y * y + z * z) + 0.05 * np.sin(7 * x)
    for a, b in zip(J.marching_tetrahedra(field, 0.0),
                    P.marching_tetrahedra(field, 0.0)):
        np.testing.assert_array_equal(b, a)
    v, f = P.marching_tetrahedra(np.ones((4, 4, 4), np.float32))
    assert v.shape == (0, 3) and f.shape == (0, 3)


def sym_mean_distance(a: np.ndarray, b: np.ndarray) -> float:
    return 0.5 * (cKDTree(b).query(a)[0].mean()
                  + cKDTree(a).query(b)[0].mean())


@pytest.mark.parametrize("case", ["sphere", "patch"])
def test_poisson_reconstruct(case):
    if case == "sphere":
        pts, nrm = sphere()
        kw = dict(normals=nrm, density_quantile=0.0)
    else:
        pts, nrm = height_field(), None
        kw = dict(viewpoint=np.array([0.0, 0.0, 100.0]), k_normals=16,
                  density_quantile=0.05)
    vj, fj, dj = J.poisson_reconstruct(pts, depth=5, **kw)
    vp, fp, dp = P.poisson_reconstruct(pts, depth=5, device="cpu", **kw)
    span = (pts.max(0) - pts.min(0)).max()
    cell = span * 1.25 / 31
    assert len(fj) > 500
    assert abs(len(fp) - len(fj)) <= 0.01 * len(fj)
    assert sym_mean_distance(vp, vj) <= 0.01 * cell
    assert vp.dtype == vj.dtype and fp.dtype == fj.dtype
    assert len(dp) == len(vp)


def test_poisson_degenerate_cloud_raises():
    with pytest.raises(ValueError, match="degenerate"):
        P.poisson_reconstruct(np.ones((50, 3)), np.ones((50, 3)), depth=4,
                              device="cpu")


def test_mesh_from_dsm_grid_and_meshing_poisson(tmp_path):
    pts = height_field(3000)
    dj = JD.build_dsm(pts, 1.0)
    dp = PD.build_dsm(pts, 1.0, device="cpu")
    (vj, fj), (vp, fpp) = (JPC.mesh_from_dsm_grid(dj),
                           PPC.mesh_from_dsm_grid(dp))
    np.testing.assert_array_equal(fpp, fj)
    np.testing.assert_allclose(vp, vj, atol=1e-5)
    JPC.meshing_poisson(pts, depth=5, out_path=tmp_path / "j.ply")
    PPC.meshing_poisson(pts, depth=5, out_path=tmp_path / "p.ply",
                        device="cpu")
    head = [(tmp_path / f).read_text().split("end_header")[0].splitlines()
            for f in ("j.ply", "p.ply")]
    assert [ln.split()[:2] for ln in head[0]] == \
        [ln.split()[:2] for ln in head[1]]
    for line in (2, 6):                        # vertex and face counts
        nj, np_ = (int(h[line].split()[-1]) for h in head)
        assert abs(np_ - nj) <= 0.01 * nj
