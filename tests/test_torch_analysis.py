"""The port's analysis products (`post_processing/analysis.py`) ==
icepy4d_tpu's on the CPU, and the kNN fault of the JAX package.

- kNN: near the origin, equal neighbour sets on every row whose k-th and
  (k+1)-th squared distances (exact, float64) are more than 1e-6 m^2
  apart; both packages' float32 expansions cannot order closer ones.
- The fault (ROADMAP section 3): the JAX kNN expands |a|^2 + |b|^2 - 2a.b
  in float32 on raw coordinates. On a 1.75 m patch of 5000 points with
  1 cm of noise moved to SEASON_ORIGIN + (0, 100, 0), the port (which
  centres first) equals scipy's exact cKDTree on every row without a
  tie, and the JAX package's neighbour sets overlap it by less than half.
- Features on jittered clouds near the origin within 1e-4 (normals up to
  sign) on the rows whose neighbour sets agree; the border mask equal on
  a cloud where both kNNs agree on every row;
  border statistics and their CSV byte-equal; sections equal; voxel
  counts, indices and centres equal, colours within 1e-5, the writers'
  files byte-equal; `make_pairs` equal.
- The volume-variation workflow on three clouds named by date through
  both packages: both CSV files byte-equal, the plots of equal size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from icepy4d_tpu.io.ply import write_ply as j_write_ply
from icepy4d_tpu.post_processing import analysis as J
from icepy4d_tpu_torch.post_processing import analysis as P
from torch_port_inputs import SEASON_ORIGIN


def front_scene(n=4000, seed=0, scale=0.1):
    """A plateau meeting a vertical face (the glacier front of
    tests/test_analysis.py) scaled by `scale` and centred on the origin
    (at 10 m the JAX expansion already moves 0.2% of the rows)."""
    rng = np.random.default_rng(seed)
    n_top = n // 2
    top = np.stack([rng.uniform(0, 50, n_top), rng.uniform(0, 30, n_top),
                    100.0 + rng.normal(0, 0.05, n_top)], 1)
    n_face = n - n_top
    face = np.stack([50.0 + rng.normal(0, 0.05, n_face),
                     rng.uniform(0, 30, n_face),
                     rng.uniform(60, 100, n_face)], 1)
    p = np.concatenate([top, face]) * scale
    return (p - p.mean(0)).astype(np.float32)


def exact_knn(p: np.ndarray, k: int):
    """(indices (N, k), rows without a tie at the k-th neighbour)."""
    p64 = p.astype(np.float64)
    d, idx = cKDTree(p64).query(p64, k + 1)
    return idx[:, :k], (d[:, k] ** 2 - d[:, k - 1] ** 2) > 1e-6


def same_sets(a, b) -> np.ndarray:
    return np.array([set(x) == set(y) for x, y in zip(a, b)])


@pytest.mark.parametrize("block", [None, 700])
def test_knn_matches_jax_near_origin(block):
    p = front_scene(3000)
    want, clear = exact_knn(p, 24)
    jn = np.asarray(J._knn_indices(jnp.asarray(p), 24, 1024))
    tn = P._knn_indices(torch.from_numpy(p), 24, block).numpy()
    assert clear.mean() > 0.95
    assert same_sets(tn[clear], jn[clear]).all()
    assert same_sets(tn[clear], want[clear]).all()
    assert (tn[:, 0] == np.arange(len(p))).mean() > 0.99   # self first


def test_knn_offset_cloud_port_exact_jax_not():
    rng = np.random.default_rng(0)
    n = 5000
    uv = rng.uniform(0, 1.75, (n, 2))
    p = (np.c_[uv[:, 0], rng.normal(0, 0.01, n), uv[:, 1]]
         + SEASON_ORIGIN + [0.0, 100.0, 0.0]).astype(np.float32)
    want, clear = exact_knn(p, 32)
    tn = P._knn_indices(torch.from_numpy(p), 32).numpy()
    jn = np.asarray(J._knn_indices(jnp.asarray(p), 32, 2048))
    assert clear.mean() > 0.99
    assert same_sets(tn[clear], want[clear]).all()
    overlap = np.mean([len(set(a) & set(b)) / 32
                       for a, b in zip(jn[clear], want[clear])])
    assert overlap < 0.5, overlap


def test_geometric_features_match_jax():
    p = front_scene(4000, seed=1)
    fj = J.geometric_features(p, k=24)
    fp = P.geometric_features(p, k=24, device="cpu")
    jn = np.asarray(J._knn_indices(jnp.asarray(p), 24, 2048))
    tn = P._knn_indices(torch.from_numpy(p), 24).numpy()
    rows = same_sets(jn, tn)
    assert rows.mean() > 0.99
    for key in ("linearity", "planarity", "sphericity", "verticality"):
        np.testing.assert_allclose(fp[key][rows], fj[key][rows], atol=1e-4)
    dot = np.abs(np.sum(fp["normal"][rows] * fj["normal"][rows], 1))
    np.testing.assert_allclose(dot, 1.0, atol=1e-4)
    wall = (p[:, 0] > p[:, 0].max() - 0.1) & (p[:, 2] < p[:, 2].max() - 0.5)
    assert np.median(fp["verticality"][wall]) > 0.8
    assert np.median(fp["planarity"][wall]) > 0.5


def test_detect_border_and_statistics(tmp_path):
    """On a cloud where both kNNs agree on every row (no near tie), the
    percentile chain gives the same mask."""
    p = front_scene(6000, seed=2, scale=0.3)
    assert same_sets(np.asarray(J._knn_indices(jnp.asarray(p), 24, 2048)),
                     P._knn_indices(torch.from_numpy(p), 24).numpy()).all()
    kw = dict(k=24, linearity_percentile=(80, 100),
              verticality_percentile=(50, 100), z_percentile=(50, 100))
    mj = J.detect_border(p, **kw)
    mp = P.detect_border(p, device="cpu", **kw)
    np.testing.assert_array_equal(mp, mj)
    assert mp.sum() > 20
    rows = []
    for mod, m in ((J, mj), (P, mp)):
        st = [mod.border_statistics(p[m], x_halfwidth=3.0),
              mod.border_statistics(p[m], y_lims=(-2, 2), x_halfwidth=None),
              mod.border_statistics(p[m], y_lims=(100, 101))]
        rows.append(st)
        mod.write_border_time_series(
            [(f"c{i}.ply", f"2022_05_0{i}", s) for i, s in enumerate(st)],
            tmp_path / f"{mod.__name__.split('.')[0]}.txt")
    assert rows[0][:2] == rows[1][:2]
    assert all(np.isnan(v) for v in rows[1][2].values())
    assert (tmp_path / "icepy4d_tpu_torch.txt").read_bytes() == \
        (tmp_path / "icepy4d_tpu.txt").read_bytes()


def test_sections(tmp_path):
    p = front_scene(2000, seed=3)
    col = np.random.default_rng(0).uniform(0, 1, p.shape)
    for a, b in zip(J.extract_section(p, "y", 1.5, 0.4, colors=col),
                    P.extract_section(p, "y", 1.5, 0.4, colors=col)):
        np.testing.assert_array_equal(b, a)
    sj = J.extract_sections(p, "x", [1.0, 2.0, 4.0])
    sp = P.extract_sections(p, "x", [1.0, 2.0, 4.0])
    assert sj.keys() == sp.keys()
    for s in sj:
        np.testing.assert_array_equal(sp[s], sj[s])
    J.plot_sections(sj, out=tmp_path / "j.png")
    P.plot_sections(sp, out=tmp_path / "p.png")
    assert (tmp_path / "p.png").stat().st_size == \
        (tmp_path / "j.png").stat().st_size


@pytest.mark.parametrize("size,bounds", [(0.25, None),
                                         (0.4, ((-2, -1, -2), (2, 1.5, 2)))])
def test_voxelize(tmp_path, size, bounds):
    p = front_scene(5000, seed=4)
    p[:3] = np.nan
    col = np.random.default_rng(1).integers(0, 256, p.shape).astype(
        np.float32)
    bb = {} if bounds is None else dict(bb_min=bounds[0], bb_max=bounds[1])
    gj = J.voxelize(p, col, size, **bb)
    gp = P.voxelize(p, col, size, device="cpu", **bb)
    for f in ("centers", "counts", "indices", "origin"):
        np.testing.assert_array_equal(getattr(gp, f), getattr(gj, f))
    np.testing.assert_allclose(gp.colors, gj.colors, atol=1e-5)
    assert gp.voxel_size == gj.voxel_size
    if bounds is None:
        assert gp.counts.sum() == len(p) - 3
    for a, b in zip(J.voxel_mesh(gj), P.voxel_mesh(gp)):
        np.testing.assert_allclose(b, a, atol=1e-5)
    gp.colors = gj.colors                  # the writers' format only
    J.write_voxel_centers(gj, tmp_path / "j.txt")
    P.write_voxel_centers(gp, tmp_path / "p.txt")
    assert (tmp_path / "p.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()


def test_make_pairs():
    names = [f"sampled_2022_05_{d:02d}.ply" for d in (1, 6, 11, 16, 30)]
    for step in (1, 5, 10):
        assert P.make_pairs(names, step) == J.make_pairs(names, step)
    with pytest.raises(ValueError, match="no date"):
        P.make_pairs(["cloud.ply"])


def test_volume_variations_workflow(tmp_path):
    """Three clouds of a glacier front named by date, retreating along x
    on a sloped face: both packages write the same two CSVs and plots of
    the same size."""
    rng = np.random.default_rng(5)
    n = 3000
    yz = rng.uniform([0, 60], [30, 100], (n, 2)).astype(np.float32)
    paths = []
    for i, day in enumerate((1, 6, 11)):
        x = 50.0 - 1.0 * i - 0.5 * i * i + 0.02 * yz[:, 1]
        pts = np.column_stack([x, yz[:, 0], yz[:, 1]]).astype(np.float32)
        paths.append(tmp_path / f"sampled_2022_05_{day:02d}.ply")
        j_write_ply(paths[-1], pts)
    kw = dict(t_step=5, grid_step=1.0, direction="x", base_name="sampled")
    dj = J.volume_variations(paths, out_dir=tmp_path / "jax", **kw)
    dp = P.volume_variations(paths, out_dir=tmp_path / "torch",
                             device="cpu", **kw)
    assert len(dp) == 2 and (dp["volume"] < 0).all()
    assert dp.equals(dj)
    files = sorted(f.name for f in (tmp_path / "jax").iterdir())
    assert files == sorted(f.name for f in (tmp_path / "torch").iterdir())
    assert len([f for f in files if f.endswith(".png")]) == 2
    for f in files:
        a, b = tmp_path / "jax" / f, tmp_path / "torch" / f
        if f.endswith(".csv"):
            assert b.read_bytes() == a.read_bytes(), f
        else:
            assert b.stat().st_size == a.stat().st_size, f
