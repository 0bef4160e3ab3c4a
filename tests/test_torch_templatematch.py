"""The port's OC template matcher (`matching/templatematch.py`) and
`SemiDenseMatcher` == icepy4d_tpu's, on seeded inputs.

`forient` within 1e-6; `oc_track` gives the same tracked / failed
points, du and dv within 1e-3 px (measured 7e-7: two libraries' FFTs)
and the SNR within 1e-4 relative. `SemiDenseMatcher` on a shifted pair
with the bundled SuperPoint and 8-px tokens: full-frame grid matches
with OC refinement equal the JAX matcher's within 1e-3 px on at least
97% of the rows (the rest are near-tied NN rows). Tiled, the port matches the grid
tokens while the JAX package extracts SuperPoint keypoints there
(ROADMAP section 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.matching import GeometricVerification as JGV
from icepy4d_tpu.matching import SemiDenseMatcher as JSD
from icepy4d_tpu.matching import TileSelection as JTS
from icepy4d_tpu.matching import templatematch as J
from icepy4d_tpu_torch.matching import (GeometricVerification,
                                        SemiDenseMatcher, TileSelection)
from icepy4d_tpu_torch.matching import templatematch as P
from icepy4d_tpu_torch.models.convert import load_params
from torch_port_inputs import DX, DY, REPO_WEIGHTS, shifted_pair


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    a, b = shifted_pair(200, 240)
    return a.astype(np.float32), b.astype(np.float32)


def test_forient(pair):
    a, _ = pair
    np.testing.assert_allclose(P.forient(torch.from_numpy(a)).numpy(),
                               np.asarray(J.forient(jnp.asarray(a))),
                               atol=1e-6)


@pytest.mark.parametrize("tw,sw", [(16, 32), (24, 48)])
def test_oc_track(pair, tw, sw):
    a, b = pair
    rng = np.random.default_rng(0)
    xy = rng.uniform(10, 190, (60, 2))
    xy[3] = np.nan                                   # an invalid input
    xy[7] = [2.0, 100.0]                             # template off the image
    init = np.stack([rng.uniform(-20, -12, 60), rng.uniform(-11, -5, 60)],
                    -1)
    ref = J.oc_track(J.forient(jnp.asarray(a)), J.forient(jnp.asarray(b)),
                     xy, tw, sw, init[:, 0], init[:, 1])
    got = P.oc_track(P.forient(torch.from_numpy(a)),
                     P.forient(torch.from_numpy(b)), xy, tw, sw,
                     init[:, 0], init[:, 1])
    ok = np.isfinite(ref.du)
    assert 30 <= ok.sum() < 60
    np.testing.assert_array_equal(np.isfinite(got.du), ok)
    np.testing.assert_array_equal(got.pu, ref.pu)
    np.testing.assert_allclose(got.du[ok], ref.du[ok], atol=1e-3)
    np.testing.assert_allclose(got.dv[ok], ref.dv[ok], atol=1e-3)
    np.testing.assert_allclose(got.snr[ok], ref.snr[ok], rtol=1e-4)
    # the shift is recovered where the search window holds it
    good = ok & (got.snr > 1.5)
    assert np.median(np.abs(got.du[good] + DX)) < 0.2
    assert np.median(np.abs(got.dv[good] + DY)) < 0.2


def test_template_match_class(pair):
    a, b = pair
    xy = np.array([[100.0, 100.0], [60.0, 120.0]])
    res = P.TemplateMatch(a, b, xy, template_width=32, search_width=64,
                          device="cpu").match()
    ref = J.TemplateMatch(a, b, xy, template_width=32,
                          search_width=64).match()
    np.testing.assert_allclose(res.du, ref.du, atol=1e-3)
    np.testing.assert_allclose(res.dv, ref.dv, atol=1e-3)
    with pytest.raises(ValueError):
        P.TemplateMatch(a[..., None], b, xy, device="cpu")


@pytest.fixture(scope="module")
def sp_tree():
    return load_params(REPO_WEIGHTS / "superpoint_synthetic.npz")


def test_semidense_full_frame_agrees(sp_tree):
    """Grid tokens, mutual NN and the OC refinement of every match, with
    8-px tokens (grid_pool 1): the pair's (16, 8) px shift is then a
    whole number of tokens, and the refinement recovers it."""
    a, b = shifted_pair(240, 320)
    opt = {"grid_pool": 1}
    jm = JSD(dict(opt, superpoint_params=jax.tree.map(jnp.asarray,
                                                      sp_tree)))
    jm.match(a, b, geometric_verification=JGV.NONE)
    pm = SemiDenseMatcher(dict(opt, superpoint_params=sp_tree),
                          device="cpu")
    pm.match(a, b, geometric_verification=GeometricVerification.NONE)
    assert len(jm.mkpts0) >= 50
    # pooled grid descriptors tie closely: a row whose two best columns
    # lie within float32 rounding may pick the other (2 of 158 rows here;
    # the NN step itself is held with ties excluded in
    # test_torch_nn_matchers), so the match sets are compared by row
    got = {tuple(k): v for k, v in zip(pm.mkpts0.tolist(), pm.mkpts1)}
    ref = {tuple(k): v for k, v in zip(jm.mkpts0.tolist(), jm.mkpts1)}
    common = [k for k in ref if k in got
              and np.all(np.abs(got[k] - ref[k]) < 1e-3)]
    assert len(common) >= 0.97 * max(len(got), len(ref))
    # most matches are refined onto the true shift (0.73 refined and
    # 0.68 within 1.5 px here; the rest lie near the small frame's edges)
    assert pm.refined_share > 0.6
    d = pm.mkpts1 - pm.mkpts0
    assert np.mean(np.hypot(d[:, 0] + DX, d[:, 1] + DY) < 1.5) > 0.6


def test_semidense_tiled_uses_grid_tokens(sp_tree):
    """Tiled: the port's matches sit on the 16-px token grid of their
    tile; the JAX package's tiled path extracts SuperPoint keypoints,
    which do not."""
    a, b = shifted_pair(240, 320)
    kw = dict(tile_selection=TileSelection.GRID, grid=[1, 2], overlap=0)
    pm = SemiDenseMatcher({"superpoint_params": sp_tree, "refine": False},
                          device="cpu")
    pm.match(a, b, geometric_verification=GeometricVerification.NONE, **kw)
    jm = JSD({"superpoint_params": jax.tree.map(jnp.asarray, sp_tree),
              "refine": False})
    jm.match(a, b, geometric_verification=JGV.NONE,
             tile_selection=JTS.GRID, grid=[1, 2], overlap=0)
    assert len(pm.mkpts0) >= 20 and len(jm.mkpts0) >= 20

    def on_grid(mk):
        return np.mean(np.abs((mk + 0.5) % 16 - 8) < 1e-3)

    assert on_grid(pm.mkpts0) == 1.0
    assert on_grid(jm.mkpts0) < 0.5
