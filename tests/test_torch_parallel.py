"""The batched season against the JAX package: the mesh of device slots,
the epipolar-band NN, the batched match step and `Pipeline.run_batched`
for both matcher families.

Tolerances: mesh shapes and errors as the JAX package's; the band NN's
matches exact and its scores within 1e-6 (one f32 computation, products
summed in another order); the step's matches0 exact (the same f32
computation). Everything after the RANSAC is held by outcome, as the
two packages draw their samples from different generators
(`jax.random` split per pair against one `torch.Generator` seeded at
each call): the same statuses, orientation-inlier and step-verified
counts within 3%, BA RMSE within 0.05 px, camera centres within 1 cm.
The JAX side runs on its 8 virtual CPU devices."""

import copy
import csv

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from icepy4d_tpu import Pipeline as JPipeline
from icepy4d_tpu.parallel import make_mesh as jmake_mesh
from icepy4d_tpu.parallel import make_sharded_match_step as jmake_step
from icepy4d_tpu.parallel.epoch_step import _nn_epipolar_band as jband
from icepy4d_tpu.utils.config import DotDict as JDotDict
from icepy4d_tpu_torch.models.convert import (lightglue_params, load_params,
                                              superpoint_state_dict)
from icepy4d_tpu_torch.models.lightglue import LightGlue
from icepy4d_tpu_torch.models.superpoint import SuperPoint
from icepy4d_tpu_torch.parallel import (make_mesh, make_sharded_match_step,
                                        replicate, shard_batch)
from icepy4d_tpu_torch.parallel.epoch_step import _nn_epipolar_band
from icepy4d_tpu_torch.pipeline import Pipeline
from torch_port_inputs import REPO_WEIGHTS, StereoSeason, shifted_pair

OPTIONS = {"superpoint_weights": str(REPO_WEIGHTS / "superpoint_synthetic.npz"),
           "lightglue_weights": str(REPO_WEIGHTS / "lightglue_synthetic.npz"),
           "activation_dtype": "float32"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- the mesh ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"tp": 2}, {"dp": 2}, {"dp": 4, "tp": 2}])
def test_make_mesh_factorizations_equal_jax(kw):
    assert make_mesh(8, device="cpu", **kw).shape == dict(jmake_mesh(8, **kw)
                                                          .shape)


def test_make_mesh_errors_and_slots():
    with pytest.raises(ValueError):
        make_mesh(8, dp=3, tp=3, device="cpu")
    m = make_mesh(4, tp=2, device="cpu")
    assert m.slots() == [torch.device("cpu")] * 2
    assert m.distinct == [torch.device("cpu")]
    assert make_mesh(device="cpu").shape == {"data": 1, "model": 1}
    if not torch.cuda.is_available():
        # the card by default, never a silent CPU mesh
        with pytest.raises(RuntimeError):
            make_mesh(4)


def test_shard_batch_and_replicate():
    mesh = make_mesh(4, device="cpu")
    x = torch.arange(8.0).reshape(8, 1)
    shards = shard_batch(mesh, {"x": x, "y": [x + 1]})
    assert len(shards) == 4
    assert torch.equal(torch.cat([s["x"] for s in shards]), x)
    assert torch.equal(shards[2]["y"][0], x[4:6] + 1)
    with pytest.raises(ValueError, match="divisible"):
        shard_batch(mesh, {"x": x[:6]})
    rep = replicate(mesh, {"k": np.eye(3, dtype=np.float32)})
    assert list(rep) == [torch.device("cpu")]
    assert torch.equal(rep[torch.device("cpu")]["k"], torch.eye(3))


def test_two_device_mesh_gathers_in_slot_order():
    """Slots on two distinct devices (cpu and cpu:0 are two torch.device
    values): each runs the rows of its slots, the outputs come back in
    slot order on the first slot's device."""
    from icepy4d_tpu_torch.parallel.epoch_step import _over_mesh
    from icepy4d_tpu_torch.parallel.mesh import Mesh

    a, b = torch.device("cpu"), torch.device("cpu", 0)
    grid = np.empty((4, 1), dtype=object)
    grid[:, 0] = [a, b, a, b]
    mesh = Mesh(grid)
    seen = []

    def fn(x, k):
        seen.append(x[:, 0].tolist())
        return {"y": x * k, "n": torch.full((len(x),), float(len(seen)))}

    x = torch.arange(8.0).reshape(8, 1)
    out = _over_mesh(mesh, fn, {"x": x}, {"k": torch.tensor(2.0)})
    assert torch.equal(out["y"], 2 * x) and out["y"].device == a
    # one call a device: slots 0 and 2 (rows 0-1, 4-5), then 1 and 3
    assert seen == [[0.0, 1.0, 4.0, 5.0], [2.0, 3.0, 6.0, 7.0]]
    assert out["n"].tolist() == [1, 1, 2, 2, 1, 1, 2, 2]
    with pytest.raises(ValueError, match="divisible"):
        _over_mesh(mesh, fn, {"x": x[:6]}, {"k": torch.tensor(2.0)})


# -- the epipolar-band NN ---------------------------------------------------

def _band_inputs(seed=0, b=2, m=64, n=80, d=32):
    r = np.random.default_rng(seed)
    d0 = r.normal(size=(b, m, d)).astype(np.float32)
    perm = r.permutation(n)[:m]
    d1 = r.normal(size=(b, n, d)).astype(np.float32)
    d1[:, perm] = d0 + 0.4 * r.normal(size=(b, m, d)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    k0 = r.uniform(0, 200, (b, m, 2)).astype(np.float32)
    k1 = r.uniform(0, 200, (b, n, 2)).astype(np.float32)
    k1[:, perm] = k0 + [12.0, 0.0] + r.normal(0, 1.5, (b, m, 2))
    mask0 = r.uniform(size=(b, m)) > 0.1
    mask1 = r.uniform(size=(b, n)) > 0.1
    # pair 0: a pure x translation (horizontal epipolar lines); pair 1 a
    # slightly rotated one
    t = np.array([1.0, 0.02, 0.0])
    F = np.stack([np.array([[0, 0, 0], [0, 0, -1], [0, 1, 0]], np.float64),
                  np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]],
                            [-t[1], t[0], 0]])]).astype(np.float32)
    return d0, d1, k0, k1, mask0, mask1, F


@pytest.mark.parametrize("band,ratio,min_sim", [(3.0, 0.9, 0.7),
                                                (1.0, 0.95, 0.3)])
def test_nn_epipolar_band_equals_jax(band, ratio, min_sim):
    args = _band_inputs()
    m, s = _nn_epipolar_band(*(torch.from_numpy(np.asarray(a))
                               for a in args), band, ratio, min_sim)
    jm, js = jband(*(jnp.asarray(a) for a in args), jnp.float32(band),
                   ratio, min_sim)
    jm, js = np.asarray(jm), np.asarray(js)
    assert (jm > -1).sum() > 20 and (jm == -1).sum() > 10
    np.testing.assert_array_equal(m.numpy(), jm)
    np.testing.assert_allclose(s.numpy(), js, atol=1e-6, rtol=0)


# -- the batched match step -------------------------------------------------

def test_match_step_matches_equal_jax():
    """Two 120x160 pairs, 128 keypoints, the bundled SuperPoint and the
    first 2 layers of the bundled LightGlue, f32."""
    from icepy4d_tpu.models.lightglue import LightGlue as JLightGlue
    from icepy4d_tpu.models.superpoint import SuperPoint as JSuperPoint

    sp_tree = load_params(REPO_WEIGHTS / "superpoint_synthetic.npz")
    lg_tree = load_params(REPO_WEIGHTS / "lightglue_synthetic.npz")
    lg_tree = dict(lg_tree, layers=lg_tree["layers"][:2],
                   assign=lg_tree["assign"][:2],
                   confidence=lg_tree["confidence"][:1])
    a, b = shifted_pair()
    crops = [(0, 0), (150, 200)]
    ims0 = np.stack([a[y:y + 120, x:x + 160] for y, x in crops]) / 255.0
    ims1 = np.stack([b[y:y + 120, x:x + 160] for y, x in crops]) / 255.0
    ims0, ims1 = ims0.astype(np.float32), ims1.astype(np.float32)
    K = np.array([[100.0, 0, 80], [0, 100.0, 60], [0, 0, 1]], np.float32)
    sp_kw = {"max_keypoints": 128, "detection_threshold": 0.0005}

    sp = SuperPoint(**sp_kw, device="cpu").load_state_dict(
        superpoint_state_dict(sp_tree))
    lg = LightGlue(n_layers=2, filter_threshold=0.0,
                   activation_dtype="float32", device="cpu")
    lg.load_state_dict(lightglue_params(lg_tree))
    step = make_sharded_match_step(make_mesh(2, device="cpu"), sp, lg,
                                   extract_chunk=1)
    out = step(torch.from_numpy(ims0), torch.from_numpy(ims1),
               torch.from_numpy(K), torch.from_numpy(K))

    jstep = jmake_step(jmake_mesh(2), JSuperPoint(**sp_kw,
                                                  precision="highest"),
                       JLightGlue(n_layers=2, filter_threshold=0.0,
                                  precision="highest"))
    jout = jstep(sp_tree, lg_tree, jnp.asarray(ims0), jnp.asarray(ims1),
                 jnp.asarray(K), jnp.asarray(K))
    m0, jm0 = out["matches0"].numpy(), np.asarray(jout["matches0"])
    assert (jm0 > -1).sum() > 40
    np.testing.assert_array_equal(m0, jm0)
    matched = m0 > -1
    for key in ("mkpts0", "mkpts1"):
        np.testing.assert_array_equal(out[key].numpy()[matched],
                                      np.asarray(jout[key])[matched])
    np.testing.assert_allclose(out["mscores0"].numpy(),
                               np.asarray(jout["mscores0"]), atol=1e-5)
    for key, shape in (("R", (2, 3, 3)), ("t", (2, 3)),
                       ("points3d", (2, 128, 3))):
        assert tuple(out[key].shape) == shape
    # the pairs are a pure image shift, a pose-free geometry on which the
    # essential consensus moves from 19 to 45 of 77 matches with the
    # generator's seed: the pose is held by its form, not its value
    R, t = out["R"].numpy(), out["t"].numpy()
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R.shape), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, atol=1e-5)
    valid, jvalid = out["valid"].numpy(), np.asarray(jout["valid"])
    assert not (valid & ~matched).any()
    assert np.isfinite(out["points3d"].numpy()[valid]).all()
    # at least a minimal sample's consensus in both packages
    assert (valid.sum(1) >= 8).all() and (jvalid.sum(1) >= 8).all()


# -- the batched season -----------------------------------------------------

def _season_cfg(root, cfg, name, **matching):
    cfg = copy.deepcopy(cfg)
    cfg["paths"]["results_dir"] = str(root / name)
    cfg["matching"] = dict(cfg["matching"], **matching)
    return cfg


def _run_both(root, cfg, **matching):
    pipe = Pipeline(_season_cfg(root, cfg, "port", **matching), device="cpu")
    eps = list(pipe.run_batched(mesh=make_mesh(4, tp=2, device="cpu")))
    jeps = list(JPipeline(JDotDict.wrap(_season_cfg(
        root, cfg, "jax", **matching))).run_batched(mesh=jmake_mesh(4, tp=2)))
    return root, pipe, eps, jeps


@pytest.fixture(scope="module")
def lightglue_seasons(tmp_path_factory):
    root = tmp_path_factory.mktemp("batched")
    cfg = StereoSeason(480, 640, 640.0).write(root, max_keypoints=512,
                                              options=OPTIONS)
    return _run_both(root, cfg)


@pytest.fixture(scope="module")
def sift_seasons(tmp_path_factory):
    """The smallest frames at which every SIFT epoch is ok in both
    packages (at 120x160 BA fails in both)."""
    root = tmp_path_factory.mktemp("batched_sift")
    cfg = StereoSeason(160, 240, 240.0).write(root, max_keypoints=1024)
    cfg["proc"]["save_checkpoints"] = False
    return _run_both(root, cfg, matcher="sift", max_keypoints=1024,
                     options={"dual_orientation": False})


def _agree(eps, jeps):
    assert len(eps) == len(jeps) == 3
    for e, j in zip(eps, jeps):
        q, jq = e.quality, j.quality
        assert (q["status"], q["flags"]) == (jq["status"], jq["flags"]) \
            == ("ok", [])
        n, jn = len(e.features["cam1"]), len(j.features["cam1"])
        assert abs(n - jn) <= 0.03 * jn
        s, js = q["stats"], jq["stats"]
        assert abs(s["n_orientation_inliers"] - js["n_orientation_inliers"]) \
            <= 0.03 * js["n_orientation_inliers"]
        assert abs(s["ba_rmse_px"] - js["ba_rmse_px"]) <= 0.05
        for c in ("cam1", "cam2"):
            np.testing.assert_allclose(e.cameras[c].C,
                                       np.asarray(j.cameras[c].C), atol=0.01)


def _track_ids_consistent(eps):
    seen = []
    for e in eps:
        ids = e.features["cam1"].track_ids_to_numpy()
        np.testing.assert_array_equal(ids, e.features["cam2"]
                                      .track_ids_to_numpy())
        seen.append(ids)
    allids = np.concatenate(seen)
    assert len(np.unique(allids)) == len(allids)


@pytest.mark.parametrize("family", ["lightglue", "sift"])
def test_batched_season_agrees(request, family):
    _root, _pipe, eps, jeps = request.getfixturevalue(f"{family}_seasons")
    _agree(eps, jeps)
    _track_ids_consistent(eps)
    _track_ids_consistent(jeps)


def test_batched_season_records_real_epochs(lightglue_seasons):
    """Groups {0, 1} and {2, 2 repeated}: three epochs with their sinks
    and checkpoints, and track ids consecutive from 0 (the padded pair
    allocates none)."""
    root, _pipe, eps, jeps = lightglue_seasons
    assert [e.timestamp for e in eps] == [e.timestamp for e in jeps]
    # each epoch's ids start where the last epoch's step matches ended
    starts = [int(e.features["cam1"].track_ids_to_numpy().min())
              for e in eps]
    assert starts[0] == 0 and starts == sorted(set(starts))
    for name in ("residuals_image.csv", "estimated_cameras.csv"):
        for pkg in ("port", "jax"):
            with open(root / pkg / name) as f:
                assert len(list(csv.reader(f))) == 4
    assert len(list((root / "port" / "epochs").rglob("*.pickle"))) == 3


def test_batched_sift_season_is_guided_by_the_prior(sift_seasons):
    """The SIFT family runs the guided second round, on the GCP prior of
    every epoch."""
    _root, pipe, eps, _ = sift_seasons
    assert pipe.matcher._guided_rounds > 0
    assert all(pipe._gcp_prior(e) is not None for e in eps)
    assert all(len(e.features["cam1"]) >= 100 for e in eps)


@pytest.mark.parametrize("matcher", ["semidense", "loftr"])
def test_run_batched_refuses_other_matchers(sift_seasons, matcher):
    root = sift_seasons[0]
    cfg = copy.deepcopy(dict(sift_seasons[1].cfg))
    cfg["paths"] = dict(cfg["paths"], results_dir=str(root / matcher))
    cfg["matching"] = {"matcher": matcher, "options": {"seed": 0}}
    with pytest.raises(ValueError, match="run_batched"):
        Pipeline(cfg, device="cpu").run_batched(
            mesh=make_mesh(1, device="cpu"))
