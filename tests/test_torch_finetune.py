"""The port's LightGlue fine-tune on verified real correspondences
(`training/lightglue_train.py::collect_epoch_pairs`,
`make_correspondence_dataset`, the explicit-GT train step and
evaluation) == icepy4d_tpu's, on a 2-epoch 480x640 season written by the
port's `Pipeline` on the CPU.

Tolerances: correspondence datasets' keypoints and descriptors within
1e-5, masks, ground truth and unmatchable flags equal; the explicit-GT
train step's loss within 1e-5 relative and every gradient tensor within
1e-4 of its largest magnitude; evaluation counts equal.
"""

import pickle

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icepy4d_tpu.models.convert import load_params as jload_params
from icepy4d_tpu.models.lightglue import LightGlue as JLightGlue
from icepy4d_tpu.models.superpoint import SuperPoint as JSuperPoint
from icepy4d_tpu.training import lightglue_train as jtrain
from icepy4d_tpu_torch.core.epoch import Epoch
from icepy4d_tpu_torch.models.convert import (lightglue_params, load_params,
                                              superpoint_state_dict)
from icepy4d_tpu_torch.models.lightglue import LightGlue
from icepy4d_tpu_torch.models.superpoint import SuperPoint
from icepy4d_tpu_torch.pipeline import Pipeline
from icepy4d_tpu_torch.training import __main__ as cli
from icepy4d_tpu_torch.training import _optim
from icepy4d_tpu_torch.training import lightglue_train as ttrain
from torch_port_inputs import REPO_WEIGHTS, StereoSeason
from training_parity import capture, rel

OPTIONS = {"superpoint_weights": str(REPO_WEIGHTS / "superpoint_synthetic.npz"),
           "lightglue_weights": str(REPO_WEIGHTS / "lightglue_synthetic.npz"),
           "activation_dtype": "float32"}
SCALE = 0.5
N_KPTS = 64


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def season(tmp_path_factory):
    root = tmp_path_factory.mktemp("finetune")
    cfg = StereoSeason(480, 640, 640.0).write(root / "season", n_epochs=2,
                                              max_keypoints=512,
                                              options=OPTIONS)
    epochs = Pipeline(cfg, device="cpu").run()
    assert [e.quality["status"] for e in epochs] == ["ok", "ok"]
    return root, cfg["paths"]["results_dir"]


@pytest.fixture(scope="module")
def pairs(season):
    return ttrain.collect_epoch_pairs(season[1], image_scale=SCALE)


def test_collect_epoch_pairs(season, pairs, tmp_path):
    root, results = season
    pickles = sorted((root / "season" / "res").glob("epochs/*/*.pickle"))
    assert len(pickles) == 2 and len(pairs) == 2
    for pkl, pr in zip(pickles, pairs):
        ep = Epoch.read_pickle(pkl)
        f0, f1 = ep.features["cam1"], ep.features["cam2"]
        ids0 = dict(zip(f0.track_ids_to_numpy().tolist(),
                        f0.kpts_to_numpy()))
        ids1 = dict(zip(f1.track_ids_to_numpy().tolist(),
                        f1.kpts_to_numpy()))
        common = sorted(set(ids0) & set(ids1))
        assert len(common) == len(pr["corr0"]) >= 50
        # cv2's pixel-centre rescale: (x + 0.5) * s - 0.5
        np.testing.assert_allclose(
            pr["corr0"], (np.stack([ids0[i] for i in common]) + 0.5)
            * SCALE - 0.5, atol=1e-5)
        np.testing.assert_allclose(
            pr["corr1"], (np.stack([ids1[i] for i in common]) + 0.5)
            * SCALE - 0.5, atol=1e-5)
        g = cv2.imread(str(ep.images["cam1"].path), cv2.IMREAD_GRAYSCALE)
        g = cv2.resize(g, (320, 240), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(pr["img0"], g.astype(np.float32)
                                      / 255.0)

    # a failed epoch is skipped, as are pairs under min_corr
    bad = tmp_path / "epochs" / "e"
    bad.mkdir(parents=True)
    ep = Epoch.read_pickle(pickles[0])
    ep.flag("test", status="failed")
    with open(bad / "e.pickle", "wb") as fh:
        pickle.dump(ep, fh)
    assert ttrain.collect_epoch_pairs(tmp_path) == []
    assert len(ttrain.collect_epoch_pairs(tmp_path,
                                          statuses=("failed",))) == 1
    assert ttrain.collect_epoch_pairs(results, min_corr=10 ** 6) == []
    assert len(ttrain.collect_epoch_pairs(results, cams=("cam2", "cam1"))
               ) == 2


@pytest.fixture(scope="module")
def corr_datasets(pairs):
    tree = load_params(REPO_WEIGHTS / "superpoint_synthetic.npz")
    jsp = JSuperPoint(max_keypoints=N_KPTS, detection_threshold=0.0005)
    jp = jax.tree.map(jnp.asarray, tree)
    ref = jtrain.make_correspondence_dataset(
        np.random.default_rng(0), lambda im, kp: jsp.describe_at(jp, im, kp),
        lambda im: jsp.extract(jp, im), pairs, n_batches=2, batch=2,
        n_kpts=N_KPTS)
    sp = SuperPoint(max_keypoints=N_KPTS, detection_threshold=0.0005,
                    device="cpu").load_state_dict(superpoint_state_dict(tree))
    got = ttrain.make_correspondence_dataset(
        np.random.default_rng(0), sp.describe_at, sp.extract, pairs,
        n_batches=2, batch=2, n_kpts=N_KPTS)
    return got, {k: np.asarray(v) for k, v in ref.items()}


def test_make_correspondence_dataset(corr_datasets):
    got, ref = corr_datasets
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if k.startswith(("kpts", "desc")):
            np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(got[k], v)
    gt0 = ref["gt0"]
    assert (gt0 >= 0).sum() == 2 * 2 * N_KPTS // 2      # half positives
    assert ref["unm0"].any() and ref["unm1"].any()


def test_explicit_gt_step_and_evaluation(corr_datasets):
    _, ds = corr_datasets
    model = JLightGlue(n_layers=2)
    params = model.init(4)
    tx = optax.chain(capture(), optax.clip_by_global_norm(1.0),
                     optax.adam(1e-3))
    step = jtrain.make_train_step(model, tx, explicit_gt=True)
    batch = {k: v[0] for k, v in ds.items()}
    _, opt, metrics = step(params, tx.init(params),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    tree = jax.tree.map(np.asarray, params)
    lg = LightGlue(n_layers=2, device="cpu")
    lg.load_state_dict(lightglue_params(tree))
    got = ttrain.make_train_step(
        lg, _optim.Adam(lg.parameters(), 1e-3, clip_norm=1.0),
        explicit_gt=True)({k: torch.from_numpy(v) for k, v in batch.items()})
    assert rel(got["loss"], metrics["loss"]) <= 1e-5
    assert int(got["n_gt"]) == int(metrics["n_gt"]) == N_KPTS
    ref = lightglue_params(jax.tree.map(np.asarray, opt[0]))
    for name, p in lg.named_parameters():
        scale = float(ref[name].abs().max())
        assert float((p.grad - ref[name]).abs().max()) <= 1e-4 * scale, name

    # evaluation with the unmatchable flags: precision_labeled too
    r = jtrain.evaluate_matching(model, params, ds, filter_threshold=0.0)
    lg.load_state_dict(lightglue_params(tree))
    g = ttrain.evaluate_matching(lg, None, ds, filter_threshold=0.0)
    assert g == r and "precision_labeled" in g and g["n_pred"] > 0


def test_finetune_cli(season, tmp_path):
    """The command line's fine-tune on the season: held-out pair,
    homography batches mixed in, keep-best saves; the checkpoint loads
    in the JAX package and its LightGlue runs on it."""
    out = tmp_path / "ft.npz"
    cli.main(["--device", "cpu", "finetune", "--results-dir", season[1],
              "--steps", "2", "--batch", "2", "--n-batches", "2",
              "--eval-batches", "1", "--max-keypoints", str(N_KPTS),
              "--image-scale", str(SCALE), "--n-layers", "2", "--init", "",
              "--mix-homography", "1", "--save-every", "1",
              "--scan-chunk", "1", "--out", str(out)])
    tree = jload_params(out)
    assert len(tree["layers"]) == 2
    d = jnp.zeros((1, 8, 256))
    k = jnp.asarray(np.random.default_rng(0).uniform(0, 100, (1, 8, 2)),
                    jnp.float32)
    m = jnp.ones((1, 8), bool)
    res = JLightGlue(n_layers=2).match(
        jax.tree.map(jnp.asarray, tree),
        {"kpts0": k, "desc0": d, "mask0": m, "size0": None,
         "kpts1": k, "desc1": d, "mask1": m, "size1": None})
    assert res["matches0"].shape == (1, 8)
