"""Checkpoints between the packages: the port's state dicts go back to
the JAX layout exactly (`models/convert.py::*_tree_from_state_dict`), the
port's `save_params` writes the flat `.npz` that icepy4d_tpu's
`load_params` reads and the other way round, and a SuperPoint trained by
the port's command line extracts in the JAX package as in the port
(keypoints and masks equal, scores and descriptors within 1e-4, as the
SuperPoint parity tests hold the dense outputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.models import convert as jconvert
from icepy4d_tpu.models.superpoint import SuperPoint as JSuperPoint
from icepy4d_tpu_torch.models import convert
from icepy4d_tpu_torch.models.superglue import superglue_tree
from icepy4d_tpu_torch.models.superpoint import SuperPoint
from icepy4d_tpu_torch.training import __main__ as cli
from torch_port_inputs import REPO_WEIGHTS


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_trees_equal(a, b):
    la, sa = jax.tree.flatten(a)
    lb, sb = jax.tree.flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


CASES = {
    "superpoint": (lambda: convert.load_params(
        REPO_WEIGHTS / "superpoint_synthetic.npz"),
        convert.superpoint_state_dict,
        convert.superpoint_tree_from_state_dict),
    "lightglue": (lambda: convert.load_params(
        REPO_WEIGHTS / "lightglue_synthetic.npz"),
        convert.lightglue_params, convert.lightglue_tree_from_state_dict),
    "aliked": (lambda: convert.load_params(
        REPO_WEIGHTS / "aliked_synthetic.npz"),
        convert.aliked_params, convert.aliked_tree_from_state_dict),
    "superglue": (lambda: superglue_tree(gnn_layers=2, seed=3),
                  convert.superglue_params,
                  convert.superglue_tree_from_state_dict),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_trips_bitwise(name):
    make, to_port, to_jax = CASES[name]
    tree = make()
    sd = to_port(tree)
    back = to_jax(sd)
    _assert_trees_equal(back, tree)
    again = to_port(back)
    assert list(again) == list(sd)
    for k in sd:
        assert torch.equal(again[k], sd[k]), k


def test_save_params_both_ways(tmp_path):
    tree = {"a": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "layers": [{"b": np.ones(2, np.float32)}, {}],
            "input_proj": {}, "s": np.float32(2.5)}
    convert.save_params(tmp_path / "port.npz", tree)
    _assert_trees_equal(jconvert.load_params(tmp_path / "port.npz"), tree)
    jconvert.save_params(tmp_path / "jax.npz", tree)
    _assert_trees_equal(convert.load_params(tmp_path / "jax.npz"), tree)
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)


def test_cli_checkpoints_load_in_jax(tmp_path):
    sp_out = tmp_path / "sp.npz"
    cli.main(["--device", "cpu", "superpoint", "--steps", "2", "--batch",
              "2", "--height", "64", "--width", "64", "--adapt-steps", "0",
              "--init", str(REPO_WEIGHTS / "superpoint_synthetic.npz"),
              "--out", str(sp_out)])
    al_out = tmp_path / "al.npz"
    cli.main(["--device", "cpu", "aliked", "--steps", "1", "--batch", "2",
              "--height", "64", "--width", "64", "--n-batches", "1",
              "--out", str(al_out)])
    bundled = jconvert.load_params(REPO_WEIGHTS / "aliked_synthetic.npz")
    trained = jconvert.load_params(al_out)
    assert jax.tree.structure(trained) == jax.tree.structure(bundled)
    assert all(a.shape == b.shape for a, b in zip(
        jax.tree.leaves(trained), jax.tree.leaves(bundled)))

    tree = jconvert.load_params(sp_out)
    init = jconvert.load_params(REPO_WEIGHTS / "superpoint_synthetic.npz")
    assert not np.array_equal(tree["params"]["convDb"]["kernel"],
                              init["params"]["convDb"]["kernel"])
    imgs = np.random.default_rng(0).uniform(0, 1, (1, 96, 128)).astype(
        np.float32)
    ref = JSuperPoint(max_keypoints=128).extract(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(imgs))
    sp = SuperPoint(max_keypoints=128, device="cpu").load_state_dict(
        convert.superpoint_state_dict(convert.load_params(sp_out)))
    got = sp.extract(torch.from_numpy(imgs))
    mask = np.asarray(ref["mask"])
    assert mask.sum() >= 20
    np.testing.assert_array_equal(got["mask"].numpy(), mask)
    np.testing.assert_array_equal(got["keypoints"].numpy()[mask],
                                  np.asarray(ref["keypoints"])[mask])
    for k in ("scores", "descriptors"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-4, rtol=0)
