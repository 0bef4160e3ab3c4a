"""The matching IO helpers and FeaturesBase: files written by one
package are read back exactly by the other, in both directions."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import icepy4d_tpu.matching as jmatching
import icepy4d_tpu.matching.utils as jutils
import icepy4d_tpu_torch.matching as matching
import icepy4d_tpu_torch.matching.utils as utils

WRITERS = {"port": matching.ImageMatcherBase.save_mkpts_as_txt,
           "jax": jmatching.ImageMatcherBase.save_mkpts_as_txt}
PACKAGES = {"port": utils, "jax": jutils}


def _matches(n=37, seed=0):
    r = np.random.default_rng(seed)
    return (r.uniform(0, 6000, (n, 2)).astype(np.float32),
            r.uniform(0, 4000, (n, 2)).astype(np.float32),
            r.uniform(0, 1, n).astype(np.float32))


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_keypoint_text_files_cross(tmp_path, writer, reader):
    mk0, mk1, _ = _matches()
    WRITERS[writer](SimpleNamespace(_mkpts0=mk0, _mkpts1=mk1), tmp_path)
    got = PACKAGES[reader].load_matches_from_disk(tmp_path)
    own = PACKAGES[writer].load_matches_from_disk(tmp_path)
    for g, o, m in zip(got, own, (mk0, mk1)):
        assert g.dtype == np.float32 and g.shape == m.shape
        np.testing.assert_array_equal(g, o)
        # two decimals in the text files
        np.testing.assert_allclose(g, m, atol=0.006)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("with_conf", [True, False])
def test_npz_files_cross(tmp_path, writer, reader, with_conf):
    mk0, mk1, conf = _matches(seed=1)
    path = tmp_path / "matches.npz"
    PACKAGES[writer].save_matches_as_npz(path, mk0, mk1,
                                         conf if with_conf else None)
    got = PACKAGES[reader].retrieve_matches_from_npz(path)
    want = (mk0, mk1, conf if with_conf else np.zeros(len(mk0), np.float32))
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_unequal_keypoint_files_raise(tmp_path):
    mk0, mk1, _ = _matches()
    WRITERS["port"](SimpleNamespace(_mkpts0=mk0, _mkpts1=mk1[:-1]), tmp_path)
    with pytest.raises(ValueError, match="match count"):
        utils.load_matches_from_disk(tmp_path)


def test_features_base_fields_equal_jax():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(matching.FeaturesBase) == fields(jmatching.FeaturesBase)
    kp = np.zeros((3, 2), np.float32)
    f = matching.FeaturesBase(kp)
    assert f.keypoints is kp and f.descriptors is None and f.scores is None
