"""The port's SIFT == icepy4d_tpu's on the same images.

The blur (edges replicated) and the 2x linear upsample agree within
1e-6. Keypoints: both top-Ks break ties in their own order, so sets are
compared, never slots: at least 99% of the JAX side's valid keypoints
have a port keypoint within 1e-3 px whose descriptor is within 1e-4 of
theirs (the batched 3x3 solves of two LAPACKs may flip a candidate at
a threshold), and the valid counts differ by at most 1%. Two sizes, each
with `upsample` and `dual_orientation` both on and off across the
cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icepy4d_tpu.models import sift as jsift
from icepy4d_tpu_torch.models import sift as psift
from torch_port_inputs import shifted_pair

SIFT_OPT = dict(max_keypoints=512, contrast_threshold=0.015,
                edge_threshold=12.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for the port: the suite runs several test
    files at once on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CASES = [((128, 160), True, True), ((128, 160), False, False),
         ((96, 200), True, False), ((96, 200), False, True)]


def _images(h, w):
    a, b = shifted_pair()
    return np.stack([a[:h, :w], b[:h, :w]]).astype(np.float32) / 255.0


def test_blur_and_upsample_match_jax():
    img = _images(96, 200)
    for sigma in (0.6, 1.2, 2.9):
        kern = jsift._gaussian_kernel1d(sigma)
        ref = np.asarray(jax.jit(lambda x, k=kern: jsift._blur(x, k))(
            jnp.asarray(img)))
        got = psift._blur(torch.from_numpy(img),
                          torch.from_numpy(kern)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (2, 192, 400),
                                      "linear"))
    got = psift._upsample2x(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,upsample,dual", CASES,
                         ids=lambda v: str(v))
def test_keypoints_and_descriptors_match_jax(shape, upsample, dual):
    img = _images(*shape)
    opt = dict(SIFT_OPT, upsample=upsample, dual_orientation=dual)
    ref = {k: np.asarray(v) for k, v in
           jsift.SIFT(**opt).extract({}, jnp.asarray(img)).items()}
    got = {k: v.numpy() for k, v in
           psift.SIFT(**opt, device="cpu").extract(
               torch.from_numpy(img)).items()}
    for b in range(2):
        jm, pm = ref["mask"][b], got["mask"][b]
        assert jm.sum() > 50
        assert abs(int(pm.sum()) - int(jm.sum())) <= 0.01 * jm.sum()
        jk, pk = ref["keypoints"][b][jm], got["keypoints"][b][pm]
        jd, pd = ref["descriptors"][b][jm], got["descriptors"][b][pm]
        near = np.linalg.norm(jk[:, None] - pk[None], axis=-1) <= 1e-3
        found = 0
        for i in range(len(jk)):
            cand = np.flatnonzero(near[i])
            if len(cand) and np.abs(pd[cand] - jd[i]).max(1).min() <= 1e-4:
                found += 1
        assert found >= 0.99 * len(jk), (found, len(jk))
