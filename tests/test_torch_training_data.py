"""The port's synthetic training data (`icepy4d_tpu_torch/training/
synthetic.py`) == icepy4d_tpu's, bit for bit: the same draws from one
`np.random.default_rng(seed)` in the same order give the same images,
corners, labels and homographies."""

import cv2
import numpy as np
import pytest

from icepy4d_tpu.training import synthetic as jsyn
from icepy4d_tpu_torch.training import synthetic as tsyn


def _equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_synthetic_samples_bitwise(seed):
    r0, r1 = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(12):           # every shape kind comes up
        _equal(jsyn.synthetic_sample(r0, 96, 128),
               tsyn.synthetic_sample(r1, 96, 128))
    assert r0.integers(1 << 30) == r1.integers(1 << 30)   # same stream


@pytest.mark.parametrize("draw", ["draw_polygon", "draw_lines",
                                  "draw_star", "draw_checkerboard",
                                  "draw_ellipse"])
def test_each_shape_bitwise(draw):
    r0, r1 = np.random.default_rng(5), np.random.default_rng(5)
    a = np.full((80, 112), 0.4, np.float32)
    b = a.copy()
    _equal(getattr(jsyn, draw)(r0, a), getattr(tsyn, draw)(r1, b))
    _equal(a, b)


def test_batches_and_labels_bitwise():
    r0, r1 = np.random.default_rng(7), np.random.default_rng(7)
    _equal(jsyn.make_batch(r0, 3, 64, 96), tsyn.make_batch(r1, 3, 64, 96))
    _equal(jsyn.make_pair_batch(r0, 3, 64, 96),
           tsyn.make_pair_batch(r1, 3, 64, 96))
    _equal(jsyn.random_homography(r0, 120, 160, 0.3),
           tsyn.random_homography(r1, 120, 160, 0.3))
    corners = np.array([[3.2, 4.9], [63.0, 7.5], [8.0, 8.0], [70.0, 1.0],
                        [-1.0, 5.0]], np.float32)
    _equal(jsyn.corners_to_cells(corners, 64, 64),
           tsyn.corners_to_cells(corners, 64, 64))


def test_real_patch_pool_and_pairs_bitwise(tmp_path):
    rng = np.random.default_rng(11)
    for i, (h, w) in enumerate(((150, 210), (90, 100), (60, 80))):
        img = (rng.uniform(0, 255, (h, w))).astype(np.uint8)
        cv2.imwrite(str(tmp_path / f"f{i}.png"), img)
    (tmp_path / "notes.txt").write_text("not an image")
    pool_j = jsyn.load_real_patch_pool(tmp_path)
    pool_t = tsyn.load_real_patch_pool(tmp_path, max_images=2)
    assert len(pool_j) == 3 and len(pool_t) == 2
    for a, b in zip(pool_j, pool_t):
        _equal(a, b)
    r0, r1 = np.random.default_rng(3), np.random.default_rng(3)
    # the 60x80 frame is smaller than the patch: the resize branch
    for _ in range(3):
        _equal(jsyn.make_real_pair_batch(r0, pool_j, 4, 64, 96),
               tsyn.make_real_pair_batch(r1, pool_j, 4, 64, 96))
    with pytest.raises(FileNotFoundError):
        tsyn.load_real_patch_pool(tmp_path / "empty_dir_that_is_absent")
