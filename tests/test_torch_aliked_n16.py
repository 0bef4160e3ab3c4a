"""The port's published ALIKED-n16 (`models/aliked_n16.py`) against the
benchmark's plain reference (`h100_bench/reference/aliked.py`) on the CPU
in float32, on the reference's seeded random weights at small sizes, and
the whole `LightGlueMatcher(extractor="aliked_n16")` match against the
reference LightGlue over reference features.

Tolerances, each above what float32 reorderings give and far below what
a slip in the arithmetic gives:
  deformable convolution, maps   1e-5 of the largest magnitude: the port
                  gathers the taps and takes one 1x1 product over C * 9,
                  the reference sums nine per-tap products; the port folds
                  the batch norms into the convolutions and block1's three
                  input channels into one
  keypoints       1e-3 px: the soft-argmax at temperature 0.1 multiplies
                  a score's rounding by 10 before the exponential
  scores          1e-5
  descriptors     1e-4 in L2: SDDH's offsets move the samples by the
                  offsets' rounding times the map's gradient
  matches         the program's matches0 equal the reference's mutual
                  choices above the threshold on all but 1% of the rows
                  (near ties of the double softmax)
"""

import numpy as np
import pytest
import torch

from h100_bench import weights
from h100_bench.reference import aliked as ref
from h100_bench.reference import lightglue as ref_lg
from h100_bench.reference.tiles import exhaustive_pairs, tile_limits
from icepy4d_tpu_torch.matching import (GeometricVerification,
                                        LightGlueMatcher, Quality,
                                        TileSelection)
from icepy4d_tpu_torch.models import aliked_n16 as port

LG = {"arch": "lightglue", "input_dim": 128, "descriptor_dim": 256,
      "n_layers": 3, "num_heads": 4}
K = 64
# distances from differences (the |a|^2 + |b|^2 - 2ab form loses the
# sub-pixel part)
EXACT = "donot_use_mm_for_euclid_dist"


@pytest.fixture(scope="module")
def tree():
    return ref.random_tree(torch.Generator().manual_seed(7), "cpu",
                           {"arch": "aliked"})


@pytest.fixture(scope="module")
def model(tree):
    m = port.ALIKEDN16(max_keypoints=K, device="cpu")
    return m.load_state_dict(port.load_state_dict_source(
        weights.to_host(tree)))


def _frames(h=96, w=128, n=2, seed=5):
    gen = torch.Generator().manual_seed(seed)
    low = torch.rand(n, 1, h // 8, w // 8, generator=gen)
    return torch.nn.functional.interpolate(low, size=(h, w),
                                           mode="bicubic").clamp(0, 1)[:, 0]


def _close(a, b, rel):
    assert a.shape == b.shape
    assert (a - b).abs().max() <= rel * b.abs().max()


@pytest.mark.parametrize("shape", [(1, 8, 12, 16), (2, 5, 7, 9)])
def test_deformable_convolution_matches_its_definition(shape):
    """Offsets of a few taps' width, many beyond the map's edge."""
    gen = torch.Generator().manual_seed(11)
    b, c, h, w = shape
    x = torch.randn(shape, generator=gen)
    off = 3.0 * torch.randn(b, 18, h, w, generator=gen)
    wt = torch.randn(6, c, 3, 3, generator=gen)
    ys = torch.arange(h)[:, None] + off[:, 0::2]
    assert ((ys < 0) | (ys > h - 1)).any()
    got = port.deform_conv3x3(x, off, wt)
    _close(got, ref.deform_conv(x, off, wt, "f32"), 1e-5)
    # and it is not the plain convolution these offsets move away from
    plain = torch.nn.functional.conv2d(x, wt, padding=1)
    assert (got - plain).abs().max() > 0.1 * plain.abs().max()


@pytest.mark.parametrize("size", [(96, 128), (90, 130)])
def test_dense_maps_match(tree, model, size):
    img = _frames(*size, n=1)
    r_feat, r_score = ref.dense(tree, img[:, None], "f32")
    h, w = size
    oy, ox = ((-h) % 32) // 2, ((-w) % 32) // 2
    with torch.inference_mode():
        x = torch.nn.functional.pad(img[:, None], (ox, (-w) % 32 - ox, oy,
                                                   (-h) % 32 - oy),
                                    mode="replicate")
        score, feat = model._head(model._backbone(x))
    _close(score[:, oy:oy + h, ox:ox + w], r_score[:, 0], 1e-5)
    _close(feat[:, :, oy:oy + h, ox:ox + w], r_feat, 1e-5)


def test_the_random_offsets_are_a_few_pixels(tree):
    """block3's first offsets are about a pixel and never zero (a zero
    offset is a plain convolution and would hide a sampling error)."""
    img = _frames(n=1)
    x = img[:, None].expand(-1, 3, -1, -1)
    x = torch.nn.functional.avg_pool2d(ref.conv_block(tree, "block1", x,
                                                      "f32"), 2)
    x = ref.res_block(tree, "block2", x, False, "f32")
    x = torch.nn.functional.avg_pool2d(x, 4)
    off = torch.nn.functional.conv2d(x, tree["block3.conv1.offset_conv.weight"],
                                     tree["block3.conv1.offset_conv.bias"],
                                     padding=1)
    assert 0.3 < off.abs().mean() < 5.0 and (off != 0).all()


@pytest.fixture(scope="module")
def extracted(tree, model):
    img = _frames()
    r = ref.extract(tree, img, K, "f32")
    return img, r, model.extract(img)


def test_dkd_keypoints_and_scores_match(extracted):
    _, r, p = extracted
    assert p["mask"].all() and r["mask"].all()
    for i in range(2):
        d = torch.cdist(p["keypoints"][i], r["keypoints"][i], compute_mode=EXACT)
        gap, j = d.min(1)
        assert gap.max() <= 1e-3
        assert len(set(j.tolist())) == K           # one to one
        _close(p["scores"][i], r["scores"][i][j], 1e-5)
    # the soft-argmax moved the keypoints off the pixel grid
    frac = p["keypoints"] - p["keypoints"].round()
    assert frac.abs().max() > 0.1


def test_sddh_descriptors_match(tree, model, extracted):
    img, r, p = extracted
    for i in range(2):
        d = torch.cdist(p["keypoints"][i], r["keypoints"][i], compute_mode=EXACT)
        j = d.argmin(1)
        err = (p["descriptors"][i] - r["descriptors"][i][j]).norm(dim=-1)
        assert err.max() <= 1e-4


def test_the_published_layout_loads(tmp_path):
    """A state dict of random tensors under the published names loads
    through `_load_extractor` from a .pth, an .npz and a dict."""
    gen = torch.Generator().manual_seed(3)
    sd = {k: (torch.randn(s, generator=gen) if s != () else
              torch.tensor(0)) for k, s in ref._shapes().items()}
    pth = tmp_path / "aliked-n16.pth"
    torch.save(sd, pth)
    npz = tmp_path / "aliked-n16.npz"
    np.savez(npz, **{k: v.numpy() for k, v in sd.items()})
    for opt in ({"superpoint_weights": str(pth)},
                {"superpoint_weights": str(npz)},
                {"superpoint_params": {k: v.numpy() for k, v in sd.items()}}):
        m = LightGlueMatcher({"extractor": "aliked_n16", "max_keypoints": 32,
                              **opt}, device="cpu")
        net = m._superpoint(32).net.state_dict()
        assert set(net) == set(sd)
        for k, v in sd.items():
            assert torch.equal(net[k], v.to(net[k].dtype)), k


def test_lightglue_over_aliked_matches_the_reference(tree):
    """Tiled `match()` with ALIKED-n16 and LightGlue at input_dim 128,
    float32 trunk: the model's inputs are the reference's features of
    each tile, and its matches the reference LightGlue's over them."""
    lg = ref.random_tree(torch.Generator().manual_seed(9), "cpu", LG)
    m = LightGlueMatcher({
        "extractor": "aliked_n16", "max_keypoints": K, "n_layers": 3,
        "activation_dtype": "float32", "filter_threshold": 0.1,
        "superpoint_params": weights.to_host(tree),
        "matcher_params": weights.to_host(lg)}, device="cpu")
    seen = []
    inner = m.matcher.match

    def match(data, *args, **kwargs):
        out = inner(data, *args, **kwargs)
        seen.append((data, out))
        return out

    m.matcher.match = match
    frames = [(255 * _frames(192, 256, n=1)[0]).to(torch.uint8).numpy()]
    frames.append(np.roll(frames[0], (8, 16), (0, 1)))
    m.match(*frames, quality=Quality.HIGH,
            tile_selection=TileSelection.EXHAUSTIVE, grid=[2, 2], overlap=16,
            geometric_verification=GeometricVerification.NONE)
    (data, out), = seen
    lim = tile_limits(192, 256, [2, 2], 16)
    pairs = exhaustive_pairs(len(lim))
    want = {}
    for s, frame in zip("01", frames):
        g = torch.from_numpy(frame).float() / 255.0
        feats = [ref.extract(tree, g[y:y + th, x:x + tw][None], K, "f32")
                 for x, y, tw, th in lim]
        idx = [pair[int(s)] for pair in pairs]
        for name, key in (("kpts", "keypoints"), ("desc", "descriptors"),
                          ("mask", "mask")):
            want[name + s] = torch.cat([feats[t][key] for t in idx])
        assert (data["kpts" + s] - want["kpts" + s]).abs().max() <= 1e-3
        assert (data["desc" + s] - want["desc" + s]).norm(dim=-1).max() \
            <= 1e-4
        want["size" + s] = data["size" + s]
    la = ref_lg.log_assignment(
        lg, want, {"trunk": "f32", "attention": "f32", "assignment": "f32"},
        heads=4)
    block = la[:, :-1, :-1]
    a0, a1 = block.argmax(2), block.argmax(1)
    mutual = a1.gather(1, a0) == torch.arange(a0.shape[1])
    ref_m0 = torch.where(mutual & (block.amax(2).exp() > 0.1), a0, -1)
    rows = int(want["mask0"].sum())
    assert (ref_m0 >= 0).sum() > 20
    assert int((out["matches0"] != ref_m0).sum()) <= 0.01 * rows


def test_spans_and_counters_of_a_tiled_match(tree):
    """A tiled match records ALIKED-n16's spans under `match.extraction`
    and its counters: four deformable convolutions an extraction, K
    valid keypoints a tile."""
    m = LightGlueMatcher({"extractor": "aliked_n16", "max_keypoints": K,
                          "superpoint_params": weights.to_host(tree),
                          "seed": 1}, device="cpu")
    img = (255 * _frames(192, 256, n=1)[0]).to(torch.uint8).numpy()
    m.match(img, img, quality=Quality.HIGH,
            tile_selection=TileSelection.EXHAUSTIVE, grid=[2, 2], overlap=16,
            geometric_verification=GeometricVerification.NONE)
    names = {s.name: m.timer.spans[s.parent].name for s in m.timer.spans
             if s.name.startswith("match.aliked.")}
    assert names == {"match.aliked.backbone": "match.extraction",
                     "match.aliked.dcn": "match.aliked.backbone",
                     "match.aliked.head": "match.extraction",
                     "match.aliked.dkd": "match.extraction",
                     "match.aliked.sddh": "match.extraction"}
    assert {"aliked_backbone", "aliked_dcn", "aliked_head", "aliked_dkd",
            "aliked_sddh"} <= set(m.timer.times)
    c = m.counters
    assert c["dcn"] == 4 * len(c["keypoints"])
    assert torch.cat(c["keypoints"]).tolist() == [K] * 8
    assert int(c["offsets_clamped"]) == 0
    assert int(c["patches_clamped"]) >= 0
