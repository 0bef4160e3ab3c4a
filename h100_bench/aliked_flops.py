"""The benchmark's operation and byte counts of ALIKED-n16 in front of
LightGlue (`aliked_lightglue`), from the published architecture at the
inputs' shapes, never the program's own counters.

A FLOP is one multiply or one add of a convolution or product (2 a
multiply-accumulate); the element-wise work (batch norms, gates,
pooling, the bilinear taps, upsampling, norms, NMS and the soft-argmax)
is left out, as `flops.py` leaves it out. The dense map runs on the tile
padded to a multiple of 32 (the published `InputPadder`):

  block1      3 -> 16 and 16 -> 16, 3x3, at 1/1
  block2      16 -> 32 and 32 -> 32, 3x3, and the 1x1 16 -> 32, at 1/2
  block3      at 1/8, each deformable convolution Cin -> Cout as its
              offset convolution Cin -> 18 (3x3) and its 3x3 product,
              and the 1x1 32 -> 64
  block4      the same at 1/32, 64 -> 128
  aggregation 1x1 16, 32, 64, 128 -> 32 at each block's scale
  score head  1x1 128 -> 8, 3x3 8 -> 4, 4 -> 4, 4 -> 1 at 1/1
  SDDH        a keypoint: 3x3 valid 128 -> 32, 1x1 32 -> 32, and for
              each of its 16 positions sf_conv 128 -> 128 and the
              aggregation 128 x 128

A deformable convolution's least bytes: its input map read once, its 18
offset channels and its output written once, float32.
"""

from __future__ import annotations

from h100_bench import flops
from h100_bench.readers import keypoint_counts, matcher_module, tiles
from h100_bench.reference.tiles import exhaustive_pairs

DIVISOR = 32


def padded(h: int, w: int) -> tuple:
    return -(-h // DIVISOR) * DIVISOR, -(-w // DIVISOR) * DIVISOR


def dcn_layers(cfg: dict, h: int, w: int) -> list:
    """(h, w, cin, cout) of the four deformable convolutions of one tile
    of h x w (unpadded)."""
    c1, c2, c3, c4 = cfg["channels"]
    hp, wp = padded(h, w)
    return [(hp // 8, wp // 8, c2, c3), (hp // 8, wp // 8, c3, c3),
            (hp // 32, wp // 32, c3, c4), (hp // 32, wp // 32, c4, c4)]


def dcn_counts(cfg: dict, h: int, w: int) -> list:
    """(FLOPs, bytes) of each of a tile's deformable convolutions."""
    return [(flops.conv(a, b, ci, 18, 3) + flops.conv(a, b, ci, co, 3),
             4.0 * a * b * (ci + 18 + co))
            for a, b, ci, co in dcn_layers(cfg, h, w)]


def dcn_flops(cfg: dict, h: int, w: int) -> float:
    return sum(f for f, _ in dcn_counts(cfg, h, w))


def dcn_bytes(cfg: dict, h: int, w: int) -> float:
    return sum(b for _, b in dcn_counts(cfg, h, w))


def extractor_flops(cfg: dict, h: int, w: int, n_keypoints: float) -> float:
    """Product FLOPs of one tile of h x w with n_keypoints keypoints."""
    c1, c2, c3, c4 = cfg["channels"]
    dim, m = cfg["dim"], cfg["M"]
    q = dim // 4
    hp, wp = padded(h, w)
    conv = flops.conv
    total = conv(hp, wp, 3, c1, 3) + conv(hp, wp, c1, c1, 3)
    a, b = hp // 2, wp // 2
    total += conv(a, b, c1, c2, 3) + conv(a, b, c2, c2, 3) \
        + conv(a, b, c1, c2, 1)
    total += dcn_flops(cfg, h, w)
    total += conv(hp // 8, wp // 8, c2, c3, 1) \
        + conv(hp // 32, wp // 32, c3, c4, 1)
    total += conv(hp, wp, c1, q, 1) + conv(hp // 2, wp // 2, c2, q, 1) \
        + conv(hp // 8, wp // 8, c3, q, 1) + conv(hp // 32, wp // 32, c4, q, 1)
    total += conv(hp, wp, dim, 8, 1) + conv(hp, wp, 8, 4, 3) \
        + conv(hp, wp, 4, 4, 3) + conv(hp, wp, 4, 1, 3)
    k = cfg["K"]
    per_kpt = 2.0 * (dim * k * k * 2 * m + 2 * m * 2 * m
                     + m * dim * dim + m * dim * dim)
    return total + n_keypoints * per_kpt


def _tile(run) -> tuple:
    lim = tiles(run)
    return int(lim[0, 3]), int(lim[0, 2])


def matcher_flops(cfg: dict, m: float, n: float, module) -> float:
    """LightGlue's FLOPs of a tile pair of m and n keypoints:
    `reference/lightglue.py::flops`, whose input projection is d -> d,
    with the projection from `input_dim`."""
    d = cfg["descriptor_dim"]
    return module.flops(cfg, m, n) \
        - 2.0 * (m + n) * d * (d - cfg["input_dim"])


def pair_flops(run) -> float:
    """A stereo pair's product FLOPs: ALIKED-n16 over every tile of both
    frames, LightGlue over every EXHAUSTIVE tile pair, at the
    reference's keypoint counts."""
    h, w = _tile(run)
    ext = run.config["extractor"]
    n0, n1 = keypoint_counts(run)
    total = sum(extractor_flops(ext, h, w, n) for n in list(n0) + list(n1))
    mod = matcher_module(run)
    return total + sum(matcher_flops(run.config["matcher"], n0[a], n1[b], mod)
                       for a, b in exhaustive_pairs(len(n0)))


def dcn_pair_bound_s(run) -> float:
    """The least time of a pair's deformable convolutions: each one's
    larger of FLOPs at the dense bf16 peak and bytes at the memory
    rate."""
    h, w = _tile(run)
    one = sum(flops.lower_bound(b, f)[0]
              for f, b in dcn_counts(run.config["extractor"], h, w))
    return 2 * len(tiles(run)) * one
