"""The benchmark's operation and byte counts of LoFTR (outdoor,
dual softmax) at a configuration's widths, from the shapes alone, never
the program's counters. As in `flops.py`, a FLOP is one multiply or one
add of a product in a convolution or a matrix product; element-wise work
(norms, activations, softmax, the elu feature map) is left out.
"""

from __future__ import annotations

import numpy as np

from h100_bench import flops
from h100_bench.reference.tiles import tile_limits

# bytes a kept coarse match writes: i and j (int64), confidence (f32),
# valid (bool)
MATCH_BYTES = 8 + 8 + 4 + 1


def backbone(cfg: dict, h: int, w: int) -> float:
    """ResNet-FPN 8-2 over one (h, w) image."""
    i0 = cfg["initial_dim"]
    d0, d1, d2 = cfg["block_dims"]
    s2, s4, s8 = (h // 2) * (w // 2), (h // 4) * (w // 4), (h // 8) * (w // 8)

    def conv(px, cin, cout, k):
        return flops.conv(px, 1, cin, cout, k)

    def block(px, cin, cout, down):
        return conv(px, cin, cout, 3) + conv(px, cout, cout, 3) \
            + (conv(px, cin, cout, 1) if down else 0.0)

    return (conv(s2, 1, i0, 7)
            + block(s2, i0, d0, False) + block(s2, d0, d0, False)
            + block(s4, d0, d1, True) + block(s4, d1, d1, False)
            + block(s8, d1, d2, True) + block(s8, d2, d2, False)
            + conv(s8, d2, d2, 1)                                  # layer3_outconv
            + conv(s4, d1, d2, 1) + conv(s4, d2, d2, 3)
            + conv(s4, d2, d1, 3)                                  # layer2 FPN
            + conv(s2, d0, d1, 1) + conv(s2, d1, d1, 3)
            + conv(s2, d1, d0, 3))                                 # layer1 FPN


def encoder(d: int, heads: int, n_q: int, n_s: int) -> float:
    """One linear-attention encoder layer: n_q queries over n_s sources
    (q, k, v and merge projections, K^T V, the normaliser, Q (K^T V) and
    the [x | message] MLP 2d -> 2d -> d)."""
    hd = d // heads
    proj = 2.0 * n_q * d * d * 2 + 2.0 * n_s * d * d * 2       # q, merge; k, v
    attn = 2.0 * n_s * d * hd + 2.0 * n_q * d + 2.0 * n_q * d * hd
    mlp = 2.0 * n_q * (2 * d) * (2 * d) + 2.0 * n_q * (2 * d) * d
    return proj + attn + mlp


def coarse(cfg: dict, tokens: int) -> float:
    """The coarse transformer of one tile pair: per (self, cross) pair
    four encoder applications over `tokens` on each side."""
    return 4 * cfg["coarse_pairs"] * encoder(cfg["d_model_c"], cfg["nhead"],
                                             tokens, tokens)


def similarity(cfg: dict, tokens: int) -> float:
    """The L0 x L1 similarity product of one tile pair."""
    return 2.0 * tokens * tokens * cfg["d_model_c"]


def fine(cfg: dict, matches: float) -> float:
    """The fine stage over `matches` kept matches of one tile pair: the
    down projection and the merge on both sides, the fine transformer
    over the windows, the centre-against-window product."""
    dc, df = cfg["d_model_c"], cfg["d_model_f"]
    ww = cfg["fine_window"] ** 2
    per = (2 * 2.0 * dc * df + 2 * 2.0 * ww * 2 * df * df
           + 4 * cfg["fine_pairs"] * encoder(df, cfg["nhead"], ww, ww)
           + 2.0 * ww * df)
    return matches * per


def coarse_match_bound_s(cfg: dict, tokens: int, matches: float) -> float:
    """The least time of one tile pair's coarse matching: the larger of
    the similarity product at the card's highest dense rate and c0 and c1
    (f32) read once plus the kept matches written once."""
    n_bytes = 2 * tokens * cfg["d_model_c"] * 4 + matches * MATCH_BYTES
    return flops.lower_bound(n_bytes, similarity(cfg, tokens))[0]


def tile_geometry(traffic: dict) -> tuple:
    """(number of tiles, tile height, tile width, coarse tokens a tile)."""
    lim = tile_limits(traffic["height"], traffic["width"], traffic["grid"],
                      traffic["overlap"])
    th, tw = int(lim[0, 3]), int(lim[0, 2])
    return len(lim), th, tw, (-(-th // 8)) * (-(-tw // 8))


def kept_matches(run) -> np.ndarray:
    """Coarse matches kept in each real tile pair: the reference's mean
    over the checked pairs, or the configuration's cap where none was
    checked."""
    n = tile_geometry(run.traffic)[0]
    counts = getattr(run.loop, "counts", None)
    if not counts:
        return np.full(n, float(run.config["matcher"]["max_matches"]))
    return np.asarray(counts, np.float64).mean(0)


def pair_flops(run) -> float:
    """The algorithm's product FLOPs of one stereo pair's real tile
    pairs: the backbone over both tiles, the coarse transformer, the
    similarity and the fine stage (the bucket's padding not counted)."""
    cfg = run.config["matcher"]
    n, th, tw, tokens = tile_geometry(run.traffic)
    h, w = -(-th // 8) * 8, -(-tw // 8) * 8
    per = 2 * backbone(cfg, h, w) + coarse(cfg, tokens) \
        + similarity(cfg, tokens)
    return n * per + sum(fine(cfg, m) for m in kept_matches(run))


def coarse_match_pair_bound_s(run) -> float:
    """The least time of one stereo pair's coarse matching over its real
    tile pairs."""
    cfg = run.config["matcher"]
    tokens = tile_geometry(run.traffic)[3]
    return sum(coarse_match_bound_s(cfg, tokens, m)
               for m in kept_matches(run))
