"""Arithmetic shared by the metric readers of `metrics/`."""

from __future__ import annotations

import importlib

import numpy as np

from h100_bench import flops
from h100_bench.reference.tiles import exhaustive_pairs, tile_limits


def stage_mean(run, stage: str):
    """Mean seconds of a matcher stage over the window's pairs outside
    the traced part (all of them where the whole window was traced);
    None where the loop keeps no such stage."""
    stats = getattr(run.loop, "stats", None)
    if not stats:
        return None
    rest = stats[run.traced_items:] or stats
    vals = [s[stage] for s in rest if stage in s]
    return float(np.mean(vals)) if vals else None


def tiles(run) -> np.ndarray:
    t = run.traffic
    return tile_limits(t["height"], t["width"], t["grid"], t["overlap"])


def keypoint_counts(run) -> tuple:
    """Valid keypoints of each tile of each frame: the reference's mean
    over the checked pairs, or the configuration's K where none was."""
    counts = getattr(run.loop, "counts", None)
    n_tiles = len(tiles(run))
    if not counts:
        k = run.config["extractor"]["max_keypoints"]
        return [k] * n_tiles, [k] * n_tiles
    arr = np.asarray(counts, np.float64)           # (pairs, 2, tiles)
    mean = arr.mean(0)
    return list(mean[0]), list(mean[1])


def matcher_module(run):
    return importlib.import_module(
        f"h100_bench.reference.{run.config['matcher']['arch']}")


def extractor_module(run):
    return importlib.import_module(
        f"h100_bench.reference.{run.config['extractor']['arch']}")


def pair_flops(run) -> float:
    """The algorithm's product FLOPs of one stereo pair: the extractor
    over every tile of both frames, the matcher over every tile pair."""
    lim = tiles(run)
    th, tw = int(lim[0, 3]), int(lim[0, 2])
    ext = extractor_module(run).flops(run.config["extractor"],
                                      -(-th // 8) * 8, -(-tw // 8) * 8)
    n0, n1 = keypoint_counts(run)
    mat = matcher_module(run)
    return 2 * len(lim) * ext + sum(
        mat.flops(run.config["matcher"], n0[a], n1[b])
        for a, b in exhaustive_pairs(len(lim)))


def attention_bound_s(run) -> float:
    """The least time of one pair's attention calls: each call's larger
    of operations over the bf16 peak and bytes over the memory rate."""
    cfg = run.config["matcher"]
    hd = cfg["descriptor_dim"] // cfg["num_heads"]
    out_bytes = 2 if cfg["precision"].get("trunk") == "bf16" else 4
    n0, n1 = keypoint_counts(run)
    total = 0.0
    for a, b in exhaustive_pairs(len(n0)):
        for nq, nk in matcher_module(run).attention_calls(cfg, n0[a], n1[b]):
            total += flops.lower_bound(
                flops.attention_bytes(1, cfg["num_heads"], nq, nk, hd,
                                      out_bytes=out_bytes),
                flops.attention(1, cfg["num_heads"], nq, nk, hd))[0]
    return total


def nms_bound_s(run) -> float:
    """The least time of one pair's NMS: every tile's score map (padded
    to the 8-px grid) read once and written once."""
    lim = tiles(run)
    th, tw = -(-int(lim[0, 3]) // 8) * 8, -(-int(lim[0, 2]) // 8) * 8
    return flops.lower_bound(flops.nms_bytes(2 * len(lim), th, tw), 0.0)[0]


def roofline(run, kernel: str, bound_per_item_s: float):
    """% of the roofline: the bound of the traced items over the
    kernel's device time in the trace; None where it did not run."""
    if run.trace is None or not run.traced_items:
        return None
    t = run.trace.kernel_time(kernel)
    if t <= 0:
        return None
    return 100.0 * bound_per_item_s * run.traced_items / t
