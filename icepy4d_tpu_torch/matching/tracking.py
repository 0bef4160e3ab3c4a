"""Temporal feature tracking (counterpart of
`icepy4d_tpu/matching/tracking.py`).

The previous epoch's keypoints and descriptors are the matcher's side-0
token set, and the new image's features side 1, so matches carry track
ids forward in time. A feature survives only if every camera finds it
again.

Seeds are bucketed per tile on the host; then the seeds of every tile
of every camera ride one batched matcher forward over the tile-diagonal
pairs (`ImageMatcherBase._match_pair_batch`), so a tracked stereo epoch
runs one seeded forward. The new images' features come from the
matcher's feature cache when the pair match has just extracted the same
image objects at the same tile signature; otherwise they are extracted
with the pair match's entry points. Only the matched rows cross to the
host, their descriptors as float16, as in the JAX package (the next
epoch seeds with the rounded values).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from icepy4d_tpu_torch.core.features import Features
from icepy4d_tpu_torch.matching.enums import QUALITY_SCALE, Quality
from icepy4d_tpu_torch.matching.tiling import Tiler

logger = logging.getLogger("icepy4d_tpu_torch")


class _FrameTile:
    """The whole frame as the one tile of a full-frame match, which
    extracts the frame itself, not the grid's tile."""

    n_tiles = 1

    def __init__(self, shape):
        h, w = int(shape[0]), int(shape[1])
        self.tile_size = (h, w)
        self.limits = {0: (0, 0, w, h)}

    @staticmethod
    def tile_origins() -> np.ndarray:
        return np.zeros((1, 2), np.int32)


def _seed_tiler(img_shape, grid, overlap):
    """The pair match's tiles of a frame of `img_shape`.

    A 1 x 1 grid is the whole frame at the origin. (The JAX package
    uses the grid's tile there, whose 10-px step rounding makes it
    smaller than the frame unless both sides are multiples of 10 and
    puts it at (w - tw, h - th): its seeds are then shifted by that
    offset against the full-frame features they are matched with, and
    its tracked positions come out shifted by it, (2, 8) px on a
    6012x4008 frame.)"""
    if int(np.prod(grid)) == 1:
        return _FrameTile(img_shape)
    tiler = Tiler(grid=list(grid), overlap=int(overlap))
    tiler.compute_limits_by_grid(np.empty(img_shape[:2]))
    return tiler


def _bucket_seeds(prev_kpts: np.ndarray, tiler: Tiler, k: int):
    """Assign each seed to its most interior containing tile and pack
    per-tile slot arrays. Returns (seed_idx (T,K) int, seed_valid (T,K)
    bool)."""
    t = tiler.n_tiles
    lim = np.array([tiler.limits[i] for i in range(t)], np.float32)
    x = prev_kpts[None, :, 0]
    y = prev_kpts[None, :, 1]
    margin = np.minimum.reduce([
        x - lim[:, 0:1], y - lim[:, 1:2],
        lim[:, 2:3] - x, lim[:, 3:4] - y])          # (T, N)
    tile_of = np.argmax(margin, axis=0)             # (N,)
    seed_idx = np.zeros((t, k), np.int64)
    seed_valid = np.zeros((t, k), bool)
    for ti in range(t):
        rows = np.flatnonzero(tile_of == ti)
        if len(rows) > k:
            logger.warning(
                "tile %d: %d seeds exceed matcher capacity %d — %d "
                "tracks dropped (raise max_keypoints or tracking grid)",
                ti, len(rows), k, len(rows) - k)
            rows = rows[:k]
        seed_idx[ti, : len(rows)] = rows
        seed_valid[ti, : len(rows)] = True
    return seed_idx, seed_valid


def _preproc_shape(shape, qname: str) -> tuple[int, int]:
    """The shape `matchers._preprocess` gives a frame of `shape`."""
    h, w = int(shape[0]), int(shape[1])
    if qname == "highest":
        return 2 * h, 2 * w
    if qname == "high":
        return h, w
    if qname == "medium":
        return (h + 1) // 2, (w + 1) // 2
    return ((h + 1) // 2 + 1) // 2, ((w + 1) // 2 + 1) // 2  # low


def _extract_new(matcher, origs: list, tiler, k: int, qname: str) -> list:
    """Tile features (leading dim n_tiles) of each new image.

    Cache path: the matcher's last top-level match extracted these very
    image objects at this tile signature (n_tiles, th, tw, k); its
    device features are reused. (The JAX package's single tile is the
    grid's, smaller than the frame unless both sides are multiples of
    10, so its cache misses on such frames; see `_seed_tiler`.)
    Otherwise: `_extract_tiled` per image on a tiled grid, or one
    stacked `_extract` over both images of one shape on the whole frame
    (the pair match's own calls), else one `_extract` per image.
    """
    from icepy4d_tpu_torch.matching.matchers import _preprocess, _to_device

    t = tiler.n_tiles
    th, tw = tiler.tile_size
    cache = matcher._feat_cache
    if (cache is not None and len(origs) == 2
            and cache["sig"] == (t, th, tw, k)
            and cache["ids"] == tuple(id(o) for o in origs)):
        return list(cache["feats"])

    imgs = [_preprocess(_to_device(o, matcher.device), qname) for o in origs]
    if t > 1:
        return [matcher._extract_tiled(g, tiler.tile_origins(), th, tw, k)
                for g in imgs]
    if len(imgs) == 2 and imgs[0].shape == imgs[1].shape:
        feats = matcher._extract(torch.stack(imgs), k)
        return [{n: a[i:i + 1] for n, a in feats.items()} for i in range(2)]
    return [matcher._extract(g[None], k) for g in imgs]


def _track_batch(matcher, seeds: list, new_feats: list, tiler,
                 scale: float) -> list:
    """Seeded matching of each camera's already-scaled seeds
    (kpts, descr, scores) against that camera's new tile features, all
    cameras in one matcher forward over the tile-diagonal pairs.

    Returns per camera (new_kpts (N, 2) full-res px, found (N,),
    new_descr (N, D), new_scores (N,))."""
    k = int(matcher._max_keypoints)
    t = tiler.n_tiles
    th, tw = tiler.tile_size
    origins = tiler.tile_origins().astype(np.float32)
    dev = matcher.device
    buckets, seed_kpts, seed_descr, seed_scores = [], [], [], []
    for kpts, descr, scores in seeds:
        idx, valid = _bucket_seeds(kpts, tiler, k)
        buckets.append((idx, valid))
        seed_kpts.append(kpts[idx] - origins[:, None, :])   # tile-local
        seed_descr.append(descr[idx])
        seed_scores.append(np.where(valid, scores[idx], 0.0))
    seed_feats = {
        "keypoints": torch.as_tensor(np.concatenate(seed_kpts),
                                     dtype=torch.float32, device=dev),
        "descriptors": torch.as_tensor(np.concatenate(seed_descr),
                                       dtype=torch.float32, device=dev),
        "scores": torch.as_tensor(np.concatenate(seed_scores),
                                  dtype=torch.float32, device=dev),
        "mask": torch.as_tensor(np.concatenate([v for _, v in buckets]),
                                device=dev),
    }
    feats = {n: torch.cat([f[n] for f in new_feats]) for n in new_feats[0]}
    n_pairs = t * len(seeds)
    pair = np.arange(n_pairs)
    out = matcher._match_pair_batch(seed_feats, feats, pair, pair,
                                    np.ones(n_pairs, bool), (tw, th),
                                    (tw, th))
    m0_all = out["matches0"].cpu().numpy()

    results = []
    for c, ((seed_idx, seed_valid), (kpts, descr, _)) in enumerate(
            zip(buckets, seeds)):
        n, d = descr.shape
        m0 = m0_all[c * t:(c + 1) * t]
        tis, sls = np.nonzero(seed_valid & (m0 > -1))
        rows = seed_idx[tis, sls]
        new_kpts = np.zeros((n, 2), np.float32)
        new_descr = np.zeros((n, d), np.float32)
        new_scores = np.zeros((n,), np.float32)
        found = np.zeros((n,), bool)
        if len(rows):
            ti = torch.as_tensor(tis + c * t, device=dev)
            ji = torch.as_tensor(m0[tis, sls].astype(np.int64), device=dev)
            kg = feats["keypoints"][ti, ji].cpu().numpy()
            dg = feats["descriptors"][ti, ji].half().cpu().numpy()
            sg = feats["scores"][ti, ji].cpu().numpy()
            new_kpts[rows] = (kg + origins[tis]) / scale
            new_descr[rows] = dg.astype(np.float32)
            new_scores[rows] = sg
            found[rows] = True
        results.append((new_kpts, found, new_descr, new_scores))
    return results


def _scale_and_name(quality) -> tuple[float, str]:
    if isinstance(quality, str):
        return QUALITY_SCALE[Quality[quality.upper()]], quality.lower()
    return QUALITY_SCALE[quality], "high"


def _gray_shape(image) -> tuple:
    from icepy4d_tpu_torch.matching.matchers import _host_gray

    return tuple(_host_gray(image).shape)


def track_features(matcher, prev_kpts: np.ndarray, prev_descr: np.ndarray,
                   prev_scores: np.ndarray, new_image, grid=(1, 1),
                   quality: str = "high", overlap: int = 0):
    """Find each previous-epoch feature in `new_image`.

    prev_kpts (N, 2) full-res px; prev_descr (N, D); prev_scores (N,).
    Returns (new_kpts (N, 2) full-res, found (N,) bool, new_descr (N, D),
    new_scores (N,)): new_kpts[i] is where feature i went.

    `quality` must be the setting the seeds were extracted with; `grid`
    and `overlap` those of the pair match, so that the cache can hit.
    """
    scale, qname = _scale_and_name(quality)
    tiler = _seed_tiler(_preproc_shape(_gray_shape(new_image), qname),
                        grid, overlap)
    k = int(matcher._max_keypoints)
    with torch.inference_mode():
        new_feats = _extract_new(matcher, [new_image], tiler, k, qname)
        out = _track_batch(
            matcher,
            [(np.asarray(prev_kpts, np.float32) * scale,
              np.asarray(prev_descr, np.float32),
              np.asarray(prev_scores, np.float32).reshape(-1))],
            new_feats, tiler, scale)[0]
    logger.info("Tracked %d / %d features into new image",
                int(out[1].sum()), len(prev_kpts))
    return out


def track_matches(matcher, prev_features: dict[str, Features],
                  new_images: dict, grid=(1, 1), quality: str = "high",
                  overlap: int = 0) -> dict[str, Features]:
    """Carry the previous epoch's tracked features into a new epoch.

    Tracking runs on the ids that every camera holds (multicam epochs:
    a camera may hold only some); a feature is kept only if every
    camera finds it again. Returns per-camera Features of the new epoch
    with the old track ids.
    """
    cams = list(prev_features.keys())
    common = None
    for cam in cams:
        ids = prev_features[cam].track_ids_to_numpy()
        common = ids if common is None else np.intersect1d(common, ids)
    track_ids = np.sort(np.asarray(common))
    if len(track_ids) == 0:
        logger.warning("track_matches: no track ids shared by all %d "
                       "cameras", len(cams))
        return {cam: Features(descr_dim=prev_features[cam].descr_dim)
                for cam in cams}

    scale, qname = _scale_and_name(quality)
    origs = [new_images[cam] for cam in cams]
    tiler = _seed_tiler(_preproc_shape(_gray_shape(origs[0]), qname),
                        grid, overlap)
    k = int(matcher._max_keypoints)
    seeds, ids_per_cam = [], []
    for cam in cams:
        f = prev_features[cam]
        ids = f.track_ids_to_numpy()
        # this camera's rows in the order of the sorted common ids
        order = np.argsort(ids)
        pos = order[np.searchsorted(ids[order], track_ids)]
        seeds.append((f.kpts_to_numpy()[pos] * scale, f.descr_to_numpy()[pos],
                      f.scores_to_numpy()[pos]))
        ids_per_cam.append(ids[pos])
    with torch.inference_mode():
        all_feats = _extract_new(matcher, origs, tiler, k, qname)
        res = _track_batch(matcher, seeds, all_feats, tiler, scale)

    found_all = np.logical_and.reduce([r[1] for r in res])
    out: dict[str, Features] = {}
    for cam, (nk, _, nd, ns), ids in zip(cams, res, ids_per_cam):
        feats = Features(descr_dim=nd.shape[1])
        feats.append_features_from_numpy(
            nk[found_all], descr=nd[found_all], scores=ns[found_all],
            track_ids=ids[found_all])
        out[cam] = feats
    logger.info("track_matches: %d features survive in all %d cameras",
                int(found_all.sum()), len(cams))
    return out
