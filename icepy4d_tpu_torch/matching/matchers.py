"""Image matchers (counterpart of `ImageMatcherBase`, `LightGlueMatcher`,
`SuperGlueMatcher`, `NearestNeighborMatcher`, `SIFTMatcher`,
`SemiDenseMatcher` and `LoFTRMatcher` in
`icepy4d_tpu/matching/matchers.py`).

A tiled match runs the extractor (SuperPoint, DISK, ALIKED or SIFT, by
opt "extractor") once per image over a batch of tiles (in chunks that
fit an activation budget) and the matcher once over the batch of
selected tile pairs. Keypoint sets are fixed-size with validity masks;
matched rows are packed on the device and only they cross to the host,
where keypoints are deduplicated and verified. LoFTR is detector-free:
it runs on the tile pairs' pixels.

The last top-level match leaves its two images' device features in a
cache keyed by the identities of the image objects it was given and by
the tile signature; temporal tracking (`matching/tracking.py`) reads
them instead of extracting the same frames again.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import partial
from itertools import product
from pathlib import Path

import numpy as np
import torch

from icepy4d_tpu_torch.device import full_f32_matmul, resolve_device
from icepy4d_tpu_torch.matching.enums import (
    GeometricVerification,
    Quality,
    QUALITY_NAMES,
    QUALITY_SCALE,
    TileSelection,
)
from icepy4d_tpu_torch.matching.geometric_verification import \
    geometric_verification
from icepy4d_tpu_torch.matching.templatematch import forient, oc_track
from icepy4d_tpu_torch.matching.tiling import Tiler
from icepy4d_tpu_torch.models.aliked import ALIKED
from icepy4d_tpu_torch.models.convert import (aliked_params,
                                              bundled_checkpoint, disk_params,
                                              lightglue_params,
                                              load_params, load_torch_disk,
                                              load_torch_lightglue,
                                              load_torch_loftr,
                                              load_torch_superglue,
                                              load_torch_superpoint,
                                              loftr_params, superglue_params,
                                              superpoint_state_dict)
from icepy4d_tpu_torch.models.disk import DISK, disk_tree
from icepy4d_tpu_torch.models.lightglue import LightGlue, lightglue_tree
from icepy4d_tpu_torch.models.loftr import LoFTR, loftr_tree
from icepy4d_tpu_torch.models.sift import SIFT
from icepy4d_tpu_torch.models.superglue import SuperGlue, superglue_tree
from icepy4d_tpu_torch.models.superpoint import SuperPoint
from icepy4d_tpu_torch.ops.image import (extract_tiles, quality_resize,
                                         rgb_to_gray)
from icepy4d_tpu_torch.ops.topk import safe_top_k, top2_last
from icepy4d_tpu_torch.utils.timer import AverageTimer

logger = logging.getLogger("icepy4d_tpu_torch")

MIN_MATCHES_PER_TILE = 5
# similarity of a masked pair in the NN matchers: the lowest float32, as
# in the JAX package (the ratio and lone-candidate tests read it)
_NEG = torch.finfo(torch.float32).min


def _round_up_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _host_gray(im):
    """RGB uint8 -> grayscale on the host (a third of the upload bytes)."""
    if isinstance(im, np.ndarray) and im.ndim == 3 and im.dtype == np.uint8:
        import cv2

        return cv2.cvtColor(im, cv2.COLOR_RGB2GRAY)
    return im


def _host_image(im) -> np.ndarray:
    """A host array of an image given as an array or a tensor."""
    return im.cpu().numpy() if torch.is_tensor(im) else np.asarray(im)


def _to_device(im, device: torch.device) -> torch.Tensor:
    """A host image (grayscale on the host first) or a tensor already
    uploaded (the pipeline's prefetched frames) on `device`."""
    if torch.is_tensor(im):
        return im.to(device)
    return torch.from_numpy(np.ascontiguousarray(_host_gray(im))).to(device)


def _preprocess(image: torch.Tensor, quality: str) -> torch.Tensor:
    """uint8/float (H, W[, 3]) -> grayscale [0, 1] at the quality scale."""
    img = image.to(torch.float32)
    if image.dtype == torch.uint8:
        img = img / 255.0
    if img.ndim == 3:
        img = rgb_to_gray(img)
    return quality_resize(img, quality)


def _downsample(img: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        img = quality_resize(img, "medium")
    return img


def _even_chunks(n: int, c: int) -> list[int]:
    """Sizes of the ceil(n / c) chunks of n items, which differ by at most
    one: 25 at c = 8 is 7, 6, 6, 6."""
    f = -(-n // c)
    return [n // f + (i < n % f) for i in range(f)]


def _cat(outs: list[dict]) -> dict:
    return {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}


def _load_tree(opt: dict, params_key: str, weights_key: str, bundled: str,
               torch_loader=None):
    """Parameter tree (JAX layout) from opt, from an .npz path, from a
    published torch checkpoint through `torch_loader`, or from the
    repository's bundled checkpoint."""
    if params_key in opt:
        return opt[params_key]
    path = opt.get(weights_key) or bundled_checkpoint(bundled)
    if path is None:
        raise FileNotFoundError(
            f"no {weights_key} given and weights/{bundled} is missing")
    if str(path).endswith(".npz"):
        return load_params(path)
    if torch_loader is None:
        raise ValueError(f"{weights_key} must be an .npz checkpoint")
    return torch_loader(path)


@dataclass
class FeaturesBase:
    """A matcher's feature bundle: keypoints (N, 2) float32 [x, y],
    descriptors (D, N) (column-major, as the JAX package and its
    reference keep them) and scores (N,)."""

    keypoints: np.ndarray
    descriptors: np.ndarray = None
    scores: np.ndarray = None


class ImageMatcherBase:
    """Template-method matcher.

    match(image0, image1, quality, tile_selection, **config) resizes by
    quality, extracts and matches (full frame or tiled), rescales the
    keypoints to original pixels, verifies them geometrically, and
    exposes the results as mkpts0/1, descriptors0/1, scores0/1, mconf,
    F and inlier_mask.
    """

    def __init__(self, opt: dict | None = None, device=None) -> None:
        opt = dict(opt or {})
        self._opt = opt
        self.device = resolve_device(device)
        self._max_keypoints = int(opt.get("max_keypoints", -1))
        if self._max_keypoints <= 0:
            self._max_keypoints = 4096
        self._sp_cache: dict[tuple, object] = {}
        # device features of the last top-level match's two images, for
        # the seeded tracking of the same frames (tracking.py)
        self._feat_cache: dict | None = None
        self._cache_armed = False
        self.timer = AverageTimer(device=self.device)
        self._build_models(opt)
        self._load_extractor(opt)
        self._reset()

    # -- subclass hooks ------------------------------------------------------

    def _build_models(self, opt: dict) -> None:
        raise NotImplementedError

    def _run_matcher(self, data: dict) -> dict:
        raise NotImplementedError

    def _matcher_data_extra(self, feats: dict, idx, side: int) -> dict:
        """Extra per-side matcher inputs (SuperGlue takes the scores)."""
        return {}

    def _load_extractor(self, opt: dict) -> None:
        """The extractor's weights, by opt "extractor": SuperPoint and
        ALIKED from opt superpoint_params (a JAX-layout tree) or
        superpoint_weights (an .npz), else the bundled checkpoint; DISK
        from superpoint_params, an .npz or a kornia checkpoint at
        superpoint_weights, else random weights from opt "seed"; SIFT
        has none."""
        kind = self._extractor_kind()
        if kind == "superpoint":
            self._sp_state = superpoint_state_dict(_load_tree(
                opt, "superpoint_params", "superpoint_weights",
                "superpoint_synthetic.npz", load_torch_superpoint))
        elif kind == "aliked":
            self._sp_state = aliked_params(_load_tree(
                opt, "superpoint_params", "superpoint_weights",
                "aliked_synthetic.npz"))
        elif kind == "disk":
            path = opt.get("superpoint_weights")
            if "superpoint_params" in opt:
                self._sp_state = disk_params(opt["superpoint_params"])
            elif path is not None and str(path).endswith(".npz"):
                self._sp_state = disk_params(load_params(path))
            elif path is not None:
                self._sp_state = load_torch_disk(path)
            else:
                logger.warning("DISK: no checkpoint given - random weights")
                self._sp_state = disk_params(disk_tree(int(opt.get("seed",
                                                                    0))))
        elif kind != "sift":
            raise ValueError(f"unknown extractor {kind!r}")

    # -- public results ------------------------------------------------------

    def _reset(self) -> None:
        d = self.descriptor_dim
        self._mkpts0 = np.empty((0, 2), np.float32)
        self._mkpts1 = np.empty((0, 2), np.float32)
        self._descriptors0 = np.empty((d, 0), np.float32)
        self._descriptors1 = np.empty((d, 0), np.float32)
        self._scores0 = np.empty((0,), np.float32)
        self._scores1 = np.empty((0,), np.float32)
        self._mconf = np.empty((0,), np.float32)
        self._F = None
        self._inlier_mask = None

    @property
    def mkpts0(self) -> np.ndarray:
        return self._mkpts0

    @property
    def mkpts1(self) -> np.ndarray:
        return self._mkpts1

    @property
    def descriptors0(self) -> np.ndarray:
        return self._descriptors0

    @property
    def descriptors1(self) -> np.ndarray:
        return self._descriptors1

    @property
    def scores0(self) -> np.ndarray:
        return self._scores0

    @property
    def scores1(self) -> np.ndarray:
        return self._scores1

    @property
    def mconf(self) -> np.ndarray:
        return self._mconf

    @property
    def F(self):
        return self._F

    @property
    def inlier_mask(self):
        return self._inlier_mask

    def _extractor_kind(self) -> str:
        return str(self._opt.get("extractor", "superpoint")).lower()

    @property
    def descriptor_dim(self) -> int:
        return 128 if self._extractor_kind() in ("sift", "disk", "aliked") \
            else 256

    # -- building blocks -----------------------------------------------------

    def _superpoint(self, max_keypoints: int):
        """The local-feature extractor: SuperPoint, DISK or ALIKED (NMS
        radius max(nms_radius // 2, 2) for the last two), or the
        parameter-free SIFT, by opt "extractor"."""
        kind = self._extractor_kind()
        if kind == "sift":
            key = ("sift", max_keypoints,
                   float(self._opt.get("contrast_threshold", 0.015)),
                   float(self._opt.get("edge_threshold", 12.0)),
                   bool(self._opt.get("upsample", True)),
                   bool(self._opt.get("dual_orientation", True)))
            if key not in self._sp_cache:
                self._sp_cache[key] = SIFT(
                    max_keypoints=key[1], contrast_threshold=key[2],
                    edge_threshold=key[3], upsample=key[4],
                    dual_orientation=key[5], device=self.device)
            return self._sp_cache[key]
        key = (
            kind,
            max_keypoints,
            float(self._opt.get("keypoint_threshold", 0.0005)),
            int(self._opt.get("nms_radius", 4)),
            str(self._opt.get("activation_dtype", "float32")),
        )
        if key not in self._sp_cache:
            if kind == "disk":
                ext = DISK(max_keypoints=key[1], detection_threshold=key[2],
                           nms_radius=max(key[3] // 2, 2),
                           device=self.device)
            elif kind == "aliked":
                ext = ALIKED(max_keypoints=key[1], detection_threshold=key[2],
                             nms_radius=max(key[3] // 2, 2),
                             device=self.device)
            else:
                ext = SuperPoint(max_keypoints=key[1],
                                 detection_threshold=key[2],
                                 nms_radius=key[3],
                                 dtype=getattr(torch, key[4]),
                                 device=self.device)
            self._sp_cache[key] = ext.load_state_dict(self._sp_state)
        return self._sp_cache[key]

    @staticmethod
    def _auto_chunk(n: int, bytes_per_item: float,
                    budget: float = 2 << 30, cap: int = 32) -> int:
        """Largest divisor of n whose chunk fits the activation budget."""
        c = max(1, min(cap, n, int(budget // max(bytes_per_item, 1.0))))
        while n % c:
            c -= 1
        return c

    def _extract_chunk(self, t: int, h: int, w: int) -> int:
        # peak live trunk state per tile pixel: SuperPoint two full-res
        # 64-channel maps; DISK's full-res up block (the 80-channel input
        # through norm and gate, 129 out); ALIKED's four upsampled
        # aggregates, their concat and the normalised map
        kind = self._extractor_kind()
        if kind == "disk":
            per_px = 2048
        elif kind == "aliked":
            per_px = 1024
        else:
            per_px = 128 * (2 if str(self._opt.get(
                "activation_dtype", "float32")) == "bfloat16" else 4)
        return self._auto_chunk(t, h * w * per_px, budget=13 << 30)

    def _extract(self, tiles: torch.Tensor, max_keypoints: int) -> dict:
        """SuperPoint over a (T, h, w) tile batch, chunked over T."""
        sp = self._superpoint(max_keypoints)
        t, h, w = tiles.shape[:3]
        chunk = self._extract_chunk(t, h, w)
        return _cat([sp.extract(tiles[i:i + chunk])
                     for i in range(0, t, chunk)])

    def _store_feat_cache(self, sig: tuple, feats0: dict,
                          feats1: dict) -> None:
        """Publish the top-level match's device features of its two
        images for the seeded tracking of the same frames, keyed by the
        tile signature (n_tiles, th, tw, k) and the identities of the
        image objects `match` was given (the held references keep those
        identities from being reused). Armed only by the top-level
        match: the nested low-resolution match of PRESELECTION must not
        publish its features."""
        if not self._cache_armed:
            return
        self._cache_armed = False
        self._feat_cache = {"sig": sig, "ids": self._match_input_ids,
                            "refs": self._match_input_refs,
                            "feats": (feats0, feats1)}

    def _extract_tiled(self, g: torch.Tensor, origins: np.ndarray,
                       th: int, tw: int, max_keypoints: int) -> dict:
        """Features of every tile of an image; tiles are cut chunk by
        chunk so only one chunk of tiles is alive at a time."""
        sp = self._superpoint(max_keypoints)
        t = len(origins)
        chunk = self._extract_chunk(t, th, tw)
        return _cat([sp.extract(extract_tiles(g, origins[i:i + chunk], th, tw))
                     for i in range(0, t, chunk)])

    def _match_pair_batch(self, feats0: dict, feats1: dict, idx0: np.ndarray,
                          idx1: np.ndarray, pair_valid: np.ndarray,
                          size0: tuple[int, int],
                          size1: tuple[int, int]) -> dict:
        """Matcher forward over a padded batch of tile pairs, chunked so
        the (K+1)^2 assignment matrices fit a 6 GiB budget.

        idx0/idx1 (P,): tile index per pair; pair_valid (P,) masks the
        bucket padding; size* = (w, h) of one tile."""
        p = len(idx0)
        k = int(feats0["keypoints"].shape[1])
        chunk = self._auto_chunk(p, (k + 1) ** 2 * 4 * 4, budget=6 << 30)
        i0 = torch.as_tensor(idx0, dtype=torch.int64, device=self.device)
        i1 = torch.as_tensor(idx1, dtype=torch.int64, device=self.device)
        pv = torch.as_tensor(pair_valid, device=self.device)
        return _cat([
            self._gather_and_match_eager(feats0, feats1, i0[i:i + chunk],
                                         i1[i:i + chunk], pv[i:i + chunk],
                                         size0, size1)
            for i in range(0, p, chunk)])

    def _gather_and_match_eager(self, feats0, feats1, idx0, idx1,
                                pair_valid, size0, size1) -> dict:
        pv = pair_valid[:, None]
        p = idx0.shape[0]

        def size(s):
            return torch.tensor(s, dtype=torch.float32,
                                device=self.device).expand(p, 2)

        data = {
            "kpts0": feats0["keypoints"][idx0],
            "desc0": feats0["descriptors"][idx0],
            "mask0": feats0["mask"][idx0] & pv,
            "size0": size(size0),
            "kpts1": feats1["keypoints"][idx1],
            "desc1": feats1["descriptors"][idx1],
            "mask1": feats1["mask"][idx1] & pv,
            "size1": size(size1),
        }
        data.update(self._matcher_data_extra(feats0, idx0, 0))
        data.update(self._matcher_data_extra(feats1, idx1, 1))
        return self._run_matcher(data)

    @staticmethod
    def _compact_on_device(feats0: dict, feats1: dict, out: dict, idx0, idx1,
                           origins0, origins1, cap: int, n_out: int):
        """Keep the `cap` best matches of each pair and pack the valid rows
        of all pairs into (n_out, ...) on the device, in (pair, rank)
        order."""
        m0 = out["matches0"]                            # (P, K)
        score = torch.where(m0 > -1, out["mscores0"], -1.0)
        topv, topi = safe_top_k(score, cap)             # (P, C)
        sel = topv > -0.5
        j = torch.gather(m0.clamp_min(0).long(), 1, topi)

        def side(feats, idx, org, pick):
            mk = torch.gather(feats["keypoints"][idx], 1,
                              pick[..., None].expand(-1, -1, 2)) \
                + org[idx][:, None, :]
            d = feats["descriptors"][idx]
            d = torch.gather(d, 1, pick[..., None].expand(-1, -1, d.shape[-1]))
            s = torch.gather(feats["scores"][idx], 1, pick)
            return mk, d, s

        mk0, d0, s0 = side(feats0, idx0, origins0, topi)
        mk1, d1, s1 = side(feats1, idx1, origins1, j)
        # valid rows first; the stable sort keeps their (pair, rank) order
        order = torch.argsort((~sel).reshape(-1).to(torch.uint8),
                              stable=True)[:n_out]

        def pick(a):
            return a.reshape((-1,) + a.shape[2:])[order]

        # descriptors cross to the host as float16, as in the JAX package
        # (the next epoch's tracking seeds carry that rounding)
        return (pick(mk0), pick(mk1), pick(d0).half(), pick(d1).half(),
                pick(s0), pick(s1), pick(topv))

    def _assemble(self, feats0: dict, feats1: dict, out: dict,
                  idx0: np.ndarray, idx1: np.ndarray, origins0: np.ndarray,
                  origins1: np.ndarray):
        """Batched match result -> host arrays of the matched rows."""
        k = int(out["matches0"].shape[1])
        counts = (out["matches0"] > -1).sum(1).cpu().numpy()
        cap = min(k, int(self._opt.get("max_matches_per_pair", 4096)),
                  max(int(counts.max(initial=0)), 1))
        total = int(np.minimum(counts, cap).sum())
        dev = self.device
        arrs = self._compact_on_device(
            feats0, feats1, out,
            torch.as_tensor(idx0, dtype=torch.int64, device=dev),
            torch.as_tensor(idx1, dtype=torch.int64, device=dev),
            torch.as_tensor(origins0, dtype=torch.float32, device=dev),
            torch.as_tensor(origins1, dtype=torch.float32, device=dev),
            cap, total)
        return tuple(a.cpu().numpy() for a in arrs)

    @staticmethod
    def _dedup(mk0, mk1, d0, d1, s0, s1, conf):
        """Unique features on image0."""
        mk0, uniq = np.unique(mk0, axis=0, return_index=True)
        return (mk0, mk1[uniq], d0[uniq], d1[uniq], s0[uniq], s1[uniq],
                conf[uniq])

    # -- tile selection --------------------------------------------------------

    def _select_tile_pairs(self, img0, img1, tiler0: Tiler, tiler1: Tiler,
                           method: TileSelection,
                           min_matches_per_tile: int) -> list[tuple[int, int]]:
        t0 = list(tiler0.limits.keys())
        t1 = list(tiler1.limits.keys())
        if method is TileSelection.EXHAUSTIVE:
            return sorted(product(t0, t1))
        if method is TileSelection.GRID:
            return sorted(zip(t0, t1))
        if method is not TileSelection.PRESELECTION:
            raise ValueError(f"unsupported tile selection {method}")

        # PRESELECTION: match downsampled full frames, keep the tile pairs
        # that hold enough of the coarse matches
        h = int(img0.shape[0])
        n_down = 4 if h > 8000 else 3 if h > 4000 else 2 if h > 2000 else 1
        armed, self._cache_armed = self._cache_armed, False
        mk0, mk1, *_ = self._match_full(_downsample(img0, n_down),
                                        _downsample(img1, n_down),
                                        max_keypoints=4096)
        self._cache_armed = armed
        scale = float(2 ** n_down)
        mk0 = mk0 * scale
        mk1 = mk1 * scale

        def inside(mk, lim):
            return ((mk[:, 0] > lim[0]) & (mk[:, 0] < lim[2])
                    & (mk[:, 1] > lim[1]) & (mk[:, 1] < lim[3]))

        pairs = [(i, j) for i, j in sorted(product(t0, t1))
                 if int((inside(mk0, tiler0.limits[i])
                         & inside(mk1, tiler1.limits[j])).sum())
                 > min_matches_per_tile]
        logger.info("Preselection kept %d tile pairs", len(pairs))
        return pairs

    # -- matching paths --------------------------------------------------------

    def _match_full(self, img0, img1, max_keypoints: int | None = None):
        """One full-frame pair -> host arrays of the matched rows.

        No pre-padding: SuperPoint pads internally and masks its own pad
        band as border."""
        k = max_keypoints or self._max_keypoints
        with self.timer.span("match.extraction", "extraction"):
            if img0.shape == img1.shape:
                feats = self._extract(torch.stack([img0, img1]), k)
                feats0 = {n: a[:1] for n, a in feats.items()}
                feats1 = {n: a[1:] for n, a in feats.items()}
            else:
                feats0 = self._extract(img0[None], k)
                feats1 = self._extract(img1[None], k)
            self._store_feat_cache(
                (1, int(img0.shape[0]), int(img0.shape[1]), k), feats0, feats1)
            self._full_feats = (feats0, feats1)
        self._begin_matching()
        size0 = (int(img0.shape[1]), int(img0.shape[0]))
        size1 = (int(img1.shape[1]), int(img1.shape[0]))
        idx = np.zeros(1, np.int64)
        with self.timer.span("match.model", "model"):
            out = self._match_pair_batch(feats0, feats1, idx, idx,
                                         np.ones(1, bool), size0, size1)
        zero = np.zeros((1, 2), np.float32)
        with self.timer.span("match.assemble", "assemble"):
            return self._assemble(feats0, feats1, out, idx, idx, zero, zero)

    def _begin_matching(self) -> None:
        """Open the `matching` span where the call's own extraction ends
        (PRESELECTION's coarse match runs inside `preselection` and
        opens none); `match` closes it once the results are host
        arrays."""
        if self.timer.current == "match":
            self.timer.begin("match.matching", "matching")

    def _empty_result(self):
        z2 = np.empty((0, 2), np.float32)
        zd = np.empty((0, self.descriptor_dim), np.float32)
        z = np.empty((0,), np.float32)
        return z2, z2, zd, zd, z, z, z

    def _prepare_tile_pairs(self, img0, img1, tile_selection: TileSelection,
                            grid, overlap: int, origin,
                            min_matches_per_tile: int):
        """Tilers and the selected tile pairs: (tiler0, tiler1, idx0,
        idx1), the tile indices of each pair, or None when no pair is
        selected."""
        with self.timer.span("match.preselection", "preselection"):
            tiler0 = Tiler(grid=grid, overlap=overlap, origin=origin)
            tiler1 = Tiler(grid=grid, overlap=overlap, origin=origin)
            tiler0.compute_limits_by_grid(np.empty(img0.shape[:2]))
            tiler1.compute_limits_by_grid(np.empty(img1.shape[:2]))
            pairs = self._select_tile_pairs(img0, img1, tiler0, tiler1,
                                            tile_selection,
                                            min_matches_per_tile)
        if not pairs:
            logger.warning("No tile pairs selected: no matches")
            return None
        return (tiler0, tiler1, np.array([a for a, _ in pairs], np.int64),
                np.array([b for _, b in pairs], np.int64))

    def _match_tiled(self, img0, img1, tile_selection: TileSelection, grid,
                     overlap: int, origin, min_matches_per_tile: int):
        prep = self._prepare_tile_pairs(img0, img1, tile_selection, grid,
                                        overlap, origin, min_matches_per_tile)
        if prep is None:
            self._begin_matching()
            return self._empty_result()
        tiler0, tiler1, idx0, idx1 = prep
        # the pair batch is padded to a power of two (as the JAX package
        # pads it); `_auto_chunk` splits it into divisors
        p = len(idx0)
        pad = np.zeros(_round_up_pow2(p) - p, np.int64)
        idx0 = np.concatenate([idx0, pad])
        idx1 = np.concatenate([idx1, pad])
        pair_valid = np.arange(len(idx0)) < p
        th, tw = tiler0.tile_size
        with self.timer.span("match.extraction", "extraction"):
            feats0 = self._extract_tiled(img0, tiler0.tile_origins(), th, tw,
                                         self._max_keypoints)
            feats1 = self._extract_tiled(img1, tiler1.tile_origins(), th, tw,
                                         self._max_keypoints)
            self._store_feat_cache(
                (tiler0.n_tiles, th, tw, self._max_keypoints), feats0, feats1)
        self._begin_matching()
        with self.timer.span("match.model", "model"):
            out = self._match_pair_batch(feats0, feats1, idx0, idx1,
                                         pair_valid, (tw, th), (tw, th))
        with self.timer.span("match.assemble", "assemble"):
            res = self._assemble(feats0, feats1, out, idx0, idx1,
                                 tiler0.tile_origins().astype(np.float32),
                                 tiler1.tile_origins().astype(np.float32))
        with self.timer.span("match.dedup", "dedup"):
            return self._dedup(*res)

    # -- template method --------------------------------------------------------

    def match(self, image0: np.ndarray, image1: np.ndarray,
              quality: Quality = Quality.HIGH,
              tile_selection: TileSelection = TileSelection.NONE,
              **config) -> bool:
        """Match two images; results land in the mkpts0/1... properties.

        quality resize -> (full | tiled) matching -> rescale keypoints ->
        geometric verification -> inlier filtering. With `save_dir`,
        the matched keypoints are written there as text, and with
        `do_viz_matches` too the match mosaic as matches.png.

        `self.timer` records the call's spans, each a profiler range and
        a `timer.times` key: `match` (the call; no key); `match.upload`
        / upload (both frames to the device and preprocessed);
        `match.preselection` / preselection (tilers and tile-pair
        selection, PRESELECTION's coarse match inside);
        `match.extraction` / extraction (tiling, the extractor, NMS,
        top-K, the feature cache); `match.matching` / matching (from the
        end of extraction until the results are host arrays) with its
        children `match.model` / model (`_match_pair_batch`),
        `match.assemble` / assemble (`_assemble`) and `match.dedup` /
        dedup (`_dedup`); `match.verification` / geometric_verification.
        No stage synchronises the device: on a card the seconds come
        from CUDA events when `timer.times` is read."""
        with self.timer.call("match"):
            self._match(image0, image1, quality, tile_selection, config)
        self.timer.print("Matching")
        return True

    def _match(self, image0, image1, quality: Quality,
               tile_selection: TileSelection, config: dict) -> None:
        self._reset()
        gv_method = config.get("geometric_verification",
                               GeometricVerification.PYDEGENSAC)
        qname = QUALITY_NAMES[quality]
        self._cache_armed = True
        self._match_input_ids = (id(image0), id(image1))
        self._match_input_refs = (image0, image1)

        with torch.inference_mode():
            with self.timer.span("match.upload", "upload"):
                g0 = _preprocess(_to_device(image0, self.device), qname)
                g1 = _preprocess(_to_device(image1, self.device), qname)
            if tile_selection is TileSelection.NONE:
                res = self._match_full(g0, g1)
            else:
                res = self._match_tiled(
                    g0, g1, tile_selection,
                    grid=config.get("grid", [1, 1]),
                    overlap=int(config.get("overlap", 0)),
                    origin=config.get("origin", [0, 0]),
                    min_matches_per_tile=int(config.get(
                        "min_matches_per_tile", MIN_MATCHES_PER_TILE)))
        mk0, mk1, d0, d1, s0, s1, conf = res

        # back to original-resolution pixel coordinates
        scale = QUALITY_SCALE[quality]
        self._mkpts0 = np.asarray(mk0 / scale, np.float32)
        self._mkpts1 = np.asarray(mk1 / scale, np.float32)
        self._descriptors0 = np.asarray(d0, np.float32).T
        self._descriptors1 = np.asarray(d1, np.float32).T
        self._scores0 = np.asarray(s0, np.float32)
        self._scores1 = np.asarray(s1, np.float32)
        self._mconf = np.asarray(conf, np.float32)
        logger.info("Found %d putative matches", len(self._mconf))
        self.timer.end("match.matching")

        if gv_method is not GeometricVerification.NONE:
            with self.timer.span("match.verification",
                                 "geometric_verification"):
                F, mask = geometric_verification(
                    self._mkpts0, self._mkpts1, method=gv_method,
                    threshold=config.get("threshold", 1.0),
                    confidence=config.get("confidence", 0.9999),
                    scores=self._mconf, device=self.device)
                self._F = F
                self._inlier_mask = mask
                self._filter_matches_by_mask(mask)

        save_dir = config.get("save_dir", None)
        if bool(config.get("do_viz_matches", False)) and save_dir is not None:
            from icepy4d_tpu_torch.visualization import plot_matches_cv2

            plot_matches_cv2(_host_image(image0), _host_image(image1),
                             self._mkpts0, self._mkpts1,
                             path=str(Path(save_dir) / "matches.png"))
        if save_dir is not None:
            self.save_mkpts_as_txt(save_dir)

    def save_mkpts_as_txt(self, savedir, delimiter: str = ",",
                          header: str = "x,y") -> None:
        """Write the matched keypoints to keypoints_0.txt and
        keypoints_1.txt under `savedir` (two decimals, a header line)."""
        path = Path(savedir)
        path.mkdir(parents=True, exist_ok=True)
        for name, arr in (("keypoints_0.txt", self._mkpts0),
                          ("keypoints_1.txt", self._mkpts1)):
            np.savetxt(path / name, arr, fmt="%.2f", delimiter=delimiter,
                       newline="\n", header=header)

    def _filter_matches_by_mask(self, mask: np.ndarray) -> None:
        """Keep inliers only."""
        self._mkpts0 = self._mkpts0[mask]
        self._mkpts1 = self._mkpts1[mask]
        self._descriptors0 = self._descriptors0[:, mask]
        self._descriptors1 = self._descriptors1[:, mask]
        self._scores0 = self._scores0[mask]
        self._scores1 = self._scores1[mask]
        self._mconf = self._mconf[mask]


class LightGlueMatcher(ImageMatcherBase):
    """SuperPoint + LightGlue.

    opt keys: max_keypoints (default 4096), filter_threshold (0.1),
    n_layers (9), activation_dtype (LightGlue trunk, "bfloat16"),
    adaptive (False: `LightGlue.match_adaptive`, early exit and point
    pruning, f32 trunk, tuned by depth_confidence (0.95) and
    width_confidence (0.99); `adaptive_runs` then holds (layers run,
    capacity) of each pair chunk of the last match),
    superpoint_weights / lightglue_weights (.npz paths, or published
    torch checkpoints such as superpoint_v1.pth and
    superpoint_lightglue.pth) or superpoint_params / matcher_params
    (parameter trees in the JAX layout). With no weights given, the repository's bundled
    checkpoints (weights/*.npz) are loaded; LightGlue over the 128-d
    DISK or ALIKED descriptors then takes random weights from opt
    "seed" (the bundled one takes SuperPoint's).
    """

    def _build_models(self, opt: dict) -> None:
        self._adaptive = bool(opt.get("adaptive", False))
        self._depth_confidence = float(opt.get("depth_confidence", 0.95))
        self._width_confidence = float(opt.get("width_confidence", 0.99))
        self.matcher = LightGlue(
            n_layers=int(opt.get("n_layers", 9)),
            filter_threshold=float(opt.get("filter_threshold", 0.1)),
            input_dim=self.descriptor_dim,
            activation_dtype=str(opt.get("activation_dtype", "bfloat16")),
            device=self.device,
        )
        if self.descriptor_dim != 256 and "matcher_params" not in opt \
                and "lightglue_weights" not in opt:
            # the bundled LightGlue takes SuperPoint's 256-d descriptors
            logger.warning("LightGlueMatcher: no checkpoint given for %d-d "
                           "descriptors - random weights",
                           self.descriptor_dim)
            tree = lightglue_tree(self.matcher.n_layers, self.descriptor_dim,
                                  seed=int(opt.get("seed", 0)))
        else:
            tree = _load_tree(opt, "matcher_params", "lightglue_weights",
                              "lightglue_synthetic.npz",
                              partial(load_torch_lightglue,
                                      n_layers=self.matcher.n_layers))
        self.matcher.load_state_dict(lightglue_params(tree))

    def _reset(self) -> None:
        super()._reset()
        self.adaptive_runs: list[tuple[int, int]] = []

    def _run_matcher(self, data: dict) -> dict:
        if self._adaptive:
            out = self.matcher.match_adaptive(
                data, depth_confidence=self._depth_confidence,
                width_confidence=self._width_confidence)
            self.adaptive_runs.append((out["layers_run"], out["capacity"]))
            return {k: out[k] for k in ("matches0", "matches1", "mscores0",
                                        "mscores1")}
        return self.matcher.match(data)


class NearestNeighborMatcher(ImageMatcherBase):
    """SuperPoint + mutual nearest-neighbour cosine matching.

    opt keys: max_keypoints, ratio_threshold (Lowe ratio on the
    similarities, default off) and distance_threshold (least cosine
    similarity, default 0.7).
    """

    def _build_models(self, opt: dict) -> None:
        self._sim_th = float(opt.get("distance_threshold", 0.7))
        self._ratio_th = opt.get("ratio_threshold", None)

    @staticmethod
    def _similarity(d0: torch.Tensor, d1: torch.Tensor, mask0, mask1):
        """(B, M, N) cosine similarities in full f32, masked pairs at
        _NEG."""
        with full_f32_matmul():
            sim = torch.bmm(d0.float(), d1.float().transpose(1, 2))
        return sim.masked_fill_(~(mask0[:, :, None] & mask1[:, None, :]),
                                _NEG)

    @staticmethod
    def _mutual(sim: torch.Tensor, m0: torch.Tensor) -> torch.Tensor:
        """Whether row i's best column has row i as its best row."""
        m1 = sim.argmax(dim=1)                          # (B, N)
        rows = torch.arange(sim.shape[1], device=sim.device)[None]
        return rows == torch.gather(m1, 1, m0)

    def _nn(self, d0, d1, mask0, mask1):
        sim = self._similarity(d0, d1, mask0, mask1)
        best, second, m0 = top2_last(sim)
        ok = self._mutual(sim, m0) & (best > self._sim_th) & mask0
        if self._ratio_th is not None:
            ok &= second < float(self._ratio_th) * best
        return (torch.where(ok, m0, -1).to(torch.int32),
                torch.where(ok, best, 0.0))

    def _run_matcher(self, data: dict) -> dict:
        matches0, scores0 = self._nn(data["desc0"], data["desc1"],
                                     data["mask0"], data["mask1"])
        return {"matches0": matches0, "mscores0": scores0}


class SIFTMatcher(NearestNeighborMatcher):
    """SIFT + Lowe-ratio nearest-neighbour matching, with epipolar-guided
    rematching.

    opt keys: max_keypoints (16384), ratio_threshold (0.95, Lowe's
    distance ratio), mutual (False), contrast_threshold (0.015),
    edge_threshold (12), upsample (True), dual_orientation (True),
    guided_rounds (2), guided_band_px (3.0), guided_ratio (0.9),
    guided_min_sim (0.7).

    `match(..., F_prior=F)` guides the rematch with a surveyed
    fundamental matrix (the pipeline's GCP prior): the stage-1
    verification is skipped, and one guided round runs. Without a prior
    up to `guided_rounds` rounds run, each guided by the last verified
    F, until the match and inlier counts stop moving.
    """

    def _build_models(self, opt: dict) -> None:
        self._opt.setdefault("extractor", "sift")
        if int(opt.get("max_keypoints", -1)) <= 0:
            self._max_keypoints = 16384
        # a permissive ratio gives many putatives by design; the
        # verification prunes them, so they are not capped at 4096
        self._opt.setdefault("max_matches_per_pair", self._max_keypoints)
        self._ratio_th = float(opt.get("ratio_threshold", 0.95))
        self._mutual_check = bool(opt.get("mutual", False))
        self._guided_rounds = int(opt.get("guided_rounds", 2))
        self._guided_band = float(opt.get("guided_band_px", 3.0))
        self._guided_ratio = float(opt.get("guided_ratio", 0.9))
        self._guided_min_sim = float(opt.get("guided_min_sim", 0.7))

    def _nn(self, d0, d1, mask0, mask1):
        sim = self._similarity(d0, d1, mask0, mask1)
        s1, s2, m0 = top2_last(sim)
        # Lowe ratio on distances of unit descriptors, d^2 = 2 - 2 s
        r2 = self._ratio_th ** 2
        ok = (1.0 - s1) < r2 * (1.0 - s2)
        ok &= mask0 & (s1 > _NEG / 2)
        if self._mutual_check:
            ok &= self._mutual(sim, m0)
        return (torch.where(ok, m0, -1).to(torch.int32),
                torch.where(ok, s1, 0.0))

    def _nn_epipolar(self, d0, d1, k0, k1, mask0, mask1, F, band: float):
        """Lowe-ratio NN restricted to the epipolar band of F (k0, k1 in
        F's pixel frame): candidates farther than `band` px from the
        epipolar line, in either image, are masked before the ratio
        test; a lone in-band candidate passes it; then mutual, and the
        similarity floor."""
        F = torch.as_tensor(F, dtype=torch.float32, device=k0.device)
        h0 = torch.cat([k0, torch.ones_like(k0[..., :1])], -1)
        h1 = torch.cat([k1, torch.ones_like(k1[..., :1])], -1)
        with full_f32_matmul():
            l1 = h0 @ F.T                               # lines in image 1
            l0 = h1 @ F                                 # lines in image 0
            num = torch.bmm(l1, h1.transpose(1, 2)).abs_()   # (B, M, N)
        n1 = torch.linalg.vector_norm(l1[..., :2], dim=-1).clamp_min(1e-9)
        n0 = torch.linalg.vector_norm(l0[..., :2], dim=-1).clamp_min(1e-9)
        inband = (num / n1[:, :, None]) < band
        inband &= (num.div_(n0[:, None, :])) < band
        del num
        sim = self._similarity(d0, d1, mask0, mask1)
        sim.masked_fill_(~inband, _NEG)
        del inband
        s1, s2, m0 = top2_last(sim)
        r2 = self._guided_ratio ** 2
        ok = (1.0 - s1) < r2 * (1.0 - s2)
        ok |= s2 <= _NEG / 2
        ok &= self._mutual(sim, m0)
        ok &= mask0 & (s1 > self._guided_min_sim)
        return (torch.where(ok, m0, -1).to(torch.int32),
                torch.where(ok, s1, 0.0))

    def _guided_rematch(self, threshold: float, confidence: float,
                        gv_method, scale: float, guide) -> None:
        """NN again over the cached full-image features, inside the
        epipolar band of `guide` (in original pixels), then a fresh
        verification; overwrites the match results."""
        feats0, feats1 = self._full_feats
        F = np.asarray(guide, np.float32)
        if scale != 1.0:
            # the cached keypoints are at the quality scale
            S = np.diag(np.asarray([1.0 / scale, 1.0 / scale, 1.0],
                                   np.float32))
            F = S.T @ F @ S
        with torch.inference_mode():
            m0, conf = self._nn_epipolar(
                feats0["descriptors"], feats1["descriptors"],
                feats0["keypoints"], feats1["keypoints"],
                feats0["mask"], feats1["mask"], F,
                float(np.float32(self._guided_band * scale)))
            m0 = m0[0].cpu().numpy()
            conf = conf[0].cpu().numpy()
            sel = m0 > -1
            j = m0[sel]
            host = {n: a[0].cpu().numpy() for n, a in feats0.items()}
            host1 = {n: a[0].cpu().numpy() for n, a in feats1.items()}
        self._mkpts0 = (host["keypoints"][sel] / scale).astype(np.float32)
        self._mkpts1 = (host1["keypoints"][j] / scale).astype(np.float32)
        self._descriptors0 = host["descriptors"][sel].T.astype(np.float32)
        self._descriptors1 = host1["descriptors"][j].T.astype(np.float32)
        self._scores0 = host["scores"][sel].astype(np.float32)
        self._scores1 = host1["scores"][j].astype(np.float32)
        self._mconf = conf[sel].astype(np.float32)
        logger.info("guided rematch: %d putative matches in the epipolar "
                    "band", len(self._mconf))
        F2, mask = geometric_verification(
            self._mkpts0, self._mkpts1, method=gv_method,
            threshold=threshold, confidence=confidence, scores=self._mconf,
            device=self.device)
        if F2 is not None:
            self._F = F2
        self._inlier_mask = mask
        self._filter_matches_by_mask(mask)

    def _match(self, image0, image1, quality: Quality,
               tile_selection: TileSelection, config: dict) -> None:
        """The base match, then (full frame, with verification) the
        guided rematch, in the span `match.guided_rematch` /
        guided_rematch."""
        F_prior = config.pop("F_prior", None)
        gv_method = config.get("geometric_verification",
                               GeometricVerification.PYDEGENSAC)
        guided = (self._guided_rounds > 0
                  and tile_selection is TileSelection.NONE
                  and gv_method is not GeometricVerification.NONE)
        self._full_feats = None
        if F_prior is not None and guided:
            # the surveyed prior is the F the stage-1 verification would
            # only estimate: skip it
            config = dict(config,
                          geometric_verification=GeometricVerification.NONE)
        super()._match(image0, image1, quality, tile_selection, config)
        guide = F_prior if F_prior is not None else self._F
        if not (guided and guide is not None
                and self._full_feats is not None):
            return
        scale = QUALITY_SCALE[quality]
        with self.timer.span("match.guided_rematch", "guided_rematch"):
            prev = None
            for _ in range(self._guided_rounds):
                self._guided_rematch(float(config.get("threshold", 1.0)),
                                     float(config.get("confidence", 0.9999)),
                                     gv_method, scale, guide)
                cur = (len(self._mkpts0),
                       int(self._inlier_mask.sum())
                       if self._inlier_mask is not None else 0)
                # a pinned prior gives the same band every round
                if cur == prev or F_prior is not None:
                    break
                prev = cur
                if self._F is not None:
                    guide = self._F


def _dense_grid(net, tiles: torch.Tensor, pool: int) -> dict:
    """Grid tokens from SuperPoint's dense descriptor map: keypoints at
    the centres of (8 * pool)-px cells, L2-normalised pooled
    descriptors."""
    b, h, w = tiles.shape[:3]
    x = torch.nn.functional.pad(tiles.float(), (0, (-w) % 8, 0, (-h) % 8))
    _, dense = net(x[:, None])                       # (B, D, H/8, W/8)
    if pool > 1:
        dense = torch.nn.functional.avg_pool2d(dense, pool)
    d = dense / dense.norm(dim=1, keepdim=True).clamp_min(1e-12)
    gh, gw = d.shape[2:]
    stride = 8 * pool
    ys, xs = torch.meshgrid(torch.arange(gh, device=d.device),
                            torch.arange(gw, device=d.device), indexing="ij")
    kpts = torch.stack([xs * stride + stride / 2 - 0.5,
                        ys * stride + stride / 2 - 0.5], -1).float()
    valid = (kpts[..., 0] < w) & (kpts[..., 1] < h)
    k = gh * gw
    return {"keypoints": kpts.reshape(1, k, 2).expand(b, k, 2),
            "descriptors": d.flatten(2).transpose(1, 2),
            "scores": torch.ones((b, k), device=d.device),
            "mask": valid.reshape(1, k).expand(b, k)}


class SemiDenseMatcher(NearestNeighborMatcher):
    """Detector-free semi-dense matcher: every cell of SuperPoint's dense
    descriptor map, pooled over grid_pool x grid_pool cells (default 2,
    16-px cells), is a token, and tokens are matched by mutual-NN cosine
    (distance_threshold, default 0.8).

    opt "refine" (default True): each match of a full-frame match is
    moved to sub-pixel by OC template correlation (`templatematch`,
    refine_template 16, refine_search 32 px) seeded at the coarse
    displacement; a match whose correlation fails or has an SNR of 1.5
    or less keeps its coarse position.

    Tiled matches use the grid tokens too; the JAX package's tiled path
    extracts SuperPoint keypoints instead (ROADMAP section 3).
    """

    def _build_models(self, opt: dict) -> None:
        super()._build_models(opt)
        self._grid_pool = int(opt.get("grid_pool", 2))
        self._sim_th = float(opt.get("distance_threshold", 0.8))
        self._refine = bool(opt.get("refine", True))
        self._refine_template = int(opt.get("refine_template", 16))
        self._refine_search = int(opt.get("refine_search", 32))
        self.refined_share = float("nan")

    def _refine_matches(self, img0: torch.Tensor, img1: torch.Tensor,
                        mk0: np.ndarray, mk1: np.ndarray) -> np.ndarray:
        """Sub-pixel refinement of coarse grid matches by orientation
        correlation; failures keep the coarse position."""
        res = oc_track(forient(img0), forient(img1), mk0,
                       template_width=self._refine_template,
                       search_width=self._refine_search,
                       initialdu=(mk1[:, 0] - mk0[:, 0]).astype(np.float64),
                       initialdv=(mk1[:, 1] - mk0[:, 1]).astype(np.float64))
        ok = np.isfinite(res.du) & (res.snr > 1.5)
        refined = mk1.copy()
        # pu / pv are the rounded centres the correlator used
        refined[ok, 0] = (res.pu + res.du)[ok] + (mk0[ok, 0] - res.pu[ok])
        refined[ok, 1] = (res.pv + res.dv)[ok] + (mk0[ok, 1] - res.pv[ok])
        self.refined_share = float(ok.mean())
        logger.info("semi-dense refinement: %d / %d matches refined",
                    int(ok.sum()), len(ok))
        return refined.astype(np.float32)

    def _match_full(self, img0, img1, max_keypoints=None):
        res = super()._match_full(img0, img1, max_keypoints)
        if self._refine and len(res[0]):
            mk0, mk1, *rest = res
            res = (mk0, self._refine_matches(img0, img1, mk0, mk1), *rest)
        return res

    def _extract(self, tiles: torch.Tensor, max_keypoints: int) -> dict:
        net = self._superpoint(max_keypoints).net
        t, h, w = tiles.shape[:3]
        chunk = self._auto_chunk(t, h * w * 64 * 4)
        return _cat([_dense_grid(net, tiles[i:i + chunk], self._grid_pool)
                     for i in range(0, t, chunk)])

    def _extract_tiled(self, g: torch.Tensor, origins: np.ndarray,
                       th: int, tw: int, max_keypoints: int) -> dict:
        t = len(origins)
        chunk = self._auto_chunk(t, th * tw * 64 * 4)
        return _cat([self._extract(extract_tiles(g, origins[i:i + chunk],
                                                 th, tw), max_keypoints)
                     for i in range(0, t, chunk)])


_DETECTOR_FREE = ("LoFTRMatcher is detector-free: temporal tracking seeds "
                  "(track_features) need a detector-based matcher "
                  "(LightGlue/SuperGlue/NN/SemiDense). Configure "
                  "matching.matcher accordingly when proc.do_tracking is on.")


class LoFTRMatcher(ImageMatcherBase):
    """LoFTR (`models/loftr.py`, the published architecture) inside the
    standard match(): quality, tiling and geometric verification.
    Detector-free: no extractor is built; keypoints come from the coarse
    grid with the fine stage's sub-pixel refinement, descriptors are the
    128-d fine centre features.

    opt keys: loftr_weights (a kornia-layout or official checkpoint;
    "matcher." prefixes are stripped) or matcher_params (a JAX-layout
    tree), confidence_threshold (0.2), max_matches per pair (1024),
    temp_bug_fix (False: the published checkpoints), precision
    ("highest": no TF32). Without weights, random ones from opt "seed".

    The forward is the matcher model: it runs inside `match.matching`
    as its child `match.model` (key `model`), beside `match.assemble`
    and (tiled) `match.dedup`; no `extraction` span is opened. The
    model records its four stages under `match.model` on the matcher's
    timer (`match.loftr.backbone`, `.coarse`, `.coarse_match`, `.fine`;
    a key sums over a call's forwards). `counters` holds the last
    call's counts: `tile_pairs` (selected), `bucket` (the tile pairs the
    forwards ran: the selected ones, unpadded), `forwards` and
    `pairs_per_forward` (the largest of the chunks, whose sizes differ
    by at most one), `coarse_tokens` (a tile's, or the frame's),
    `matches_kept` (coarse matches kept over the real pairs) and
    `pairs_at_cap` (pairs whose kept matches reached `max_matches`).
    """

    def _build_models(self, opt: dict) -> None:
        self.matcher = LoFTR(
            thr=float(opt.get("confidence_threshold", 0.2)),
            max_matches=int(opt.get("max_matches", 1024)),
            temp_bug_fix=bool(opt.get("temp_bug_fix", False)),
            precision=str(opt.get("precision", "default")),
            device=self.device)
        self.matcher.timer = self.timer
        self.matcher.span_prefix = "match.loftr"
        if "matcher_params" in opt:
            state = loftr_params(opt["matcher_params"])
        elif "loftr_weights" in opt:
            state = load_torch_loftr(opt["loftr_weights"])
        else:
            logger.warning("LoFTRMatcher: no checkpoint given - random "
                           "weights")
            state = loftr_params(loftr_tree(int(opt.get("seed", 0))))
        self.matcher.load_state_dict(state)

    def _load_extractor(self, opt: dict) -> None:
        pass

    def _reset(self) -> None:
        super()._reset()
        self.counters: dict[str, int] = {}

    @property
    def descriptor_dim(self) -> int:
        return 128

    def _extract(self, tiles, max_keypoints):
        raise NotImplementedError(_DETECTOR_FREE)

    def _extract_tiled(self, *args, **kwargs):
        raise NotImplementedError(_DETECTOR_FREE)

    def _out_to_host(self, out: dict, origin0=None, origin1=None):
        valid = out["valid"].cpu().numpy()
        kept = valid.sum(1)
        self.counters.update(matches_kept=int(kept.sum()),
                             pairs_at_cap=int((kept >= valid.shape[1]).sum()))
        host = {k: out[k].cpu().numpy() for k in (
            "keypoints0", "keypoints1", "descriptors0", "descriptors1",
            "confidence")}
        mk0 = host["keypoints0"][valid]
        mk1 = host["keypoints1"][valid]
        if origin0 is not None:
            pair_id = np.broadcast_to(np.arange(valid.shape[0])[:, None],
                                      valid.shape)[valid]
            mk0 = mk0 + origin0[pair_id]
            mk1 = mk1 + origin1[pair_id]
        conf = host["confidence"][valid]
        return (mk0, mk1, host["descriptors0"][valid],
                host["descriptors1"][valid], conf, conf, conf)

    def _match_full(self, img0, img1, max_keypoints=None):
        self._begin_matching()
        h, w = (int(v) for v in img0.shape[:2])
        self.counters.update(tile_pairs=1, bucket=1, forwards=1,
                             pairs_per_forward=1,
                             coarse_tokens=(-(-h // 8)) * (-(-w // 8)))
        with self.timer.span("match.model", "model"):
            out = self.matcher.match_pair(img0, img1)
        with self.timer.span("match.assemble", "assemble"):
            return self._out_to_host(out)

    # bytes a tile pair's forward allocates on the card at its peak, a
    # tile pixel: both tiles' backbone activations, the coarse
    # transformer, the dual-softmax kernel's workspace and the fine
    # windows. `torch.cuda.max_memory_allocated` over forwards of 1, 2,
    # 4, 6, 8 and 9 tile pairs of 1600x1200 on an H100 80GB read
    # 2296.0-2296.5 bytes a tile pixel, with no fixed part
    # (`scripts/loftr_forward_memory.py`); rounded up to leave room for
    # another choice of cuDNN's convolution workspace.
    CARD_BYTES_PER_PIXEL = 2400

    def _pair_chunk(self, n: int, th: int, tw: int) -> int:
        """Most of n tile pairs of th x tw a forward takes at once,
        against half the device memory that is free or that the caching
        allocator holds unused (2 GiB on the CPU). `mem_get_info` alone
        would shrink the chunk once an earlier call has left its blocks
        in the allocator's cache. The CPU's dense dual softmax holds the
        L0 x L1 similarity and its two softmaxes (f32) and the pair mask
        besides; the card's kernel holds none."""
        if self.device.type == "cuda":
            per_pair = th * tw * self.CARD_BYTES_PER_PIXEL
            free = torch.cuda.mem_get_info(self.device)[0] \
                + torch.cuda.memory_reserved(self.device) \
                - torch.cuda.memory_allocated(self.device)
            budget = free // 2
        else:
            l_c = (th // 8) * (tw // 8)
            per_pair = l_c * l_c * (3 * 4 + 1) + th * tw * 600
            budget = 2 << 30
        return max(1, min(n, budget // per_pair))

    def _match_tiled(self, img0, img1, tile_selection: TileSelection, grid,
                     overlap: int, origin, min_matches_per_tile: int):
        prep = self._prepare_tile_pairs(img0, img1, tile_selection, grid,
                                        overlap, origin, min_matches_per_tile)
        self._begin_matching()
        if prep is None:
            return self._empty_result()
        tiler0, tiler1, idx0, idx1 = prep
        th, tw = tiler0.tile_size
        org0 = tiler0.tile_origins()
        org1 = tiler1.tile_origins()
        # even chunks: a last forward of one tile pair would under-fill
        # the linear attention's (B x heads)-batched products
        sizes = _even_chunks(len(idx0), self._pair_chunk(len(idx0), th, tw))
        self.counters.update(
            tile_pairs=len(idx0), bucket=sum(sizes), forwards=len(sizes),
            pairs_per_forward=max(sizes),
            coarse_tokens=(-(-th // 8)) * (-(-tw // 8)))
        outs = []
        with self.timer.span("match.model", "model"):
            i = 0
            for n in sizes:
                outs.append(self.matcher.match_batch(
                    extract_tiles(img0, org0[idx0[i:i + n]], th, tw),
                    extract_tiles(img1, org1[idx1[i:i + n]], th, tw),
                    np.ones(n, bool)))
                i += n
        with self.timer.span("match.assemble", "assemble"):
            res = self._out_to_host(_cat(outs),
                                    org0.astype(np.float32)[idx0],
                                    org1.astype(np.float32)[idx1])
        with self.timer.span("match.dedup", "dedup"):
            return self._dedup(*res)


# the name the reference gives the class
LOFTRMatcher = LoFTRMatcher


class SuperGlueMatcher(ImageMatcherBase):
    """SuperPoint + SuperGlue.

    Defaults as the reference's: keypoint_threshold 0.001, nms_radius 3,
    sinkhorn_iterations 20, match_threshold 0.3. opt keys besides:
    superglue_weights (an official checkpoint, or an .npz of the JAX
    tree) or matcher_params (a JAX-layout tree); without weights, random
    ones from opt "seed" (drawn as the JAX package draws them).
    """

    def __init__(self, opt: dict | None = None, device=None) -> None:
        opt = dict(opt or {})
        opt.setdefault("keypoint_threshold", 0.001)
        opt.setdefault("nms_radius", 3)
        super().__init__(opt, device=device)

    def _build_models(self, opt: dict) -> None:
        self.matcher = SuperGlue(
            sinkhorn_iterations=int(opt.get("sinkhorn_iterations", 20)),
            match_threshold=float(opt.get("match_threshold", 0.3)),
            device=self.device)
        path = opt.get("superglue_weights")
        if "matcher_params" in opt:
            state = superglue_params(opt["matcher_params"])
        elif path is not None and str(path).endswith(".npz"):
            state = superglue_params(load_params(path))
        elif path is not None:
            state = load_torch_superglue(path)
        else:
            logger.warning("SuperGlueMatcher: no checkpoint given - random "
                           "weights")
            state = superglue_params(superglue_tree(
                seed=int(opt.get("seed", 0))))
        self.matcher.load_state_dict(state)

    def _matcher_data_extra(self, feats: dict, idx, side: int) -> dict:
        return {f"scores{side}": feats["scores"][idx]}

    def _run_matcher(self, data: dict) -> dict:
        return self.matcher.match(data)
