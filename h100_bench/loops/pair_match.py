"""Closed loop of stereo pair matches: one `match()` after another.

Set-up renders the traffic's `pairs` distinct seeded pairs on the card
and holds them as host uint8 arrays, which the window cycles through.
Each item is one call of the configuration's matcher class on a pair, at
the traffic's quality, tiling and verification; it returns with the
verified matches as host arrays.

A sample of the window's pairs, `check_pairs` of them drawn from the seed
by reservoir sampling, keeps what the matcher produced, read only through
public surfaces: what the matcher model (`matcher.matcher`) was given for
each tile pair (keypoints, descriptors and masks of every tile), the
column its returned log assignment chose for each row and the row for
each column, and the verified matches `match()` returned. `check` judges
them against the plain reference (`reference/check.py`).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from h100_bench import scene, spec, weights
from h100_bench.reference.check import (Reference, choices, judge,
                                        tile_features)
from h100_bench.reference.tiles import exhaustive_pairs, tile_limits


class Loop:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.setup_parts: dict = {}
        self.stats: list = []          # the matcher's stage seconds, a pair
        self.launches: list = []       # (NMS, attention) launches, a pair
        self.samples: list = []        # records kept for the check
        self.counts: list = []         # reference keypoints a tile, checked
        self._rng = np.random.default_rng([self.seed, 0xC4EC])
        self._recording = None

    # -- set-up ---------------------------------------------------------

    def setup(self) -> None:
        t = time.perf_counter()
        from icepy4d_tpu_torch import matching
        from icepy4d_tpu_torch.ops import _build, attention, nms

        self._kernels = (nms.KERNEL, attention.KERNEL)
        self.setup_parts["import_s"] = time.perf_counter() - t
        t = time.perf_counter()
        if self.device.type == "cuda":
            _build.build_all([k.source for k in self._kernels])
        self.setup_parts["build_s"] = time.perf_counter() - t

        t = time.perf_counter()
        opt = {k: str(spec.ROOT / v) if k.endswith("_weights") else v
               for k, v in self.config["program"]["opt"].items()}
        self.matcher_tree, host_tree = weights.make(
            self.config["matcher"], self.seed, self.device)
        if host_tree is not None:
            opt["matcher_params"] = host_tree
        self.matcher = getattr(matching, self.config["program"]["class"])(
            opt, device=self.device)
        self._record_model(self.matcher.matcher)
        self.setup_parts["weights_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.pairs = scene.render_pairs(self.traffic, self.seed, self.device)
        self.setup_parts["inputs_s"] = time.perf_counter() - t

        tr = self.traffic
        self.n_tiles = len(tile_limits(tr["height"], tr["width"], tr["grid"],
                                       tr["overlap"]))
        self.call = dict(
            quality=matching.Quality[tr["quality"].upper()],
            tile_selection=matching.TileSelection[tr["tile_selection"].upper()],
            grid=list(tr["grid"]), overlap=int(tr["overlap"]),
            geometric_verification=matching.GeometricVerification[
                tr["geometric_verification"].upper()],
            threshold=float(tr["threshold"]))
        t = time.perf_counter()
        for img0, img1 in self.pairs[:int(tr.get("warmup_pairs", 1))]:
            self.matcher.match(img0, img1, **self.call)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_parts["warmup_s"] = time.perf_counter() - t

    def _record_model(self, model) -> None:
        """Keep, for a sampled pair, the model's public input and output:
        each tile pair's keypoints, descriptors and masks, and what
        `choices` takes of the log assignment it returns."""
        inner = model.match

        def match(data, *args, **kwargs):
            out = inner(data, *args, **kwargs)
            if self._recording is not None:
                self._recording.append({
                    **{k + s: data[k + s] for k in ("kpts", "desc", "mask")
                       for s in "01"},
                    **choices(out["log_assignment"])})
            return out

        model.match = match

    # -- the window -------------------------------------------------------

    def step(self) -> None:
        n = len(self.stats)
        img0, img1 = self.pairs[n % len(self.pairs)]
        k = int(self.traffic["check_pairs"])
        slot = n if n < k else int(self._rng.integers(0, n + 1))
        keep = slot < k
        self._recording = [] if keep else None
        before = [kern.launches for kern in self._kernels]
        self.matcher.match(img0, img1, **self.call)
        self.launches.append(tuple(kern.launches - b for kern, b
                                   in zip(self._kernels, before)))
        self.stats.append(dict(self.matcher.timer.times))
        if keep:
            m = self.matcher
            given = {k: torch.cat([c[k] for c in self._recording])
                     for k in self._recording[0]}
            rec = {k: given[k] for k in ("rowarg", "colarg")}
            rec.update(pair=n % len(self.pairs),
                       feats=tile_features(exhaustive_pairs(self.n_tiles),
                                           self.n_tiles, given),
                       mk0=m.mkpts0.copy(), mk1=m.mkpts1.copy())
            if slot < len(self.samples):
                self.samples[slot] = rec
            else:
                self.samples.append(rec)
        self._recording = None

    def item_lines(self) -> list:
        return ["launches a pair (nms, attention): "
                + " ".join(f"{a},{b}" for a, b in self.launches)]

    def release(self) -> None:
        """Free the program's state; the samples stay."""
        del self.matcher
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness ------------------------------------------------------

    def reference_trees(self) -> dict:
        ext = self.config["extractor"]
        return {"extractor": weights.make(ext, self.seed, self.device)[0],
                "matcher": self.matcher_tree}

    def check(self) -> dict:
        """{number: (worst over the sampled pairs, limit)} of every number
        the configuration limits; the others are printed."""
        ref = Reference(self.config, self.traffic, self.reference_trees(),
                        self.device)
        worst: dict = {}
        for rec in sorted(self.samples, key=lambda r: r["pair"]):
            img0, img1 = self.pairs[rec["pair"]]
            nums = judge(ref, img0, img1, [rec])[0]
            self.counts.append(nums.pop("counts"))
            print(f"checked pair {rec['pair']}: {nums}", file=sys.stderr)
            for k, v in nums.items():
                worst[k] = max(worst.get(k, v), v)
        limits = self.config["limits"]
        if not self.samples:
            return {k: (float("inf"), lim) for k, lim in limits.items()}
        return {k: (worst[k], lim) for k, lim in limits.items()}
