"""Closed loop of detector-free stereo pair matches: one `match()` of the
configuration's LoFTR matcher after another.

Set-up draws the weights on the card from the seed, renders the
traffic's `pairs` distinct seeded pairs on the card and holds them as
host uint8 arrays, which the window cycles through, and matches the
first `warmup_pairs` of them. Each item is one `match()` on a pair at
the traffic's quality, tiling and verification; it returns with the
verified matches as host arrays.

A sample of the window's pairs, `check_pairs` of them drawn from the
seed by reservoir sampling, keeps what the program produced, read only
through public surfaces: what the matcher model (`matcher.matcher`)
returned from `match_batch` for each real tile pair (keypoints0/1,
confidence and valid). `check` judges them against the plain reference
(`reference/loftr_check.py`). The matcher's counters of each pair
(`LoFTRMatcher.counters`, where the program has them) are printed after
the window.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from h100_bench import scene, spec, weights
from h100_bench.reference.loftr_check import Reference, judge
from h100_bench.reference.tiles import tile_limits

COUNTERS = ("tile_pairs", "bucket", "forwards", "pairs_per_forward",
            "coarse_tokens", "matches_kept", "pairs_at_cap")


class Loop:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.setup_parts: dict = {}
        self.stats: list = []          # the matcher's stage seconds, a pair
        self.counters: list = []       # the matcher's counters, a pair
        self.samples: list = []        # records kept for the check
        self.counts: list = []         # reference matches a tile pair
        self._rng = np.random.default_rng([self.seed, 0x10F7])
        self._recording = None

    # -- set-up ---------------------------------------------------------

    def setup(self) -> None:
        t = time.perf_counter()
        from icepy4d_tpu_torch import matching

        self.setup_parts["import_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.matcher_tree, host_tree = weights.make(
            self.config["matcher"], self.seed, self.device)
        opt = dict(self.config["program"]["opt"], matcher_params=host_tree)
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
        """Keep, for a sampled pair, what `match_batch` returned for each
        tile pair: keypoints0/1, confidence and valid."""
        inner = model.match_batch

        def match_batch(*args, **kwargs):
            out = inner(*args, **kwargs)
            if self._recording is not None:
                self._recording.append({
                    "kpts0": out["keypoints0"], "kpts1": out["keypoints1"],
                    "conf": out["confidence"], "valid": out["valid"]})
            return out

        model.match_batch = match_batch

    # -- the window -------------------------------------------------------

    def step(self) -> None:
        n = len(self.stats)
        img0, img1 = self.pairs[n % len(self.pairs)]
        k = int(self.traffic["check_pairs"])
        slot = n if n < k else int(self._rng.integers(0, n + 1))
        keep = slot < k
        self._recording = [] if keep else None
        self.matcher.match(img0, img1, **self.call)
        self.stats.append(dict(self.matcher.timer.times))
        self.counters.append(dict(getattr(self.matcher, "counters", {})))
        if keep:
            # the real tile pairs lead the padded bucket
            rec = {key: torch.cat([c[key] for c in self._recording])
                   [:self.n_tiles] for key in self._recording[0]}
            rec["pair"] = n % len(self.pairs)
            if slot < len(self.samples):
                self.samples[slot] = rec
            else:
                self.samples.append(rec)
        self._recording = None

    def item_lines(self) -> list:
        if not any(self.counters):
            return []
        return ["counters a pair (" + ", ".join(COUNTERS) + "): "
                + " ".join(",".join(str(c.get(k, "-")) for k in COUNTERS)
                           for c in self.counters)]

    def release(self) -> None:
        """Free the program's state; the samples stay."""
        del self.matcher
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness ------------------------------------------------------

    def reference_trees(self) -> dict:
        return {"matcher": self.matcher_tree}

    def check(self) -> dict:
        """{number: (worst over the sampled pairs, limit)} of every number
        the configuration limits; the others are printed."""
        ref = Reference(self.config, self.traffic, self.matcher_tree,
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
