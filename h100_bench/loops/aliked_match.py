"""Closed loop of stereo pair matches through published ALIKED-n16 and
LightGlue: the `pair_match` loop with the extractor's weights drawn from
the seed and its own check.

Set-up draws ALIKED-n16's weights (`extractor`, the published state-dict
layout) and LightGlue's (`matcher`) on the card from the seed and hands
them to the program as `superpoint_params` and `matcher_params`; the rest
is `pair_match.Loop`'s: the traffic's pairs rendered from the seed, one
`match()` an item, a sample of `check_pairs` pairs kept through public
surfaces. The matcher's counters of each pair (`counters`: deformable
convolutions run, valid keypoints a tile, SDDH offsets at the clamp,
patches `get_patches` clamped; where the program has them) are kept as
the program left them and printed after the window. `check` judges the
sample against the plain reference with `reference/aliked_check.py`.
"""

from __future__ import annotations

import sys
import time

import torch

from h100_bench import spec, weights
from h100_bench.reference.aliked_check import Reference, judge

COUNTERS = ("dcn", "keypoints", "offsets_clamped", "patches_clamped")


class Loop(spec.module("loops", "pair_match").Loop):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        self.counters: list = []       # the matcher's counters, a pair

    def setup(self) -> None:
        t = time.perf_counter()
        self.extractor_tree, host = weights.make(self.config["extractor"],
                                                 self.seed, self.device)
        program = self.config["program"]
        self.config = dict(self.config, program=dict(
            program, opt=dict(program["opt"], superpoint_params=host)))
        self.setup_parts["extractor_weights_s"] = time.perf_counter() - t
        super().setup()

    def step(self) -> None:
        super().step()
        counters = getattr(self.matcher, "counters", {})
        self.counters.append({k: list(v) if isinstance(v, list) else v
                              for k, v in counters.items()})

    def item_lines(self) -> list:
        lines = super().item_lines()
        if not any(self.counters):
            return lines

        def show(c, k):
            v = c.get(k)
            if v is None:
                return "-"
            if isinstance(v, list):      # valid keypoints of each tile
                n = torch.cat([t.reshape(-1) for t in v]).tolist()
                return f"{min(n)}-{max(n)}"
            return str(int(v))

        return lines + ["counters a pair (" + ", ".join(COUNTERS) + "): "
                        + " ".join(",".join(show(c, k) for k in COUNTERS)
                                   for c in self.counters)]

    def reference_trees(self) -> dict:
        return {"extractor": self.extractor_tree,
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
