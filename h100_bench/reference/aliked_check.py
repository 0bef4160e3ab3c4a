"""The comparison that decides `correct` in the ALIKED-n16 pairs cell.

As `check.py` judges the SuperPoint cells, with one change: ALIKED's
keypoints are sub-pixel (DKD's soft-argmax at temperature 0.1), so a
program keypoint and a reference keypoint are the same keypoint when
they are each other's nearest in their tile and lie within `PAIR_PX` of
each other, never by the pixel they round to (rounding would flip on
the soft-argmax's last bits). For a sampled pair the reference extracts
every tile of both frames with `reference/aliked.py` and scores every
EXHAUSTIVE tile pair with `reference/lightglue.py`, in float32 (TF32
off), from the same uint8 frames and weights the program was given (and
scores the record's own tile pairs, for `row_flip`):

  kpt_miss     keypoints of either set with no partner in the other (per
               tile), over the reference's: tiling, the dense map, NMS,
               top-K and the soft-argmax
  kpt_px       the largest distance between partners (px)
  desc_err     the largest L2 distance between partners' descriptors,
               of the partners whose SDDH patch is the same pixel in both
               (`get_patches` truncates the keypoint to its pixel: where
               the two keypoints straddle a pixel edge by their last
               bits, the patches, offsets and descriptors differ by a
               step of the published function, not by an error)
  row_flip     rows (and columns) of the tile pairs' assignments whose
               chosen partner differs from the reference LightGlue's over
               the record's own inputs (LightGlue alone: the extractor is
               judged by the numbers above), over the rows the reference
               holds above the match threshold (those that can yield a
               match; random weights leave most other rows near ties)
  match_diff   verified matches of either set with no match of the other
               within `PAIR_PX` at both ends, over the reference's (the
               reference's: its mutual matches above the threshold that
               the scene's true fundamental matrix keeps)

The configuration limits the numbers that separate the program from its
control; the others are printed.
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench.reference import aliked, check
from h100_bench.reference.precision import full_f32, lowered

PAIR_PX = 0.5     # partners lie closer; NMS keeps peaks > 2 px apart
# distances from differences, never from |a|^2 + |b|^2 - 2ab, which
# loses the sub-pixel part at full-frame coordinates
EXACT = "donot_use_mm_for_euclid_dist"


class Reference(check.Reference):
    """`check.Reference` with ALIKED-n16 as its extractor; the features
    of the last two frames are kept (the judge reads them twice)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._memo: list = []

    @torch.inference_mode()
    def features(self, image: np.ndarray) -> dict:
        for key, feats in self._memo:
            if key is image:
                return feats
        img = torch.from_numpy(image).to(self.device).float() / 255.0
        out = []
        with full_f32():
            for x0, y0, tw, th in self.limits:
                tile = img[y0:y0 + th, x0:x0 + tw][None]
                out.append(aliked.extract(
                    self.trees["extractor"], tile, self.ext["max_keypoints"],
                    self.precisions["extractor"]))
        feats = {k: torch.cat([o[k] for o in out]) for k in out[0]}
        self._memo = (self._memo + [(image, feats)])[-2:]
        return feats


def partners(rec: dict, ref: dict) -> tuple:
    """(T, K) reference slot of each record slot (-1: none), and the
    distances of the partners."""
    maps, gaps = [], []
    for t in range(ref["keypoints"].shape[0]):
        d = torch.cdist(rec["keypoints"][t].float(), ref["keypoints"][t],
                        compute_mode=EXACT)
        d = d.masked_fill(~rec["mask"][t][:, None], float("inf"))
        d = d.masked_fill(~ref["mask"][t][None, :], float("inf"))
        best, near = d.min(1)
        back = d.argmin(0)
        rows = torch.arange(len(near), device=d.device)
        ok = (back[near] == rows) & (best <= PAIR_PX)
        maps.append(torch.where(ok, near, -1))
        gaps.append(best[ok])
    return torch.stack(maps), torch.cat(gaps)


def _shared(got: np.ndarray, want: np.ndarray) -> int:
    """Matches (N, 4) of `got` with a match of `want` within PAIR_PX at
    both ends."""
    if not len(got) or not len(want):
        return 0
    g = torch.as_tensor(got, dtype=torch.float64)
    w = torch.as_tensor(want, dtype=torch.float64)
    d = torch.maximum(torch.cdist(g[:, :2], w[:, :2], compute_mode=EXACT),
                      torch.cdist(g[:, 2:], w[:, 2:], compute_mode=EXACT))
    return int((d.min(1).values <= PAIR_PX).sum())


def judge(ref: Reference, image0: np.ndarray, image1: np.ndarray,
          records: list) -> list:
    """The numbers of each record (see the module doc), one dict each."""
    feats = [ref.features(image0), ref.features(image1)]
    dev = ref.device
    th = float(ref.mat["match_threshold"])
    states = []
    for rec in records:
        miss = total = 0
        kpt_px = desc_err = 0.0
        for side in range(2):
            rf, pf = feats[side], rec["feats"][side]
            pf = {k: v.to(dev) for k, v in pf.items()}
            m, gap = partners(pf, rf)
            both = int((m >= 0).sum())
            miss += int(rf["mask"].sum()) + int(pf["mask"].sum()) - 2 * both
            total += int(rf["mask"].sum())
            if both:
                kpt_px = max(kpt_px, float(gap.max()))
                t_idx, k_idx = torch.nonzero(m >= 0, as_tuple=True)
                r_idx = m[t_idx, k_idx]
                same = (pf["keypoints"][t_idx, k_idx].floor()
                        == rf["keypoints"][t_idx, r_idx].floor()).all(-1)
                if same.any():
                    dp = pf["descriptors"][t_idx, k_idx][same].float()
                    dr = rf["descriptors"][t_idx, r_idx][same]
                    desc_err = max(desc_err,
                                   float((dp - dr).norm(dim=-1).max()))
        flips = rows = 0
        # LightGlue alone: the reference matcher over the record's own
        # inputs, against the record's choices, slot for slot
        own = [{**f, "scores": torch.zeros_like(f["mask"], dtype=torch.float32)}
               for f in ({k: v.to(dev) for k, v in f.items()}
                         for f in rec["feats"])]
        for idx, la in ref.blocks(*own):
            ch = check.choices(la)
            sure = {"row": ch["rowval"].exp() > th,
                    "col": la[:, :-1, :-1].amax(1).exp() > th}
            for side in ("row", "col"):
                got = rec[side + "arg"][idx].to(dev)
                flips += int((sure[side] & (got != ch[side + "arg"])).sum())
                rows += int(sure[side].sum())
            del la
        states.append({"kpt_miss": miss / max(total, 1), "kpt_px": kpt_px,
                       "desc_err": desc_err, "row_flip": flips / max(rows, 1)})

    ref_mk0, ref_mk1 = [], []
    for idx, la in ref.blocks(*feats):
        a, b = check._mutual(ref, feats, idx, check.choices(la))
        ref_mk0 += a
        ref_mk1 += b
        del la
    want = check._verified(ref, ref_mk0, ref_mk1)
    out = []
    for rec, st in zip(records, states):
        got = np.concatenate([rec["mk0"], rec["mk1"]], 1).astype(np.float32)
        shared = _shared(want, got)
        out.append({
            "kpt_miss": st["kpt_miss"], "kpt_px": st["kpt_px"],
            "desc_err": st["desc_err"],
            "row_flip": st["row_flip"],
            "match_diff": (len(got) + len(want) - 2 * shared)
            / max(len(want), 1),
            "verified": len(got), "reference_verified": len(want),
            "counts": [f["mask"].sum(1).tolist() for f in feats]})
    return out


def control(config: dict, traffic: dict, trees: dict, device) -> Reference:
    """The reference one precision step below the configuration's."""
    return Reference(config, traffic, trees, device, precisions={
        "extractor": lowered({"x": config["extractor"]["precision"]})["x"],
        "matcher": lowered(config["matcher"]["precision"])})


def stated(config: dict, traffic: dict, trees: dict, device) -> Reference:
    """The reference at the configuration's own precisions."""
    return Reference(config, traffic, trees, device, precisions={
        "extractor": config["extractor"]["precision"],
        "matcher": dict(config["matcher"]["precision"])})
