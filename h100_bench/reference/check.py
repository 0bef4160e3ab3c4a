"""The comparison that decides `correct` in the pairs cells.

For a pair the window matched, the reference extracts every tile of both
frames and scores every EXHAUSTIVE tile pair in float32 (TF32 off), from
the same uint8 frames and weights the program was given. A record of
what a matcher produced for that pair (what its matcher model was given
for each tile pair, the column the model's assignment chose for each row
and the row for each column, and the verified matches `match()`
returned) is then judged against the reference:

  kpt_miss     keypoints in the symmetric difference of the record's and
               the reference's valid sets (by pixel position, per tile),
               over the reference's: tiling, SuperPoint, NMS and top-K
  desc_err     largest L2 distance between the two descriptors of a
               keypoint both hold
  row_flip     rows (and columns) of the tile pairs' assignments whose
               chosen partner differs from the reference's, over those
               where the record holds the reference's choice: the
               served-token check of a language model, one row a token
  match_diff   the symmetric difference of the record's verified matches
               and the reference's, over the reference's: the
               reference's are its mutual matches above the threshold,
               one a keypoint of frame 0, that the pair's true
               fundamental matrix (the scene's known cameras, never the
               program's estimate) keeps within the traffic's threshold

The control (`control`, judged through `reference_record`) is the
reference in the program's place at lower precision; its verified
matches are its mutual matches above the threshold that the true
fundamental matrix keeps, a verification no program can better.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from h100_bench import scene
from h100_bench.reference import superpoint
from h100_bench.reference.precision import full_f32, lowered
from h100_bench.reference.tiles import exhaustive_pairs, tile_limits

PAIR_CHUNK = 4


class Reference:
    """A configuration's reference on `device`: float32 throughout, or
    the operand precisions `precisions` ({"extractor": ..., "matcher":
    {...}}) where given."""

    def __init__(self, config: dict, traffic: dict, trees: dict, device,
                 precisions: dict | None = None):
        self.ext = config["extractor"]
        self.mat = config["matcher"]
        self.traffic = traffic
        self.trees = trees
        self.device = torch.device(device)
        self.precisions = precisions or {
            "extractor": "f32",
            "matcher": {k: "f32" for k in self.mat["precision"]}}
        self.arch = importlib.import_module(
            f"h100_bench.reference.{self.mat['arch']}")
        t = traffic
        self.limits = tile_limits(t["height"], t["width"], t["grid"],
                                  t["overlap"])
        self.pairs = exhaustive_pairs(len(self.limits))
        self.F = scene.fundamental(traffic)

    @torch.inference_mode()
    def features(self, image: np.ndarray) -> dict:
        """Every tile of a uint8 frame -> (T, K, ...) features."""
        img = torch.from_numpy(image).to(self.device).float() / 255.0
        out = []
        with full_f32():
            for x0, y0, tw, th in self.limits:
                tile = img[y0:y0 + th, x0:x0 + tw][None]
                out.append(superpoint.extract(
                    self.trees["extractor"]["params"], tile,
                    self.ext["max_keypoints"], self.ext["keypoint_threshold"],
                    self.ext["nms_radius"], self.ext["remove_borders"],
                    self.precisions["extractor"]))
        return {k: torch.cat([o[k] for o in out]) for k in out[0]}

    @torch.inference_mode()
    def blocks(self, feats0: dict, feats1: dict):
        """Yield (pair indices, log assignment (P, K+1, K+1)) over the
        tile pairs, PAIR_CHUNK at a time."""
        tw, th = (int(v) for v in self.limits[0, 2:])
        kwargs = {k: self.mat[k] for k in self.mat.get("reference_args", [])}
        for c in range(0, len(self.pairs), PAIR_CHUNK):
            idx = list(range(c, min(c + PAIR_CHUNK, len(self.pairs))))
            i0 = torch.tensor([self.pairs[p][0] for p in idx],
                              device=self.device)
            i1 = torch.tensor([self.pairs[p][1] for p in idx],
                              device=self.device)
            size = torch.tensor([[tw, th]] * len(idx), dtype=torch.float32,
                                device=self.device)
            data = {"size0": size, "size1": size}
            for s, f, i in (("0", feats0, i0), ("1", feats1, i1)):
                data["kpts" + s] = f["keypoints"][i]
                data["desc" + s] = f["descriptors"][i]
                data["scores" + s] = f["scores"][i]
                data["mask" + s] = f["mask"][i]
            with full_f32():
                la = self.arch.log_assignment(
                    self.trees["matcher"], data, self.precisions["matcher"],
                    heads=self.mat["num_heads"], **kwargs)
            yield idx, la


def _keys(feats: dict, width: int) -> list:
    """Per tile: sorted position keys of the valid keypoints and the slot
    of each."""
    kp = feats["keypoints"].round().long()
    key = (kp[..., 1] * width + kp[..., 0]).cpu().numpy()
    mask = feats["mask"].cpu().numpy()
    out = []
    for t in range(key.shape[0]):
        slots = np.flatnonzero(mask[t])
        order = np.argsort(key[t, slots], kind="stable")
        out.append((key[t, slots][order], slots[order]))
    return out


def _lookup(table, keys: np.ndarray) -> np.ndarray:
    """Reference slot of each key, -1 where the reference has none."""
    sorted_keys, slots = table
    if len(sorted_keys) == 0:
        return np.full(keys.shape, -1)
    pos = np.clip(np.searchsorted(sorted_keys, keys), 0, len(sorted_keys) - 1)
    return np.where(sorted_keys[pos] == keys, slots[pos], -1)


def _slot_maps(rec_feats: dict, ref_table: list, width: int) -> np.ndarray:
    """(T, K) reference slot of each record slot (-1: none, or invalid)."""
    kp = rec_feats["keypoints"].round().long()
    key = (kp[..., 1] * width + kp[..., 0]).cpu().numpy()
    mask = rec_feats["mask"].cpu().numpy()
    out = np.stack([_lookup(ref_table[t], key[t]) for t in range(len(key))])
    return np.where(mask, out, -1)


def _mutual(ref: Reference, feats: list, idx: list, ch: dict) -> tuple:
    """Full-frame (mk0, mk1) of the mutual choices above the threshold in
    the tile pairs `idx`, given `choices` of their log assignment."""
    th = float(ref.mat["match_threshold"])
    mk0, mk1 = [], []
    for j, p in enumerate(idx):
        t0, t1 = ref.pairs[p]
        a0, a1 = ch["rowarg"][j], ch["colarg"][j]
        rows = torch.arange(len(a0), device=ref.device)
        i = torch.nonzero((a1[a0] == rows) & feats[0]["mask"][t0]
                          & (ch["rowval"][j].exp() > th))[:, 0]
        org0 = torch.as_tensor(ref.limits[t0, :2], device=ref.device)
        org1 = torch.as_tensor(ref.limits[t1, :2], device=ref.device)
        mk0.append((feats[0]["keypoints"][t0][i] + org0).cpu().numpy())
        mk1.append((feats[1]["keypoints"][t1][a0[i]] + org1).cpu().numpy())
    return mk0, mk1


def _verified(ref: Reference, mk0: list, mk1: list) -> np.ndarray:
    """(N, 4) matches, one a keypoint of frame 0 (the first tile pair's
    wins, as the matcher deduplicates), that the true fundamental matrix
    keeps within the traffic's threshold."""
    mk0 = np.concatenate(mk0).astype(np.float32)
    mk1 = np.concatenate(mk1).astype(np.float32)
    mk0, first = np.unique(mk0, axis=0, return_index=True)
    mk1 = mk1[first]
    keep = sampson(ref.F, mk0, mk1) <= float(ref.traffic["threshold"])
    return np.concatenate([mk0[keep], mk1[keep]], 1)


def tile_features(pairs: list, n_tiles: int, given: dict) -> list:
    """Per side, (T, K, ...) features of every tile, taken from what the
    matcher model was `given` (kpts0, desc0, mask0, ... of each tile pair
    in `pairs`' order) for the first tile pair that holds it."""
    out = []
    for side in range(2):
        first = [next(p for p, pair in enumerate(pairs) if pair[side] == t)
                 for t in range(n_tiles)]
        out.append({name: given[key + str(side)][first] for name, key in
                    (("keypoints", "kpts"), ("descriptors", "desc"),
                     ("mask", "mask"))})
    return out


def judge(ref: Reference, image0: np.ndarray, image1: np.ndarray,
          records: list) -> list:
    """The numbers of each record (see the module doc), one dict each."""
    feats = [ref.features(image0), ref.features(image1)]
    tw = int(ref.limits[0, 2])
    tables = [_keys(f, tw) for f in feats]
    dev = ref.device
    states = []
    for rec in records:
        miss = total = 0
        desc_err = 0.0
        maps = []
        for side in range(2):
            rf, pf = feats[side], rec["feats"][side]
            m = _slot_maps(pf, tables[side], tw)
            maps.append(torch.as_tensor(m, device=dev))
            both = int((m >= 0).sum())
            miss += int(rf["mask"].sum()) + int(pf["mask"].sum()) - 2 * both
            total += int(rf["mask"].sum())
            t_idx, k_idx = np.nonzero(m >= 0)
            if len(t_idx):
                dp = pf["descriptors"][t_idx, k_idx].float()
                dr = rf["descriptors"][t_idx, m[t_idx, k_idx]]
                desc_err = max(desc_err, float((dp - dr).norm(dim=-1).max()))
        states.append({"maps": maps, "kpt_miss": miss / max(total, 1),
                       "desc_err": desc_err, "flips": 0, "rows": 0})

    ref_mk0, ref_mk1 = [], []
    for idx, la in ref.blocks(*feats):
        ch = choices(la)
        a, b = _mutual(ref, feats, idx, ch)
        ref_mk0 += a
        ref_mk1 += b
        for rec, st in zip(records, states):
            for j, p in enumerate(idx):
                t0, t1 = ref.pairs[p]
                r0, r1 = st["maps"][0][t0], st["maps"][1][t1]
                # rows: record row i chose column rowarg[i]; columns alike
                for own, other, side in ((r0, r1, "row"), (r1, r0, "col")):
                    arg = rec[side + "arg"][p].to(dev).long()
                    chosen = other[arg.clamp(0, len(other) - 1)]
                    ok = (own >= 0) & (arg >= 0) & (chosen >= 0)
                    # the reference's own choice, where the record holds it
                    pick = ch[side + "arg"][j][own[ok]]
                    held = torch.zeros(len(other) + 1, dtype=torch.bool,
                                       device=dev)
                    held[other[other >= 0]] = True
                    fair = held[pick]
                    st["flips"] += int((fair & (pick != chosen[ok])).sum())
                    st["rows"] += int(fair.sum())
        del la
    want = {tuple(r) for r in _verified(ref, ref_mk0, ref_mk1)}
    out = []
    for rec, st in zip(records, states):
        got = {tuple(r) for r in np.concatenate(
            [rec["mk0"], rec["mk1"]], 1).astype(np.float32)}
        out.append({
            "kpt_miss": st["kpt_miss"], "desc_err": st["desc_err"],
            "row_flip": st["flips"] / max(st["rows"], 1),
            "match_diff": len(want ^ got) / max(len(want), 1),
            "verified": len(got), "reference_verified": len(want),
            "counts": [f["mask"].sum(1).tolist() for f in feats]})
    return out


def sampson(F: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> np.ndarray:
    """Sampson distance (px) of each correspondence under F, in float64."""
    h0 = np.c_[x0, np.ones(len(x0))].astype(np.float64)
    h1 = np.c_[x1, np.ones(len(x1))].astype(np.float64)
    Fx0 = h0 @ F.T
    Ftx1 = h1 @ F
    num = np.sum(h1 * Fx0, 1) ** 2
    den = Fx0[:, 0] ** 2 + Fx0[:, 1] ** 2 + Ftx1[:, 0] ** 2 + Ftx1[:, 1] ** 2
    return np.sqrt(num / np.maximum(den, 1e-300))


def choices(la: torch.Tensor) -> dict:
    """What a record keeps of a log assignment (P, K+1, K+1): each row's
    and each column's choice in the match block, and each row's best
    value."""
    block = la[:, :-1, :-1]
    rowval, rowarg = block.max(2)
    return {"rowarg": rowarg, "colarg": block.argmax(1), "rowval": rowval}


@torch.inference_mode()
def reference_record(ref: Reference, image0: np.ndarray,
                     image1: np.ndarray) -> dict:
    """`ref` put in the program's place: its features, the choices of
    its assignment and its mutual matches above the threshold that the
    true fundamental matrix keeps."""
    feats = [ref.features(image0), ref.features(image1)]
    parts, mk0, mk1 = [], [], []
    for idx, la in ref.blocks(*feats):
        ch = choices(la)
        parts.append(ch)
        a, b = _mutual(ref, feats, idx, ch)
        mk0 += a
        mk1 += b
    rec = {k: torch.cat([c[k] for c in parts]) for k in parts[0]}
    mk = _verified(ref, mk0, mk1)
    return dict(rec, feats=feats, mk0=mk[:, :2], mk1=mk[:, 2:])


def control(config: dict, traffic: dict, trees: dict, device) -> Reference:
    """The reference one precision step below the configuration's."""
    return Reference(config, traffic, trees, device, precisions={
        "extractor": lowered({"x": config["extractor"]["precision"]})["x"],
        "matcher": lowered(config["matcher"]["precision"])})
