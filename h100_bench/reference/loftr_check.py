"""The comparison that decides `correct` in the LoFTR cells.

For a pair the window matched, the reference (`reference/loftr.py`)
runs every GRID tile pair of the pair in float32 (TF32 off), one tile
pair at a time, from the same uint8 frames and weights the program was
given. A record of what the program produced for that pair, read through
public surfaces only (what `LoFTR.match_batch` returned for each real
tile pair: keypoints0/1, confidence and valid), is then judged against
it:

  coarse_flip  coarse matches (tile pair, i, j) in one set only, over
               the reference's count. i is the frame-0 cell, read
               exactly from keypoints0 (cell corners, multiples of 8);
               j the frame-1 cell nearest keypoints1, which the fine
               stage moves by less than half a cell
  conf_err     the largest relative gap |c - c_ref| / c_ref of the
               dual-softmax confidence of a match both sets hold
  fine_px      the largest gap, in px, of the refined frame-1 keypoint
               of a match both sets hold

The verified matches are not compared: with random weights they are
noise that DEGENSAC may or may not find a consensus in, as in the
SuperGlue cell.

The control (`control`, judged through `reference_record`) is the
reference one operand precision below the configuration's in the
program's place; `stated` is the reference at the configuration's own
precisions, which the limits have to admit.
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench.reference import loftr
from h100_bench.reference.precision import full_f32, lowered
from h100_bench.reference.tiles import tile_limits


def grid_pairs(n_tiles: int) -> list:
    """GRID tile selection pairs tile t of one frame with tile t of the
    other, in order."""
    return [(t, t) for t in range(n_tiles)]


class Reference:
    """The LoFTR reference of a configuration on `device`: float32
    throughout, or the operand precisions `precisions` where given."""

    def __init__(self, config: dict, traffic: dict, tree: dict, device,
                 precisions: dict | None = None):
        self.cfg = config["matcher"]
        self.tree = tree
        self.device = torch.device(device)
        self.precisions = precisions or {k: "f32"
                                         for k in self.cfg["precision"]}
        t = traffic
        self.limits = tile_limits(t["height"], t["width"], t["grid"],
                                  t["overlap"])
        self.pairs = grid_pairs(len(self.limits))

    def tile(self, image: np.ndarray, t: int) -> torch.Tensor:
        x0, y0, tw, th = (int(v) for v in self.limits[t])
        return torch.from_numpy(
            np.ascontiguousarray(image[y0:y0 + th, x0:x0 + tw])).to(
            self.device).float() / 255.0

    @torch.inference_mode()
    def matches(self, image0: np.ndarray, image1: np.ndarray):
        """Yield (tile pair, the reference's matches) over the pair's
        tile pairs."""
        for p, (t0, t1) in enumerate(self.pairs):
            with full_f32():
                yield p, loftr.forward(
                    self.tree, self.tile(image0, t0), self.tile(image1, t1),
                    self.cfg, self.precisions,
                    float(self.cfg["confidence_threshold"]),
                    int(self.cfg["max_matches"]))


def _table(kpts0, kpts1, conf, valid, wc: int) -> dict:
    """{(i, j): (confidence, keypoints1)} of one tile pair's valid
    matches, on the host."""
    v = np.asarray(valid, bool)
    k0 = np.asarray(kpts0, np.float64)[v]
    k1 = np.asarray(kpts1, np.float64)[v]
    c = np.asarray(conf, np.float64)[v]
    i = (np.rint(k0[:, 1] / 8) * wc + np.rint(k0[:, 0] / 8)).astype(np.int64)
    cell1 = np.floor(k1 / 8 + 0.5)
    j = (cell1[:, 1] * wc + cell1[:, 0]).astype(np.int64)
    return {(int(a), int(b)): (float(cc), kk)
            for a, b, cc, kk in zip(i, j, c, k1)}


def record_tables(rec: dict, wc: int) -> list:
    """Per tile pair, the record's match table."""
    host = {k: rec[k].cpu().numpy() for k in ("kpts0", "kpts1", "conf",
                                              "valid")}
    return [_table(host["kpts0"][p], host["kpts1"][p], host["conf"][p],
                   host["valid"][p], wc) for p in range(len(host["valid"]))]


def judge(ref: Reference, image0: np.ndarray, image1: np.ndarray,
          records: list) -> list:
    """The numbers of each record (see the module doc), one dict each,
    and the reference's kept matches of each tile pair under
    "counts"."""
    wc = int(ref.limits[0, 2]) // 8
    tables = [record_tables(rec, wc) for rec in records]
    states = [{"flips": 0, "conf_err": 0.0, "fine_px": 0.0, "matches": 0}
              for _ in records]
    total, counts = 0, []
    for p, m in ref.matches(image0, image1):
        want = _table(m["kpts0"].cpu().numpy(), m["kpts1"].cpu().numpy(),
                      m["conf"].cpu().numpy(),
                      np.ones(len(m["i"]), bool), wc)
        total += len(want)
        counts.append(len(want))
        for tab, st in zip(tables, states):
            got = tab[p]
            st["matches"] += len(got)
            st["flips"] += len(want.keys() ^ got.keys())
            for key in want.keys() & got.keys():
                (c, k1), (cr, k1r) = got[key], want[key]
                st["conf_err"] = max(st["conf_err"], abs(c - cr) / cr)
                st["fine_px"] = max(st["fine_px"],
                                    float(np.abs(k1 - k1r).max()))
    return [{"coarse_flip": st["flips"] / max(total, 1),
             "conf_err": st["conf_err"], "fine_px": st["fine_px"],
             "matches": st["matches"], "reference_matches": total,
             "counts": counts} for st in states]


@torch.inference_mode()
def reference_record(ref: Reference, image0: np.ndarray,
                     image1: np.ndarray) -> dict:
    """`ref` put in the program's place: per tile pair its kept matches,
    padded to `max_matches` slots."""
    cap = int(ref.cfg["max_matches"])
    n = len(ref.pairs)
    rec = {"kpts0": torch.zeros(n, cap, 2), "kpts1": torch.zeros(n, cap, 2),
           "conf": torch.zeros(n, cap),
           "valid": torch.zeros(n, cap, dtype=torch.bool)}
    for p, m in ref.matches(image0, image1):
        k = len(m["i"])
        rec["kpts0"][p, :k] = m["kpts0"].cpu()
        rec["kpts1"][p, :k] = m["kpts1"].cpu()
        rec["conf"][p, :k] = m["conf"].cpu()
        rec["valid"][p, :k] = True
    return rec


def control(config: dict, traffic: dict, tree: dict, device) -> Reference:
    """The reference one precision step below the configuration's."""
    return Reference(config, traffic, tree, device,
                     precisions=lowered(config["matcher"]["precision"]))


def stated(config: dict, traffic: dict, tree: dict, device) -> Reference:
    """The reference with its operands rounded to the configuration's
    stated precisions: what a program that runs every product at them
    would read."""
    return Reference(config, traffic, tree, device,
                     precisions=dict(config["matcher"]["precision"]))
