"""Self-training LightGlue on homography-supervised and verified real
correspondences (counterpart of `icepy4d_tpu/training/lightglue_train.py`;
Lindenberger et al. 2023 §4.1, pre-training with homographies).

Pairs are patches of real frames (or synthetic canvases) and a random
homography warp of each; keypoints and descriptors come from SuperPoint;
the ground truth is the mutual-nearest reprojection under the known
homography, or, for the fine-tune, the verified correspondences of a
season's epochs (`collect_epoch_pairs`, `make_correspondence_dataset`).

Losses (paper eq. 10): every layer's assignment head against the ground
truth (matched pairs -> their cell, unmatchable points -> the dustbin),
and the confidence heads against "this layer already agrees with the
last one" (§3.3), on detached features so the auxiliary loss cannot
steer the matcher.

The forward runs the port's LightGlue blocks under autograd with
`ops.attention.dense_attention`, the differentiable f32 attention the
JAX package trains through (its Pallas kernel has no backward). The
evaluation goes through `LightGlue.match`, which on the card is the
attention kernel.
"""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import torch

from icepy4d_tpu_torch.models.convert import _np, lightglue_params
from icepy4d_tpu_torch.models.lightglue import (
    LightGlue,
    _linear,
    cross_block,
    filter_matches,
    lightglue_tree,
    match_assignment,
    normalize_keypoints,
    rotary_encoding,
    self_block,
)
from icepy4d_tpu_torch.ops.attention import dense_attention
from icepy4d_tpu_torch.training._optim import Adam, lightglue_optimizer
from icepy4d_tpu_torch.training.synthetic import (_warp,
                                                  random_homography,
                                                  synthetic_sample)

__all__ = [
    "gt_assignment",
    "assignment_nll",
    "forward_all_layers",
    "make_train_step",
    "make_lightglue_dataset",
    "collect_epoch_pairs",
    "make_correspondence_dataset",
    "homography_to_explicit",
    "train_lightglue",
    "evaluate_matching",
]

MATCH_KEYS = ("kpts0", "desc0", "mask0", "size0",
              "kpts1", "desc1", "mask1", "size1")


# -- supervision ---------------------------------------------------------------

def gt_assignment(kpts0: torch.Tensor, kpts1: torch.Tensor, H: torch.Tensor,
                  mask0: torch.Tensor, mask1: torch.Tensor,
                  pos_th: float = 3.0, neg_th: float = 6.0):
    """Ground-truth matches of two keypoint sets under a homography.

    kpts0 (B, M, 2) xy in image 0; H (B, 3, 3) maps image-0 pixels to
    image 1. (i, j) is a match iff j is i's mutual nearest reprojection
    within pos_th px; a point whose nearest reprojection is beyond
    neg_th px is unmatchable (dustbin); the band between is ignored.

    Returns (gt0 (B, M) int32, -1 = no match; unm0 (B, M) bool; unm1
    (B, N) bool)."""
    m = kpts0.shape[1]
    ones = torch.ones_like(kpts0[..., :1])
    p = torch.cat([kpts0, ones], -1) @ H.transpose(1, 2)
    z = p[..., 2:]
    p = p[..., :2] / torch.where(z.abs() < 1e-9, 1e-9, z)
    d2 = ((p[:, :, None, :] - kpts1[:, None, :, :]) ** 2).sum(-1)
    valid = mask0[:, :, None] & mask1[:, None, :]
    d2 = torch.where(valid, d2, float("inf"))
    nn0 = d2.argmin(2)                                  # (B, M)
    nn1 = d2.argmin(1)                                  # (B, N)
    min0 = d2.amin(2)
    min1 = d2.amin(1)
    mutual = torch.gather(nn1, 1, nn0) == torch.arange(
        m, device=kpts0.device)[None]
    is_match = mutual & (min0 <= pos_th ** 2) & mask0
    gt0 = torch.where(is_match, nn0, -1).to(torch.int32)
    unm0 = mask0 & (min0 > neg_th ** 2)
    unm1 = mask1 & (min1 > neg_th ** 2)
    return gt0, unm0, unm1


def assignment_nll(scores: torch.Tensor, gt0: torch.Tensor,
                   unm0: torch.Tensor, unm1: torch.Tensor) -> torch.Tensor:
    """LightGlue loss (paper eq. 10) on one log-assignment matrix
    (B, M+1, N+1): the matched pairs' NLL averaged over the matches, the
    dustbin NLL over the unmatchable points (half weight each side),
    every count at least 1."""
    m, n = scores.shape[1] - 1, scores.shape[2] - 1
    matched = gt0 >= 0
    pick = torch.gather(scores[:, :m, :], 2,
                        gt0.clamp_min(0).long()[..., None])[..., 0]
    l_match = -torch.where(matched, pick, 0.0).sum() \
        / matched.sum().clamp_min(1)
    l_un0 = -torch.where(unm0, scores[:, :m, n], 0.0).sum() \
        / unm0.sum().clamp_min(1)
    l_un1 = -torch.where(unm1, scores[:, m, :n], 0.0).sum() \
        / unm1.sum().clamp_min(1)
    return l_match + 0.5 * (l_un0 + l_un1)


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid binary cross-entropy."""
    return torch.clamp_min(logits, 0) - logits * labels \
        + torch.log1p(torch.exp(-logits.abs()))


# -- forward with per-layer heads ----------------------------------------------

def forward_all_layers(model: LightGlue, data: dict, attn=dense_attention):
    """The transformer's descriptor states after each layer:
    (d0 (L, B, M, D), d1 (L, B, N, D)), f32, under autograd."""
    kpts0 = normalize_keypoints(data["kpts0"], data.get("size0"))
    kpts1 = normalize_keypoints(data["kpts1"], data.get("size1"))
    mask0, mask1 = data["mask0"], data["mask1"]
    d0 = _linear(model.input_proj, data["desc0"].float())
    d1 = _linear(model.input_proj, data["desc1"].float())
    enc0 = rotary_encoding(model.posenc, kpts0)
    enc1 = rotary_encoding(model.posenc, kpts1)
    nh = model.num_heads
    d0s, d1s = [], []
    for layer in model.layers:
        d0 = self_block(layer.self_attn, d0, enc0, mask0, nh, attn)
        d1 = self_block(layer.self_attn, d1, enc1, mask1, nh, attn)
        d0, d1 = cross_block(layer.cross_attn, d0, d1, mask0, mask1, nh,
                             attn)
        d0s.append(d0)
        d1s.append(d1)
    return torch.stack(d0s), torch.stack(d1s)


def lightglue_loss(model: LightGlue, batch: dict, conf_weight: float = 0.25,
                   pos_th: float = 3.0, neg_th: float = 6.0,
                   explicit_gt: bool = False) -> tuple[torch.Tensor, dict]:
    """(loss, metrics) of one batch: the mean over layers of the
    assignment NLL plus conf_weight * the confidence heads' CE.

    batch: kpts0, desc0, mask0, size0, kpts1, desc1, mask1, size1 and
    either H (homography supervision) or, with explicit_gt, gt0 / unm0 /
    unm1 (verified correspondences, where no homography exists)."""
    mask0, mask1 = batch["mask0"], batch["mask1"]
    if explicit_gt:
        gt0, unm0, unm1 = batch["gt0"], batch["unm0"], batch["unm1"]
    else:
        gt0, unm0, unm1 = gt_assignment(batch["kpts0"], batch["kpts1"],
                                        batch["H"], mask0, mask1,
                                        pos_th, neg_th)
    d0s, d1s = forward_all_layers(model, batch)
    n_layers = len(model.layers)
    scores_l = [match_assignment(model.assign[i], d0s[i], d1s[i], mask0,
                                 mask1) for i in range(n_layers)]
    l_assign = torch.stack([assignment_nll(s, gt0, unm0, unm1)
                            for s in scores_l]).mean()

    # confidence heads: per-point agreement with the final layer's
    # mutual-max matches (no gradient through the matches)
    with torch.no_grad():
        m0_l = [filter_matches(s, 0.0)[0] for s in scores_l]
    final = m0_l[-1]
    n_valid = mask0.sum().clamp_min(1)
    ces = []
    for i in range(n_layers - 1):
        tgt0 = (m0_l[i] == final).float()
        z0 = _linear(model.confidence[i].token, d0s[i].detach())[..., 0]
        ces.append(torch.where(mask0, sigmoid_ce(z0, tgt0), 0.0).sum()
                   / n_valid)
    l_conf = torch.stack(ces).mean()

    loss = l_assign + conf_weight * l_conf
    n_gt = (gt0 >= 0).sum()
    hit = (torch.where(mask0, final, -1) == gt0) & (gt0 >= 0)
    recall = hit.sum() / n_gt.clamp_min(1)
    return loss, {"loss": loss.detach(), "assign": l_assign.detach(),
                  "conf": l_conf.detach(), "n_gt": n_gt,
                  "recall_gt": recall}


def make_train_step(model: LightGlue, opt: Adam, conf_weight: float = 0.25,
                    pos_th: float = 3.0, neg_th: float = 6.0,
                    explicit_gt: bool = False):
    """train_step(batch) -> metrics: one forward, backward and update of
    `model`'s parameters in place (batch as `lightglue_loss` takes it).
    The step's gradients stay in `.grad` until the next step."""

    def train_step(batch):
        opt.zero_grad()
        loss, metrics = lightglue_loss(model, batch, conf_weight, pos_th,
                                       neg_th, explicit_gt)
        loss.backward()
        opt.step()
        return metrics

    return train_step


# -- data ----------------------------------------------------------------------

def _photometric(rng, img: np.ndarray) -> np.ndarray:
    """Brightness, contrast, blur and noise jitter per view."""
    out = img * rng.uniform(0.6, 1.4) + rng.uniform(-0.15, 0.15)
    if rng.uniform() < 0.5:
        import cv2

        out = cv2.GaussianBlur(out, (0, 0), rng.uniform(0.3, 1.0))
    out = out + rng.normal(0, rng.uniform(0.005, 0.03), out.shape)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def make_lightglue_dataset(
    rng,
    extract_fn,
    n_batches: int,
    batch: int,
    h: int = 240,
    w: int = 320,
    real_pool=None,
    real_fraction: float = 0.7,
    warp_strength: float = 0.22,
    extract_chunk: int = 64,
):
    """Cached training set of keypoint / descriptor pair batches.

    extract_fn(images (K, h, w) tensor) -> dict(keypoints, descriptors,
    scores, mask), e.g. a SuperPoint's `extract`. View 0 is a real patch
    (with probability real_fraction when a pool is given) or a synthetic
    canvas, view 1 its random homography warp, each with its own
    photometric jitter; extraction runs in chunks of extract_chunk
    images. Returns numpy arrays with leading axes (n_batches, batch)."""
    import cv2

    n_pairs = n_batches * batch
    imgs0 = np.empty((n_pairs, h, w), np.float32)
    imgs1 = np.empty((n_pairs, h, w), np.float32)
    Hs = np.empty((n_pairs, 3, 3), np.float32)
    for i in range(n_pairs):
        use_real = real_pool is not None and rng.uniform() < real_fraction
        if use_real:
            src = real_pool[int(rng.integers(len(real_pool)))]
            sh, sw = src.shape
            if sh < h or sw < w:
                src = cv2.resize(src, (max(sw, w), max(sh, h)))
                sh, sw = src.shape
            y0 = int(rng.integers(0, sh - h + 1))
            x0 = int(rng.integers(0, sw - w + 1))
            base = src[y0:y0 + h, x0:x0 + w].astype(np.float32)
        else:
            base, _ = synthetic_sample(rng, h, w)
        H = random_homography(rng, h, w, strength=warp_strength)
        imgs0[i] = _photometric(rng, base)
        imgs1[i] = _photometric(rng, _warp(base, H, w, h))
        Hs[i] = H

    def extract_all(imgs):
        outs = []
        for s in range(0, n_pairs, extract_chunk):
            out = extract_fn(torch.from_numpy(imgs[s:s + extract_chunk]))
            outs.append({k: _np(v) for k, v in out.items()})
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    f0 = extract_all(imgs0)
    f1 = extract_all(imgs1)
    size = np.tile(np.asarray([w, h], np.float32), (n_pairs, 1))
    ds = {
        "kpts0": f0["keypoints"], "desc0": f0["descriptors"],
        "mask0": f0["mask"], "size0": size,
        "kpts1": f1["keypoints"], "desc1": f1["descriptors"],
        "mask1": f1["mask"], "size1": size,
        "H": Hs,
    }
    return {k: v.reshape(n_batches, batch, *v.shape[1:])
            for k, v in ds.items()}


def collect_epoch_pairs(results_dir, cams: tuple[str, str] | None = None,
                        min_corr: int = 50, image_scale: float = 1.0,
                        statuses: tuple[str, ...] = ("ok", "degraded")):
    """Verified wide-baseline correspondences from the epoch checkpoints
    (`epochs/*/*.pickle`) a port `Pipeline` writes under results_dir.

    The features of an epoch's cameras share track ids; their
    intersection is the geometrically verified correspondence set.
    Returns [{img0, img1 (H, W) float32 in [0, 1], corr0, corr1 (n, 2)
    xy}] for make_correspondence_dataset, the frames (and the points)
    scaled by image_scale."""
    import cv2

    from icepy4d_tpu_torch.core.epoch import Epoch

    pairs = []
    for p in sorted(Path(results_dir).glob("epochs/*/*.pickle")):
        ep = Epoch.read_pickle(p)
        if ep.quality.get("status", "ok") not in statuses:
            continue
        names = sorted(ep.features)
        if cams is not None:
            names = [c for c in cams if c in ep.features]
        if len(names) < 2:
            continue
        c0, c1 = names[:2]
        f0, f1 = ep.features[c0], ep.features[c1]
        common, i0, i1 = np.intersect1d(f0.track_ids_to_numpy(),
                                        f1.track_ids_to_numpy(),
                                        return_indices=True)
        if len(common) < min_corr:
            continue
        xy0 = f0.kpts_to_numpy()[i0]
        xy1 = f1.kpts_to_numpy()[i1]
        imgs = {}
        for cam in (c0, c1):
            path = getattr(ep.images.get(cam), "path", None)
            if path is None or not Path(path).exists():
                imgs = None
                break
            g = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
            if image_scale != 1.0:
                # INTER_AREA: a 4x downscale aliases under INTER_LINEAR
                g = cv2.resize(g, (int(round(g.shape[1] * image_scale)),
                                   int(round(g.shape[0] * image_scale))),
                               interpolation=cv2.INTER_AREA)
            imgs[cam] = g.astype(np.float32) / 255.0
        if imgs is None:
            continue

        def rescale(xy):
            # cv2's pixel-centre convention: x maps to (x + 0.5) * s - 0.5
            return ((xy + 0.5) * image_scale - 0.5).astype(np.float32)

        pairs.append({"img0": imgs[c0], "img1": imgs[c1],
                      "corr0": rescale(xy0), "corr1": rescale(xy1)})
    return pairs


def make_correspondence_dataset(
    rng,
    describe_fn,
    detect_fn,
    pairs: list,
    n_batches: int,
    batch: int,
    n_kpts: int = 512,
    pos_fraction: float = 0.5,
    neg_margin: float = 6.0,
):
    """Explicit-GT training batches from verified real correspondences.

    describe_fn(images (1, H, W), kpts (1, K, 2)) -> (1, K, D)
    descriptors at the given positions (SuperPoint.describe_at);
    detect_fn(images (1, H, W)) -> extract() dict, whose detections fill
    the slots after the correspondences as unmatchable negatives. A
    sample draws up to n_kpts * pos_fraction of one pair's
    correspondences into the first slots (gt = identity) and fills the
    rest with shuffled detections; a detection within neg_margin px of
    any correspondence is supervised as neither matched nor
    unmatchable. Shapes (n_batches, batch, n_kpts, ...)."""
    n_samples = n_batches * batch
    per_pair = []
    for pr in pairs:
        entry = {}
        for side in (0, 1):
            img = pr[f"img{side}"]
            h, w = img.shape
            corr = np.asarray(pr[f"corr{side}"], np.float32)
            desc = _np(describe_fn(torch.from_numpy(img[None]),
                                   torch.from_numpy(corr[None])))[0]
            det = detect_fn(torch.from_numpy(img[None]))
            entry[side] = {
                "size": np.asarray([w, h], np.float32),
                "corr": corr, "corr_desc": desc,
                "det_xy": _np(det["keypoints"])[0],
                "det_desc": _np(det["descriptors"])[0],
                "det_mask": _np(det["mask"])[0],
            }
        per_pair.append(entry)

    keys = ("kpts0", "desc0", "mask0", "unm0", "size0",
            "kpts1", "desc1", "mask1", "unm1", "size1")
    out = {k: [] for k in keys + ("gt0",)}
    d_dim = per_pair[0][0]["corr_desc"].shape[-1]
    n_pos_max = int(n_kpts * pos_fraction)
    for _ in range(n_samples):
        entry = per_pair[int(rng.integers(len(per_pair)))]
        n_corr = len(entry[0]["corr"])
        n_pos = min(n_corr, n_pos_max)
        sel = rng.choice(n_corr, size=n_pos, replace=False)
        for side in (0, 1):
            e = entry[side]
            kpts = np.zeros((n_kpts, 2), np.float32)
            desc = np.zeros((n_kpts, d_dim), np.float32)
            mask = np.zeros((n_kpts,), bool)
            kpts[:n_pos] = e["corr"][sel]
            desc[:n_pos] = e["corr_desc"][sel]
            mask[:n_pos] = True
            dv = np.flatnonzero(e["det_mask"])
            rng.shuffle(dv)
            n_neg = min(len(dv), n_kpts - n_pos)
            kpts[n_pos:n_pos + n_neg] = e["det_xy"][dv[:n_neg]]
            desc[n_pos:n_pos + n_neg] = e["det_desc"][dv[:n_neg]]
            mask[n_pos:n_pos + n_neg] = True
            # a detection near any tracked correspondence (sampled or
            # not) has a partner in the other view: unknown status
            unm = np.zeros((n_kpts,), bool)
            if n_neg:
                d2 = np.sum((kpts[n_pos:n_pos + n_neg, None, :]
                             - e["corr"][None, :, :]) ** 2, -1)
                unm[n_pos:n_pos + n_neg] = ~(d2.min(1) < neg_margin ** 2)
            for k, v in zip(keys[5 * side:5 * side + 5],
                            (kpts, desc, mask, unm, e["size"])):
                out[k].append(v)
        gt0 = np.full((n_kpts,), -1, np.int32)
        gt0[:n_pos] = np.arange(n_pos)
        out["gt0"].append(gt0)
    return {k: np.stack(v).reshape(n_batches, batch, *v[0].shape)
            for k, v in out.items()}


def homography_to_explicit(ds: dict, pos_th: float = 3.0,
                           neg_th: float = 6.0, device=None) -> dict:
    """A homography-supervised dataset (make_lightglue_dataset) in the
    explicit-GT format, to mix with make_correspondence_dataset's
    batches: gt_assignment of every pair at once, H dropped."""
    from icepy4d_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    nb, b = ds["H"].shape[:2]

    def flat(k):
        v = ds[k]
        return torch.from_numpy(v.reshape(nb * b, *v.shape[2:])).to(dev)

    gt0, unm0, unm1 = gt_assignment(flat("kpts0"), flat("kpts1"), flat("H"),
                                    flat("mask0"), flat("mask1"), pos_th,
                                    neg_th)
    out = {k: v for k, v in ds.items() if k != "H"}
    out["gt0"] = _np(gt0).reshape(nb, b, -1)
    out["unm0"] = _np(unm0).reshape(nb, b, -1)
    out["unm1"] = _np(unm1).reshape(nb, b, -1)
    return out


# -- training and evaluation -----------------------------------------------------

def train_lightglue(
    model: LightGlue,
    dataset: dict,
    steps: int = 3000,
    lr: float = 1e-4,
    seed: int = 0,
    params: dict | None = None,
    scan_chunk: int = 100,
    conf_weight: float = 0.25,
    warmup: int = 200,
    log=print,
    save_fn=None,
    save_every: int = 0,
):
    """Train `model` in place on a cached dataset and return
    (state_dict, history).

    The dataset goes to the model's device once; step k takes batch
    k % n_batches. Adam behind a global-norm clip of 1.0, with a linear
    warmup to lr over `warmup` steps and a cosine decay to 0.05 lr.
    params: a LightGlue state dict to start from; None is the JAX
    package's fresh init for `seed` (`lightglue_tree`). Losses and
    recalls are read once per scan_chunk steps, one history entry {step,
    loss, chunk_mean, recall_gt} each. save_fn(state_dict, step) runs
    every save_every steps (at chunk ends)."""
    dev = model.device
    n_batches = next(iter(dataset.values())).shape[0]
    explicit_gt = "gt0" in dataset
    if params is None:
        params = lightglue_params(lightglue_tree(
            model.n_layers, model.input_proj.in_features,
            model.input_proj.out_features, model.num_heads, seed))
    model.load_state_dict(params)
    opt = lightglue_optimizer(model.parameters(), lr, steps, warmup)
    step_fn = make_train_step(model, opt, conf_weight,
                              explicit_gt=explicit_gt)
    data = {k: torch.from_numpy(np.asarray(v)).to(dev)
            for k, v in dataset.items()}

    def state():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    history = []
    done = 0
    last_save = 0
    while done < steps:
        n = min(scan_chunk, steps - done)
        losses, recalls = [], []
        for k in range(n):
            i = (done + k) % n_batches
            metrics = step_fn({key: v[i] for key, v in data.items()})
            losses.append(metrics["loss"])
            recalls.append(metrics["recall_gt"])
        losses = torch.stack(losses).cpu().numpy()
        recalls = torch.stack(recalls).cpu().numpy()
        history.append({"step": done + n - 1,
                        "loss": float(losses[-1]),
                        "chunk_mean": float(losses.mean()),
                        "recall_gt": float(recalls[-1])})
        log(f"step {done + n - 1:6d}  loss {losses[-1]:.4f}  "
            f"(chunk mean {losses.mean():.4f})  "
            f"GT recall {recalls[-1]:.3f}")
        done += n
        if save_fn is not None and save_every and \
                done - last_save >= save_every and done < steps:
            save_fn(state(), done)
            last_save = done
    return state(), history


def evaluate_matching(model: LightGlue, params: dict | None, dataset: dict,
                      n_batches: int | None = None,
                      filter_threshold: float | None = None):
    """Precision and recall of `model.match`'s mutual-max matches
    against the ground truth (the dataset's homography, or its explicit
    gt0), over the first n_batches batches.

    params: a state dict loaded into the model first, or None for its
    current weights. filter_threshold overrides the model's confidence
    filter for this evaluation. With unm0 in the dataset, also
    precision_labeled: wrong matches counted only on rows whose status
    is known (matched or verified unmatchable)."""
    if params is not None:
        model.load_state_dict(params)
    if filter_threshold is not None and \
            filter_threshold != model.filter_threshold:
        model = copy.copy(model)
        model.filter_threshold = float(filter_threshold)
    nb = (next(iter(dataset.values())).shape[0]
          if n_batches is None else n_batches)
    tp = fp = n_gt = fp_labeled = 0
    has_unm = "unm0" in dataset
    for i in range(nb):
        batch = {k: torch.from_numpy(np.asarray(v[i]))
                 for k, v in dataset.items()}
        out = model.match({k: batch[k] for k in MATCH_KEYS})
        if "gt0" in batch:
            g = batch["gt0"].numpy()
        else:
            g = _np(gt_assignment(*(batch[k].to(model.device) for k in (
                "kpts0", "kpts1", "H", "mask0", "mask1")))[0])
        m0 = _np(out["matches0"])
        pred = m0 >= 0
        wrong = pred & (m0 != g)
        tp += int(((m0 == g) & pred & (g >= 0)).sum())
        fp += int(wrong.sum())
        n_gt += int((g >= 0).sum())
        if has_unm:
            known = (g >= 0) | batch["unm0"].numpy()
            fp_labeled += int((wrong & known).sum())
    out_d = {"precision": tp / max(tp + fp, 1),
             "recall": tp / max(n_gt, 1),
             "n_gt": n_gt, "n_pred": tp + fp}
    if has_unm:
        out_d["precision_labeled"] = tp / max(tp + fp_labeled, 1)
    return out_d
