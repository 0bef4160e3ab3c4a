"""The batched epoch step: extract -> match -> pose -> triangulate over B
stereo pairs (counterpart of `icepy4d_tpu/parallel/epoch_step.py`).

The JAX package compiles the step into one program sharded over a
(data, model) mesh. Here the step is eager: each side's B frames go
through the extractor as one batched call (in chunks that fit the
activation budget), the matcher runs once over the B pairs, and each
pair's essential RANSAC and triangulation follow in a loop. On the card
SuperPoint's NMS kernel runs once per extraction chunk and LightGlue's
or SuperGlue's attention kernel at (B, heads, K, K). Where the mesh's
slots name several devices, each device runs the pairs of its slots
and the results come back in slot order.

Randomness: the JAX step splits PRNGKey(0) over the pairs (PRNGKey(1)
for the guided step's first round). The port draws every pair's
hypotheses in turn from one `torch.Generator` on the step's device,
seeded 0 (1 for the first round) at each call; the two packages agree
by outcome, not draw for draw.
"""

from __future__ import annotations

import torch

from icepy4d_tpu_torch.device import full_f32_matmul
from icepy4d_tpu_torch.ops.ransac import ransac_essential_pose
from icepy4d_tpu_torch.ops.topk import top2_last
from icepy4d_tpu_torch.ops.triangulation import iterative_ls_triangulation
from icepy4d_tpu_torch.parallel.mesh import Mesh, _to, shard_batch, tree_map


def _generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _intrinsics(K0, K1) -> dict:
    return {"K0": torch.as_tensor(K0, dtype=torch.float32),
            "K1": torch.as_tensor(K1, dtype=torch.float32)}


def _extract(extractor, images: torch.Tensor, chunk: int | None) -> dict:
    """The extractor over (B, H, W) frames, `chunk` frames a call."""
    b = images.shape[0]
    chunk = chunk or b
    outs = [extractor.extract(images[i:i + chunk])
            for i in range(0, b, chunk)]
    return {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}


def _gather_matched(feats0: dict, feats1: dict, matches0: torch.Tensor):
    """(valid (B, K), mk0 (B, K, 2), mk1 (B, K, 2)): every slot of side
    0 with its partner on side 1 (slot 0 where unmatched)."""
    j = matches0.clamp_min(0).long()
    mk1 = torch.gather(feats1["keypoints"], 1, j[..., None].expand(-1, -1, 2))
    return matches0 > -1, feats0["keypoints"], mk1


def _pose_and_triangulate(feats0: dict, feats1: dict, matches0, K0, K1,
                          n_hypotheses: int, threshold_px: float) -> dict:
    """Gather the matched keypoints, RANSAC an essential pose for each
    pair and triangulate all its slots (fixed capacity, masked)."""
    valid, mk0, mk1 = _gather_matched(feats0, feats1, matches0)
    dev = mk0.device
    gen = _generator(dev, 0)
    P0 = K0 @ torch.eye(3, 4, device=dev)
    R, t, pts, inl = [], [], [], []
    for b in range(matches0.shape[0]):
        Rb, tb, _E, ib = ransac_essential_pose(
            gen, mk0[b], mk1[b], K0, K1, valid[b], threshold_px=threshold_px,
            n_hypotheses=n_hypotheses)
        P1 = K1 @ torch.cat([Rb, tb[:, None]], 1)
        pb, _ = iterative_ls_triangulation(mk0[b], mk1[b], P0, P1)
        R.append(Rb)
        t.append(tb)
        pts.append(pb)
        inl.append(ib)
    return {"matches0": matches0, "mkpts0": mk0, "mkpts1": mk1,
            "valid": valid & torch.stack(inl), "R": torch.stack(R),
            "t": torch.stack(t), "points3d": torch.stack(pts)}


def _over_mesh(mesh: Mesh, fn, batched: dict, shared: dict) -> dict:
    """fn(**batched, **shared) with the batched tensors split over the
    mesh's data slots: each distinct device runs the rows of its slots,
    and the outputs (dicts of batch-leading tensors) come back in slot
    order on the first slot's device."""
    dp = mesh.shape[mesh.axis_names[0]]
    b = next(iter(batched.values())).shape[0]
    if b % dp:
        raise ValueError(f"batch {b} is not divisible by the data axis "
                         f"({dp}): pad it to the mesh size")
    devs = mesh.distinct
    if len(devs) == 1:
        d = devs[0]
        return fn(**tree_map(_to(d), batched), **tree_map(_to(d), shared))
    shards = shard_batch(mesh, batched)
    slots = mesh.slots()
    m = b // dp
    outs: list = [None] * dp
    for d in devs:
        mine = [i for i, s in enumerate(slots) if s == d]
        args = {k: torch.cat([shards[i][k] for i in mine]) for k in batched}
        res = fn(**args, **tree_map(_to(d), shared))
        for j, i in enumerate(mine):
            outs[i] = {k: v[j * m:(j + 1) * m] for k, v in res.items()}
    return {k: torch.cat([o[k].to(devs[0]) for o in outs])
            for k in outs[0]}


def make_sharded_match_step(mesh: Mesh, superpoint, matcher,
                            n_hypotheses: int = 128,
                            threshold_px: float = 2.0,
                            extract_chunk: int | None = None):
    """The step of the learned matchers.

    step(images0, images1, K0, K1): images* (B, H, W) grayscale in
    [0, 1], B divisible by the mesh's data axis; K* (3, 3) intrinsics
    shared by the pairs. `superpoint` is the extractor (its weights in
    the module), `matcher` the LightGlue or SuperGlue module;
    `extract_chunk` frames go through the extractor a call (None: all
    B). Returns per-pair matches0, mkpts0, mkpts1 (B, K, ...), valid
    (matched and an inlier of the pair's pose), R, t, points3d and
    mscores0."""

    def local(images0, images1, K0, K1):
        b, h, w = images0.shape
        with torch.inference_mode():
            feats0 = _extract(superpoint, images0, extract_chunk)
            feats1 = _extract(superpoint, images1, extract_chunk)
            size = torch.tensor([w, h], dtype=torch.float32,
                                device=images0.device).expand(b, 2)
            data = {"kpts0": feats0["keypoints"],
                    "desc0": feats0["descriptors"],
                    "mask0": feats0["mask"], "size0": size,
                    "kpts1": feats1["keypoints"],
                    "desc1": feats1["descriptors"],
                    "mask1": feats1["mask"], "size1": size,
                    "scores0": feats0["scores"], "scores1": feats1["scores"]}
            out = matcher.match(data)
            res = _pose_and_triangulate(feats0, feats1, out["matches0"], K0,
                                        K1, n_hypotheses, threshold_px)
        res["mscores0"] = out["mscores0"]
        return res

    def step(images0, images1, K0, K1):
        return _over_mesh(mesh, local,
                          {"images0": images0, "images1": images1},
                          _intrinsics(K0, K1))

    return step


def _nn_epipolar_band(d0, d1, k0, k1, mask0, mask1, F, band: float,
                      ratio: float, min_sim: float):
    """Lowe-ratio NN restricted to the epipolar band of a per-pair F
    (B, 3, 3): candidates farther than `band` px from each other's
    epipolar lines are masked out of the similarities before the ratio
    test; a lone in-band candidate passes it; then the mutual check and
    the similarity floor. Returns (matches0 int32, mscores0)."""
    h0 = torch.cat([k0, torch.ones_like(k0[..., :1])], -1)
    h1 = torch.cat([k1, torch.ones_like(k1[..., :1])], -1)
    F = F.to(torch.float32)
    with full_f32_matmul():
        l1 = torch.bmm(h0, F.mT)                   # lines in image 1
        l0 = torch.bmm(h1, F)                      # lines in image 0
        num = torch.bmm(l1, h1.mT).abs()           # (B, M, N)
        sim = torch.bmm(d0.float(), d1.float().mT)
    n1 = torch.linalg.vector_norm(l1[..., :2], dim=-1).clamp_min(1e-9)
    n0 = torch.linalg.vector_norm(l0[..., :2], dim=-1).clamp_min(1e-9)
    inband = ((num / n1[:, :, None]) < band) & ((num / n0[:, None, :]) < band)
    neg = torch.finfo(sim.dtype).min
    sim = torch.where(mask0[:, :, None] & mask1[:, None, :] & inband, sim,
                      neg)
    s1, s2, m0 = top2_last(sim)
    ok = (1.0 - s1) < ratio ** 2 * (1.0 - s2)
    ok |= s2 <= neg / 2
    m1 = sim.argmax(dim=1)
    rows = torch.arange(sim.shape[1], device=sim.device)[None]
    ok &= rows == torch.gather(m1, 1, m0)
    ok &= mask0 & (s1 > min_sim)
    return (torch.where(ok, m0, -1).to(torch.int32),
            torch.where(ok, s1, 0.0))


def make_sharded_nn_step(mesh: Mesh, extractor, nn_fn,
                         n_hypotheses: int = 128, threshold_px: float = 2.0,
                         guided: dict | None = None,
                         extract_chunk: int | None = None):
    """The step of the classic matchers (SIFT, NN over SuperPoint).

    step(images0, images1, K0, K1[, F_prior, prior_ok]) as the learned
    step's; `nn_fn(d0, d1, mask0, mask1) -> (matches0, mscores0)` is
    the batched NN (e.g. a bound `SIFTMatcher._nn`). With `guided`
    (band, ratio, min_sim) the blind match is followed by a per-pair F
    (F_prior (B, 3, 3) in the match frame where prior_ok (B,), else
    from the first round's essential RANSAC) and the NN again inside
    its epipolar band."""

    def local(images0, images1, K0, K1, F_prior=None, prior_ok=None):
        with torch.inference_mode():
            feats0 = _extract(extractor, images0, extract_chunk)
            feats1 = _extract(extractor, images1, extract_chunk)
            matches0, mscores0 = nn_fn(feats0["descriptors"],
                                       feats1["descriptors"],
                                       feats0["mask"], feats1["mask"])
            if guided is not None:
                valid, mk0, mk1 = _gather_matched(feats0, feats1, matches0)
                gen = _generator(mk0.device, 1)
                F_est = []
                for b in range(matches0.shape[0]):
                    _R, _t, E, _inl = ransac_essential_pose(
                        gen, mk0[b], mk1[b], K0, K1, valid[b],
                        threshold_px=threshold_px,
                        n_hypotheses=n_hypotheses)
                    F_est.append(torch.linalg.inv(K1).T @ E
                                 @ torch.linalg.inv(K0))
                F = torch.stack(F_est)
                if F_prior is not None and prior_ok is not None:
                    F = torch.where(prior_ok[:, None, None],
                                    F_prior.to(F.dtype), F)
                matches0, mscores0 = _nn_epipolar_band(
                    feats0["descriptors"], feats1["descriptors"],
                    feats0["keypoints"], feats1["keypoints"],
                    feats0["mask"], feats1["mask"], F,
                    float(guided["band"]), float(guided["ratio"]),
                    float(guided["min_sim"]))
            res = _pose_and_triangulate(feats0, feats1, matches0, K0, K1,
                                        n_hypotheses, threshold_px)
        res["mscores0"] = mscores0
        return res

    def step(images0, images1, K0, K1, F_prior=None, prior_ok=None):
        batched = {"images0": images0, "images1": images1}
        if guided is not None and F_prior is not None \
                and prior_ok is not None:
            batched.update(F_prior=torch.as_tensor(F_prior),
                           prior_ok=torch.as_tensor(prior_ok))
        return _over_mesh(mesh, local, batched, _intrinsics(K0, K1))

    return step
