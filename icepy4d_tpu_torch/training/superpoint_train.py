"""Self-training SuperPoint on synthetic geometry (counterpart of
`icepy4d_tpu/training/superpoint_train.py`, the MagicPoint stage of
DeTone et al. 2018 §5).

The detector head learns the 65-way cell classification against
rendered corners, the descriptor head a hinge loss over cell
correspondences induced by random homographies. One step runs both
views forward, the cross-entropy and the hinge, a backward and an Adam
update (`training/_optim.py`); the rendered batches are uploaded once
and cycled on the device.

The port's tensors are NCHW: the logits' class axis is dim 1 where the
JAX package has it last.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.models.superpoint import SuperPointNet
from icepy4d_tpu_torch.ops.nms import simple_nms
from icepy4d_tpu_torch.training._optim import Adam, superpoint_optimizer
from icepy4d_tpu_torch.training.synthetic import (_warp, corners_to_cells,
                                                  load_real_patch_pool,
                                                  make_pair_batch,
                                                  make_real_pair_batch,
                                                  random_homography)


def detector_loss(logits: torch.Tensor, labels: torch.Tensor,
                  pos_weight: float = 8.0) -> torch.Tensor:
    """65-way cell cross-entropy, corner cells up-weighted (the dustbin
    dominates the grid). logits (B, 65, Hc, Wc), labels (B, Hc, Wc)."""
    logp = torch.log_softmax(logits, dim=1)
    ll = torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    w = torch.where(labels < 64, pos_weight, 1.0)
    return -(w * ll).sum() / w.sum()


def _cell_centers(hc: int, wc: int, device) -> torch.Tensor:
    ys, xs = torch.meshgrid(torch.arange(hc, device=device),
                            torch.arange(wc, device=device), indexing="ij")
    return torch.stack([xs * 8 + 4, ys * 8 + 4], -1).reshape(-1, 2).float()


def descriptor_loss(dA: torch.Tensor, dB: torch.Tensor, H: torch.Tensor,
                    hc: int, wc: int, pos_margin: float = 1.0,
                    neg_margin: float = 0.2,
                    lambda_d: float = 250.0) -> torch.Tensor:
    """SuperPoint hinge loss over cell correspondences.

    dA / dB (..., hc*wc, D) L2-normalised, cells in row-major order; H
    (..., 3, 3) maps image-A pixels to B. A leading batch axis gives the
    mean over the pairs of each pair's loss."""
    centers = _cell_centers(hc, wc, dA.device)              # (L, 2)
    ones = torch.ones_like(centers[:, :1])
    pA = torch.cat([centers, ones], -1) @ H.transpose(-1, -2)   # (..., L, 3)
    z = pA[..., 2:]
    pA = pA[..., :2] / torch.where(z.abs() < 1e-9, 1e-9, z)
    d2 = ((pA[..., :, None, :] - centers) ** 2).sum(-1)    # (..., L, L)
    s = (d2 <= 64.0).to(dA.dtype)                           # within 8 px
    sim = dA @ dB.transpose(-1, -2)
    pos = s * torch.clamp_min(pos_margin - sim, 0.0)
    neg = (1.0 - s) * torch.clamp_min(sim - neg_margin, 0.0)
    return (lambda_d * pos + neg).mean()


def superpoint_loss(net: SuperPointNet, imgs: torch.Tensor,
                    warped: torch.Tensor, Hs: torch.Tensor,
                    labels: torch.Tensor, det_w=1.0,
                    desc_weight: float = 1.0) -> tuple[torch.Tensor, dict]:
    """(loss, metrics) of one batch: det_w * detector CE on view A plus
    desc_weight * the hinge over the pairs."""
    logitsA, descA = net(imgs[:, None], raw=True)
    _, descB = net(warped[:, None], raw=True)
    l_det = det_w * detector_loss(logitsA, labels)
    b, d, hc, wc = descA.shape
    l_desc = descriptor_loss(descA.reshape(b, d, -1).transpose(1, 2),
                             descB.reshape(b, d, -1).transpose(1, 2),
                             Hs, hc, wc)
    loss = l_det + desc_weight * l_desc
    return loss, {"loss": loss.detach(), "det": l_det.detach(),
                  "desc": l_desc.detach()}


def make_train_step(net: SuperPointNet, opt: Adam,
                    desc_weight: float = 1.0):
    """train_step(imgs, warped, Hs, labels[, det_w]) -> metrics: one
    forward, backward and update of `net`'s parameters in place.

    det_w (scalar or 0-d tensor, default 1.0) masks the detector loss:
    real-image descriptor batches carry all-dustbin placeholders that
    must not teach "no corners on real imagery". The gradients of the
    step stay in the parameters' `.grad` until the next step."""

    def train_step(imgs, warped, Hs, labels, det_w=1.0):
        opt.zero_grad()
        loss, metrics = superpoint_loss(net, imgs, warped, Hs, labels,
                                        det_w, desc_weight)
        loss.backward()
        opt.step()
        return metrics

    return train_step


def lecun_normal_init(module: torch.nn.Module, seed: int) -> None:
    """Flax's default initialisation, which the JAX package's fresh
    inits use: every conv and dense weight from a normal truncated at 2
    sigma with variance 1 / fan_in, biases zero (numbers from a torch
    generator, so not the JAX package's)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if not isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                continue
            w = m.weight
            fan_in = w[0].numel()
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            t = torch.empty(w.shape).normal_(generator=gen)
            while (bad := t.abs() > 2).any():   # resample past 2 sigma
                t[bad] = torch.empty(int(bad.sum())).normal_(generator=gen)
            w.copy_(t * std)
            if m.bias is not None:
                m.bias.zero_()


def train_superpoint(
    steps: int = 4000,
    batch: int = 32,
    h: int = 120,
    w: int = 160,
    lr: float = 1e-3,
    seed: int = 0,
    n_cached_batches: int = 256,
    desc_weight: float = 1.0,
    log_every: int = 200,
    params=None,
    scan_chunk: int = 250,
    real_image_dir=None,
    real_fraction: float = 0.5,
    real_labeled=None,
    device=None,
):
    """Train and return (state_dict, history).

    The rendered batches are made on the host from
    `np.random.default_rng(seed)` in the JAX package's order, uploaded
    once and cycled: step k takes batch (start + k) % n_cached_batches.
    Losses stay on the device and are read once per `scan_chunk` steps,
    which is one history entry {step, loss, chunk_mean}.

    params: a SuperPointNet state dict to start from (None: a fresh
    `lecun_normal_init` from `seed`). real_image_dir: `real_fraction`
    of the cached batches are warped real-image patches that train the
    descriptor only (det_w = 0). real_labeled: (imgs (N, h, w), labels
    (N, h/8, w/8)) from `homographic_adaptation`; real batches then
    train the detector too on those pseudo-labels."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    net = SuperPointNet()
    if params is None:
        lecun_normal_init(net, seed)
    else:
        net.load_state_dict(params)
    net.to(dev).train()
    opt = superpoint_optimizer(net.parameters(), lr)
    step_fn = make_train_step(net, opt, desc_weight)

    def labeled_real_batch():
        imgs_l, labels_l = real_labeled
        idx = rng.integers(0, len(imgs_l), batch)
        imgs_b = imgs_l[idx]
        labels_b = labels_l[idx]
        warped_b = np.empty_like(imgs_b)
        Hs_b = np.empty((batch, 3, 3), np.float32)
        for t in range(batch):
            Hb = random_homography(rng, h, w, strength=0.1)
            warped_b[t] = _warp(imgs_b[t], Hb, w, h)
            Hs_b[t] = Hb
        return imgs_b, warped_b, Hs_b, labels_b

    host, det_ws = [], []
    use_real = real_image_dir is not None or real_labeled is not None
    if real_image_dir is not None and real_labeled is None:
        pool = load_real_patch_pool(real_image_dir)
    for _ in range(n_cached_batches):
        is_real = use_real and rng.uniform() < real_fraction
        if is_real and real_labeled is not None:
            host.append(labeled_real_batch())
            det_ws.append(1.0)   # pseudo-labels train the detector too
        elif is_real:
            host.append(make_real_pair_batch(rng, pool, batch, h, w))
            det_ws.append(0.0)
        else:
            host.append(make_pair_batch(rng, batch, h, w))
            det_ws.append(1.0)
    data = [torch.from_numpy(np.stack([b[i] for b in host])).to(dev)
            for i in range(4)]
    det_w = torch.tensor(det_ws, dtype=torch.float32, device=dev)
    del host

    history = []
    done = 0
    while done < steps:
        n = min(scan_chunk, steps - done)
        losses = []
        for k in range(n):
            i = (done + k) % n_cached_batches
            metrics = step_fn(*(a[i] for a in data), det_w[i])
            losses.append(metrics["loss"])
        losses = torch.stack(losses).cpu().numpy()
        history.append({"step": done + n - 1,
                        "loss": float(losses[-1]),
                        "chunk_mean": float(losses.mean())})
        print(f"step {done + n - 1:6d}  loss {losses[-1]:.4f}  "
              f"(chunk mean {losses.mean():.4f})", flush=True)
        done += n
    net.eval()
    return {k: v.detach().clone() for k, v in net.state_dict().items()}, \
        history


def homographic_adaptation(
    params,
    pool,
    rng,
    n_patches: int = 256,
    n_warps: int = 24,
    h: int = 120,
    w: int = 160,
    nms_radius: int = 4,
    detect_threshold: float = 0.015,
    max_corners: int = 120,
    device=None,
):
    """Pseudo-label real patches by warp-aggregated detection
    (SuperPoint §6 "Homographic Adaptation").

    For each patch: the detector of `params` (a SuperPointNet state
    dict) runs on n_warps random homographies of it (the first the
    identity), the heat maps are warped back and averaged, and the
    plain `simple_nms` keeps the aggregated maxima above
    detect_threshold (at most max_corners) as detector labels. Returns
    (imgs (N, h, w), labels (N, h/8, w/8))."""
    import cv2

    dev = resolve_device(device)
    net = SuperPointNet()
    net.load_state_dict(params)
    net.to(dev).eval()

    imgs_out = np.empty((n_patches, h, w), np.float32)
    labels_out = np.empty((n_patches, h // 8, w // 8), np.int32)
    for i in range(n_patches):
        src = pool[int(rng.integers(len(pool)))]
        sh, sw = src.shape
        y0 = int(rng.integers(0, max(sh - h, 1)))
        x0 = int(rng.integers(0, max(sw - w, 1)))
        patch = src[y0:y0 + h, x0:x0 + w]
        if patch.shape != (h, w):
            patch = cv2.resize(patch, (w, h))
        patch = patch.astype(np.float32)

        warps = [np.eye(3, dtype=np.float32)] + [
            random_homography(rng, h, w, strength=0.12)
            for _ in range(n_warps - 1)]
        warped = np.stack([_warp(patch, H, w, h) for H in warps])
        with torch.inference_mode():
            heats, _ = net(torch.from_numpy(warped).to(dev)[:, None])
        heats = heats.cpu().numpy()
        acc = np.zeros((h, w), np.float32)
        cnt = np.zeros((h, w), np.float32)
        for H, heat in zip(warps, heats):
            Hinv = np.linalg.inv(H).astype(np.float32)
            acc += cv2.warpPerspective(heat, Hinv, (w, h),
                                       flags=cv2.INTER_LINEAR)
            cnt += cv2.warpPerspective(np.ones_like(heat), Hinv, (w, h),
                                       flags=cv2.INTER_NEAREST)
        agg = acc / np.maximum(cnt, 1.0)
        nms = simple_nms(torch.from_numpy(agg)[None], nms_radius)[0].numpy()
        ys, xs = np.where(nms > detect_threshold)
        if len(ys) > max_corners:
            top = np.argsort(nms[ys, xs])[::-1][:max_corners]
            ys, xs = ys[top], xs[top]
        corners = np.stack([xs, ys], -1).astype(np.float32) \
            if len(ys) else np.zeros((0, 2), np.float32)
        imgs_out[i] = patch
        labels_out[i] = corners_to_cells(corners, h, w)
    return imgs_out, labels_out
