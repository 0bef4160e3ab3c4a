"""Self-training the ALIKED-style extractor (counterpart of
`icepy4d_tpu/training/aliked_train.py`).

Synthetic shapes with known corners bootstrap the score map, and
homography-related pairs (synthetic and real patches,
`training/synthetic.py`) supervise the descriptors and the score's
repeatability. Losses per pair (H maps image-A pixels to image-B
pixels):
  * detection BCE against the binary corner map of the synthetic
    65-way cell labels (real patches carry none: weight 0);
  * repeatability: squared difference of score A at A's peaks and
    score B at their warped positions (in bounds only);
  * descriptor InfoNCE: SDDH descriptors at A's top-K peaks against
    those at the warped positions in B, symmetric cross-entropy over
    the K-way similarities at temperature tau.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from icepy4d_tpu_torch.models.aliked import ALIKED
from icepy4d_tpu_torch.models.superpoint import _topk_peaks
from icepy4d_tpu_torch.ops.image import bilinear_sample_batched
from icepy4d_tpu_torch.ops.nms import simple_nms
from icepy4d_tpu_torch.training._optim import Adam, aliked_optimizer
from icepy4d_tpu_torch.training.synthetic import (make_pair_batch,
                                                  make_real_pair_batch)


def warp_points(kpts: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """(..., K, 2) xy pixels through (..., 3, 3) homographies."""
    ones = torch.ones_like(kpts[..., :1])
    p = torch.cat([kpts, ones], -1) @ H.transpose(-1, -2)
    z = p[..., 2:]
    return p[..., :2] / torch.where(z.abs() < 1e-9, 1e-9, z)


def labels_to_heatmap(labels: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """65-way cell labels (B, h/8, w/8) -> binary corner map (B, h, w)
    (64 = no corner, else dy * 8 + dx inside the cell)."""
    b, hc, wc = labels.shape
    onehot = F.one_hot(labels.long(), 65)[..., :64].float()
    grid = onehot.reshape(b, hc, wc, 8, 8).permute(0, 1, 3, 2, 4)
    return grid.reshape(b, hc * 8, wc * 8)[:, :h, :w]


def _detect_peaks(score: torch.Tensor, k: int,
                  nms_radius: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-K peaks of the plain `simple_nms` of (B, H, W), an 8-px border
    zeroed -> (kpts (B, K, 2) xy, valid (B, K))."""
    heat = simple_nms(score, nms_radius)
    h, w = score.shape[1:]
    ys = torch.arange(h, device=score.device)
    xs = torch.arange(w, device=score.device)
    border = ((ys < 8) | (ys >= h - 8))[:, None] \
        | ((xs < 8) | (xs >= w - 8))[None, :]
    sc, kpts = _topk_peaks(torch.where(border, 0.0, heat), k, nms_radius)
    return kpts, sc > 0.0


def aliked_loss(model: ALIKED, imgs, warped, Hs, labels, det_w,
                n_peaks: int = 128, tau: float = 0.07,
                det_weight: float = 1.0, rep_weight: float = 1.0,
                desc_weight: float = 1.0,
                detect_fn=_detect_peaks) -> torch.Tensor:
    """The weighted sum of the three losses over a batch of pairs.

    detect_fn(score, k, nms_radius) -> (kpts, valid) finds the
    supervision anchors on view A's detached score map."""
    net, sddh = model.model.net, model.model.sddh
    b, h, w = imgs.shape
    sA, fA = net(imgs[:, None])
    sB, fB = net(warped[:, None])

    # detection BCE on the synthetic corner map
    y = labels_to_heatmap(labels, h, w)
    pos_w = (h * w) / y.sum((1, 2), keepdim=True).clamp_min(1.0)
    eps = 1e-6
    bce = -(pos_w * y * torch.log(sA + eps)
            + (1.0 - y) * torch.log(1.0 - sA + eps))
    l_det = (det_w[:, None, None] * bce).mean()

    # peaks of A: supervision anchors, not gradient paths
    kA, vA = detect_fn(sA.detach(), n_peaks, model.nms_radius)
    kB = warp_points(kA, Hs)                              # (B, K, 2)
    inb = (kB[..., 0] >= 8) & (kB[..., 0] < w - 8) \
        & (kB[..., 1] >= 8) & (kB[..., 1] < h - 8) & vA
    inb_f = inb.float()
    n_inb = inb_f.sum().clamp_min(1.0)

    rep = (bilinear_sample_batched(sA, kA)
           - bilinear_sample_batched(sB, kB)) ** 2
    l_rep = (rep * inb_f).sum() / n_inb

    # descriptor InfoNCE over the K-way in-pair similarities
    dA = sddh(fA, kA)                                     # (B, K, D)
    dB = sddh(fB, kB)
    sim = dA @ dB.transpose(1, 2) / tau
    simm = torch.where(inb[:, None, :], sim, -1e9)
    simm = torch.where(inb[:, :, None], simm, -1e9)
    logp_ab = torch.log_softmax(simm, -1).diagonal(dim1=1, dim2=2)
    logp_ba = torch.log_softmax(simm, -2).diagonal(dim1=1, dim2=2)
    nce = -(logp_ab + logp_ba) * 0.5
    l_desc = (nce * inb_f).sum() / n_inb
    return det_weight * l_det + rep_weight * l_rep + desc_weight * l_desc


def make_train_step(model: ALIKED, opt: Adam, n_peaks: int = 128,
                    tau: float = 0.07, det_weight: float = 1.0,
                    rep_weight: float = 1.0, desc_weight: float = 1.0,
                    detect_fn=_detect_peaks):
    """train_step(imgs, warped, Hs, labels, det_w) -> loss (detached):
    one forward, backward and update of model.model's parameters in
    place. det_w (B,) zeroes the detection BCE of unlabelled pairs;
    detect_fn is `aliked_loss`'s."""

    def train_step(imgs, warped, Hs, labels, det_w):
        opt.zero_grad()
        loss = aliked_loss(model, imgs, warped, Hs, labels, det_w, n_peaks,
                           tau, det_weight, rep_weight, desc_weight,
                           detect_fn)
        loss.backward()
        opt.step()
        return loss.detach()

    return train_step


def train_aliked(
    model: ALIKED,
    params,
    steps: int = 2000,
    batch: int = 16,
    h: int = 240,
    w: int = 320,
    lr: float = 3e-4,
    seed: int = 0,
    n_batches: int = 64,
    real_pool=None,
    real_fraction: float = 0.5,
    scan_chunk: int = 100,
    log=print,
):
    """Train `model` (an `ALIKED` extractor) in place on n_batches
    cached pair batches and return its ALIKEDModel state dict.

    params: a state dict to start from, or None for the model's
    current weights. adamw (decay 1e-4) behind a global-norm clip of
    1.0, the learning rate cosine-decayed from lr to 0 over `steps`;
    step k takes batch k % n_batches. scan_chunk <= 1 logs every 100
    steps and the last, else the mean loss every scan_chunk steps."""
    dev = model.device
    module = model.model
    if params is not None:
        module.load_state_dict(params)
    rng = np.random.default_rng(seed)
    host = {"imgs": [], "warped": [], "Hs": [], "labels": [], "detw": []}
    for _ in range(n_batches):
        if real_pool is not None and rng.uniform() < real_fraction:
            imgs, warped, Hs, labels = make_real_pair_batch(
                rng, real_pool, batch, h, w)
            detw = np.zeros(batch, np.float32)
        else:
            imgs, warped, Hs, labels = make_pair_batch(rng, batch, h, w)
            detw = np.ones(batch, np.float32)
        for k, v in zip(host, (imgs, warped, Hs, labels, detw)):
            host[k].append(v)
    data = [torch.from_numpy(np.stack(v)).to(dev) for v in host.values()]
    del host

    opt = aliked_optimizer(module.parameters(), lr, steps)
    step_fn = make_train_step(model, opt)
    losses = []
    for k in range(steps):
        loss = step_fn(*(a[k % n_batches] for a in data))
        if scan_chunk <= 1:
            if (k + 1) % 100 == 0 or k + 1 == steps:
                log(f"step {k + 1}/{steps} loss {float(loss):.4f}")
            continue
        losses.append(loss)
        if len(losses) == scan_chunk or k + 1 == steps:
            log(f"step {k + 1}/{steps} loss "
                f"{float(torch.stack(losses).mean()):.4f}")
            losses = []
    return {k: v.detach().clone() for k, v in module.state_dict().items()}
