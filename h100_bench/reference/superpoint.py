"""Plain SuperPoint: detector and descriptor of magicleap's
SuperPointPretrainedNetwork (DeTone et al., 2018), as cvg/LightGlue
bundles it.

  VGG encoder: 3x3 convs 64-64 | pool | 64-64 | pool | 128-128 | pool |
  128-128, ReLU after each
  detector: 3x3 conv 256, 1x1 conv 65, softmax, 8x8 cells to pixels
  NMS (five (2r+1)^2 max-pools, two suppression rounds), border zeroed,
  top-K over the whole map, score threshold
  descriptor: 3x3 conv 256, 1x1 conv D, L2 norm, bilinear at the
  keypoints, L2 norm

Weights come as a tree {name: {"kernel" (kh, kw, cin, cout), "bias"}}.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from h100_bench import flops as counts
from h100_bench.reference.precision import round_to

CONVS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
         "conv4a", "conv4b")


def _conv(x, w: dict, precision: str) -> torch.Tensor:
    k = w["kernel"]
    return F.conv2d(round_to(x, precision),
                    round_to(k.permute(3, 2, 0, 1), precision), w["bias"],
                    padding=k.shape[0] // 2)


def dense_maps(tree: dict, images: torch.Tensor, precision: str = "f32"):
    """images (B, H, W) in [0, 1], sides multiples of 8 -> (heat (B, H, W),
    descriptors (B, D, H/8, W/8), L2-normalised)."""
    x = images[:, None].float()
    for i, name in enumerate(CONVS):
        x = F.relu(_conv(x, tree[name], precision))
        if i in (1, 3, 5):
            x = F.max_pool2d(x, 2, 2)
    logits = _conv(F.relu(_conv(x, tree["convPa"], precision)),
                   tree["convPb"], precision)
    desc = _conv(F.relu(_conv(x, tree["convDa"], precision)),
                 tree["convDb"], precision)
    desc = desc / desc.norm(dim=1, keepdim=True).clamp_min(1e-12)
    heat = F.pixel_shuffle(torch.softmax(logits, 1)[:, :64], 8)[:, 0]
    return heat, desc


def nms(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """Max-pool NMS with two suppression rounds; pools pad with -inf."""
    def pool(x):
        return F.max_pool2d(x[:, None], 2 * radius + 1, stride=1,
                            padding=radius)[:, 0]

    zeros = torch.zeros_like(scores)
    keep = scores == pool(scores)
    for _ in range(2):
        supp = pool(keep.float()) > 0
        supp_scores = torch.where(supp, zeros, scores)
        keep = keep | ((supp_scores == pool(supp_scores)) & ~supp)
    return torch.where(keep, scores, zeros)


def sample(desc: torch.Tensor, kpts: torch.Tensor, s: int = 8) -> torch.Tensor:
    """desc (D, Hc, Wc), kpts (K, 2) pixel xy -> (K, D), L2-normalised.
    Keypoint centres map to the descriptor grid as torch's grid_sample
    with align_corners=True maps them after SuperPoint's normalisation;
    taps outside the grid read 0."""
    _, hc, wc = desc.shape
    x = (kpts[:, 0] - s / 2 + 0.5) / (wc * s - s / 2 - 0.5) * (wc - 1)
    y = (kpts[:, 1] - s / 2 + 0.5) / (hc * s - s / 2 - 0.5) * (hc - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    out = 0.0
    for dx, dy, wgt in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                        (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        xi, yi = (x0 + dx).long(), (y0 + dy).long()
        ok = ((xi >= 0) & (xi < wc) & (yi >= 0) & (yi < hc))[:, None]
        v = desc[:, yi.clamp(0, hc - 1), xi.clamp(0, wc - 1)].T
        out = out + torch.where(ok, v, 0.0) * wgt
    return out / out.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def extract(tree: dict, images: torch.Tensor, max_keypoints: int,
            threshold: float, nms_radius: int, border: int = 4,
            precision: str = "f32") -> dict:
    """images (B, H, W) -> keypoints (B, K, 2) xy, scores (B, K),
    descriptors (B, K, D) and mask (B, K): the K highest peaks, masked
    where the score is not above `threshold`."""
    heat, desc = dense_maps(tree, images, precision)
    heat = nms(heat, nms_radius)
    b, h, w = heat.shape
    ys, xs = torch.arange(h, device=heat.device), torch.arange(w,
                                                               device=heat.device)
    frame = ((ys < border) | (ys >= h - border))[:, None] \
        | ((xs < border) | (xs >= w - border))[None]
    heat = torch.where(frame, 0.0, heat)
    scores, idx = heat.reshape(b, -1).topk(min(max_keypoints, h * w), dim=1)
    kpts = torch.stack([idx % w, idx // w], -1).float()
    mask = scores > threshold
    d = torch.stack([sample(desc[i], kpts[i]) for i in range(b)])
    return {"keypoints": kpts, "scores": torch.where(mask, scores, 0.0),
            "descriptors": torch.where(mask[..., None], d, 0.0),
            "mask": mask}


def flops(cfg: dict, h: int, w: int) -> float:
    """Convolution FLOPs of one frame of (h, w), sides multiples of 8:
    the encoder's 3x3 convolutions at full, 1/2, 1/4 and 1/8 size, both
    heads at 1/8."""
    c1, c2, c3, c4 = cfg["channels"]
    head, dd = cfg["head_dim"], cfg["descriptor_dim"]
    total = 0.0
    cin = 1
    for i, c in enumerate((c1, c1, c2, c2, c3, c3, c4, c4)):
        s = 2 ** (i // 2)
        total += counts.conv(h // s, w // s, cin, c, 3)
        cin = c
    h8, w8 = h // 8, w // 8
    total += counts.conv(h8, w8, c4, head, 3) + counts.conv(h8, w8, head, 65, 1)
    total += counts.conv(h8, w8, c4, head, 3) + counts.conv(h8, w8, head, dd, 1)
    return total
