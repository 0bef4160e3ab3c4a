"""ALIKED-style extractor in PyTorch (counterpart of
`icepy4d_tpu/models/aliked.py`): a multi-scale backbone and the sparse
deformable descriptor head.

This is the repository's own, self-trained model (extractor "aliked",
`weights/aliked_synthetic.npz`), which follows the ALIKED paper in
spirit and not the published network: its stages run at 1, 1/2, 1/4 and
1/8, it has no batch norms and no deformable convolutions, and its SDDH
is an MLP over a 5x5 patch. The published ALIKED-n16 is
`models/aliked_n16.py` (extractor "aliked_n16").

  * 4-stage conv backbone (1, 1/2, 1/4, 1/8 resolution), each stage
    1x1-projected and bilinearly upsampled to full resolution,
    concatenated into one dense feature map;
  * score-map head, max-pool NMS (plain PyTorch, as the JAX package's
    `simple_nms` is an XLA program), border removal, static top-K and a
    3x3 soft-argmax for sub-pixel keypoints;
  * SDDH: per keypoint a small MLP over the 5x5 feature patch predicts
    M tanh-bounded sample offsets and M softmax mixing weights; the
    descriptor is the mixed bilinear sample of the feature map,
    projected and L2-normalised.

Module names follow the flax tree (`net.block1.c1`, `sddh.off1`, ...),
so `models.convert.aliked_params` loads the bundled
`weights/aliked_synthetic.npz`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.models.superpoint import _topk_peaks
from icepy4d_tpu_torch.ops.image import bilinear_sample_batched
from icepy4d_tpu_torch.ops.nms import simple_nms


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + eps)


class _ConvBlock(nn.Module):
    """conv3x3-SELU x2 with a residual path (1x1-projected on a channel
    change)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.c1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.c2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.proj = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.c2(F.selu(self.c1(x)))
        if self.proj is not None:
            x = self.proj(x)
        return F.selu(x + y)


class ALIKEDNet(nn.Module):
    """Backbone and heads: gray (B, 1, H, W), H and W multiples of 8 ->
    (score (B, H, W), feature map (B, H, W, dim) L2-normalised)."""

    def __init__(self, channels=(16, 32, 64, 128), dim: int = 128):
        super().__init__()
        c1, c2, c3, c4 = channels
        self.block1 = _ConvBlock(1, c1)
        self.block2 = _ConvBlock(c1, c2)
        self.block3 = _ConvBlock(c2, c3)
        self.block4 = _ConvBlock(c3, c4)
        q = dim // 4
        self.agg1, self.agg2 = nn.Conv2d(c1, q, 1), nn.Conv2d(c2, q, 1)
        self.agg3, self.agg4 = nn.Conv2d(c3, q, 1), nn.Conv2d(c4, q, 1)
        self.score1 = nn.Conv2d(dim, 8, 1)
        self.score2 = nn.Conv2d(8, 4, 3, padding=1)
        self.score3 = nn.Conv2d(4, 1, 3, padding=1)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        h, w = x.shape[2:]
        f1 = self.block1(x)
        f2 = self.block2(F.avg_pool2d(f1, 2))
        f3 = self.block3(F.avg_pool2d(f2, 2))
        f4 = self.block4(F.avg_pool2d(f3, 2))
        outs = []
        for agg, f in ((self.agg1, f1), (self.agg2, f2), (self.agg3, f3),
                       (self.agg4, f4)):
            g = agg(f)
            if g.shape[2] != h:
                g = F.interpolate(g, size=(h, w), mode="bilinear",
                                  align_corners=False)
            outs.append(g)
        feat = F.selu(torch.cat(outs, 1))
        s = F.selu(self.score1(feat))
        s = F.selu(self.score2(s))
        score = torch.sigmoid(self.score3(s))[:, 0]
        return score, _l2_normalize(feat.permute(0, 2, 3, 1))


class SDDH(nn.Module):
    """Sparse deformable descriptor head (see the module docstring)."""

    def __init__(self, dim: int = 128, n_samples: int = 16, patch: int = 5,
                 radius: float = 6.0):
        super().__init__()
        self.dim, self.n_samples, self.patch = dim, n_samples, patch
        self.radius = float(radius)
        self.off1 = nn.Linear(patch * patch * dim, 2 * dim)
        self.off2 = nn.Linear(2 * dim, 3 * n_samples)
        self.proj = nn.Linear(dim, dim)

    def forward(self, feat: torch.Tensor, kpts: torch.Tensor) -> torch.Tensor:
        """feat (H, W, D) normalised feature map; kpts (K, 2) xy px ->
        (K, dim) L2-normalised descriptors. A leading batch axis on both,
        (B, H, W, D) and (B, K, 2), gives (B, K, dim): each image's
        descriptors from its own map (the trainer's batched call)."""
        if feat.ndim == 3:
            return self(feat[None], kpts[None])[0]
        b, k = kpts.shape[:2]
        d = feat.shape[-1]
        p, m = self.patch, self.n_samples
        r = (p - 1) / 2.0
        lin = torch.linspace(-r, r, p, device=kpts.device)
        dy, dx = torch.meshgrid(lin, lin, indexing="ij")
        grid = torch.stack([dx.reshape(-1), dy.reshape(-1)], -1)
        patch_xy = kpts[:, :, None, :] + grid                # (B, K, p*p, 2)
        patches = bilinear_sample_batched(feat, patch_xy.reshape(b, -1, 2))
        patches = patches.reshape(b, k, p * p * d)
        raw = self.off2(F.selu(self.off1(patches)))
        offs = torch.tanh(raw[..., : 2 * m].reshape(b, k, m, 2)) * self.radius
        wgt = torch.softmax(raw[..., 2 * m:], dim=-1)        # (B, K, M)
        samples = bilinear_sample_batched(
            feat, (kpts[:, :, None, :] + offs).reshape(b, -1, 2))
        mixed = torch.einsum("bkm,bkmd->bkd", wgt,
                             samples.reshape(b, k, m, d))
        return _l2_normalize(self.proj(mixed))


class ALIKEDModel(nn.Module):
    """The backbone (`net`) and the descriptor head (`sddh`) under the
    flax tree's names."""

    def __init__(self, channels=(16, 32, 64, 128), dim: int = 128,
                 n_samples: int = 16, patch: int = 5,
                 radius: float = 6.0):
        super().__init__()
        self.net = ALIKEDNet(channels, dim)
        self.sddh = SDDH(dim, n_samples, patch, radius)


class ALIKED:
    """Extractor with a static top-K output, the interface of
    `models.superpoint.SuperPoint`.

    extract(images (B,H,W[,1]) gray in [0, 1]) -> dict(keypoints (B,K,2)
    sub-pixel xy, scores, descriptors (B,K,dim), mask). Any H, W: the
    input is zero-padded to the 8-px grid.
    """

    def __init__(self, max_keypoints: int = 2048,
                 detection_threshold: float = 0.2, nms_radius: int = 2,
                 remove_borders: int = 8, channels=(16, 32, 64, 128),
                 descriptor_dim: int = 128, n_samples: int = 16,
                 patch: int = 5, offset_radius: float = 6.0, device=None):
        self.max_keypoints = int(max_keypoints)
        self.detection_threshold = float(detection_threshold)
        self.nms_radius = int(nms_radius)
        self.remove_borders = int(remove_borders)
        self.descriptor_dim = int(descriptor_dim)
        self.device = resolve_device(device)
        self.model = ALIKEDModel(tuple(channels), descriptor_dim, n_samples,
                                 patch, offset_radius).to(self.device).eval()

    def load_state_dict(self, state_dict: dict) -> "ALIKED":
        self.model.load_state_dict(state_dict)
        return self

    @torch.inference_mode()
    def extract(self, images: torch.Tensor) -> dict:
        return self._extract(images.to(self.device))

    def _extract(self, images: torch.Tensor) -> dict:
        if images.ndim == 4:
            images = images[..., 0]
        b, h0, w0 = images.shape
        x = F.pad(images.float(), (0, (-w0) % 8, 0, (-h0) % 8))
        h, w = x.shape[1:]
        score, feat = self.model.net(x[:, None])

        heat = simple_nms(score, self.nms_radius)
        r = max(self.remove_borders, 1)
        ys = torch.arange(h, device=x.device)
        xs = torch.arange(w, device=x.device)
        border = ((ys < r) | (ys >= h0 - r))[:, None] \
            | ((xs < r) | (xs >= w0 - r))[None, :]
        heat = torch.where(border, 0.0, heat)
        scores, kpts = _topk_peaks(heat, self.max_keypoints, self.nms_radius)
        mask = scores > self.detection_threshold

        # sub-pixel: soft-argmax of the raw score over the 3x3
        # neighbourhood of each integer peak
        xi = kpts[..., 0].long()
        yi = kpts[..., 1].long()
        d = torch.arange(-1, 2, device=x.device)
        dy = d.repeat_interleave(3)                      # row-major 3x3
        dx = d.repeat(3)
        yy = (yi[..., None] + dy).clamp(0, h - 1)
        xx = (xi[..., None] + dx).clamp(0, w - 1)
        nv = torch.gather(score.reshape(b, -1), 1,
                          (yy * w + xx).reshape(b, -1)).reshape(yy.shape)
        sm = torch.softmax(nv * 10.0, dim=-1)
        kpts = kpts + torch.stack([(sm * dx.float()).sum(-1),
                                   (sm * dy.float()).sum(-1)], -1)

        desc = self.model.sddh(feat, kpts)
        return {"keypoints": kpts,
                "scores": torch.where(mask, scores, 0.0),
                "descriptors": torch.where(mask[..., None], desc, 0.0),
                "mask": mask}
