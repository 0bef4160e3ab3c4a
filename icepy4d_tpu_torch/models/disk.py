"""DISK detector / descriptor in PyTorch (counterpart of
`icepy4d_tpu/models/disk.py`, the original DISK thin U-Net).

  input: RGB (3 channels); grayscale is replicated
  down path [16, 32, 64, 64, 64] (the first block at full resolution,
            then a 2x2 average pool before each)
  up path   [64, 64, 64, 129]   (nearest 2x upsample, concat the skip)
  block: InstanceNorm (no affine) -> per-channel PReLU -> 5x5 conv; the
         first down block is a bare conv
  head: channels [0:128] dense descriptors, channel 128 the heat map

Inference: local-max NMS in a window on the heat map (a max-pool, plain
PyTorch as in the JAX package, which runs it as an XLA program), score
threshold, top-K; descriptors read at the keypoint pixel and
L2-normalised; scores are the raw heat values. Outputs are padded to K
with a validity mask.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.ops.topk import safe_top_k

DOWN_DIMS = (16, 32, 64, 64, 64)
UP_DIMS = (64, 64, 64, 129)


class _Block(nn.Module):
    """5x5 conv with bias, preceded (when `gated`) by instance norm and a
    per-channel PReLU over the input channels."""

    def __init__(self, cin: int, cout: int, gated: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, 5, 5))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.alpha = nn.Parameter(torch.full((cin,), 0.25)) if gated \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.alpha is not None:
            mu = x.mean((2, 3), keepdim=True)
            var = x.var((2, 3), unbiased=False, keepdim=True)
            x = (x - mu) * torch.rsqrt(var + 1e-5)
            x = torch.where(x >= 0, x, self.alpha[:, None, None] * x)
        return F.conv2d(x, self.weight, self.bias, padding=2)


class DISKNet(nn.Module):
    """The U-Net: (B, 3, H, W), H and W multiples of 16 ->
    (B, 129, H, W)."""

    def __init__(self):
        super().__init__()
        self.down = nn.ModuleList()
        cin = 3
        for i, c in enumerate(DOWN_DIMS):
            self.down.append(_Block(cin, c, gated=i > 0))
            cin = c
        self.up = nn.ModuleList()
        bot = DOWN_DIMS[-1]
        for skip, c in zip(DOWN_DIMS[-2::-1], UP_DIMS):
            self.up.append(_Block(bot + skip, c))
            bot = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i, blk in enumerate(self.down):
            if i > 0:
                x = F.avg_pool2d(x, 2)
            x = blk(x)
            skips.append(x)
        for i, blk in enumerate(self.up):
            x = torch.repeat_interleave(torch.repeat_interleave(
                x, 2, dim=2), 2, dim=3)
            x = blk(torch.cat([x, skips[-(i + 2)]], 1))
        return x


def nms_window_mask(heat: torch.Tensor, window: int) -> torch.Tensor:
    """True where heat (B, H, W) equals the max over a window x window
    neighbourhood (out-of-map cells count as -inf)."""
    local_max = F.max_pool2d(heat[:, None], window, stride=1,
                             padding=window // 2)[:, 0]
    return heat == local_max


def disk_tree(seed: int = 0) -> dict:
    """Random parameters in the JAX layout (HWIO kernels), fan-in scaled
    normals from numpy's default_rng(seed); PReLU slopes 0.25."""
    rng = np.random.default_rng(seed)

    def block(cin, cout, gated=True):
        p = {"w": (rng.normal(size=(5, 5, cin, cout)) / np.sqrt(25 * cin)
                   ).astype(np.float32),
             "b": np.zeros((cout,), np.float32)}
        if gated:
            p["alpha"] = np.full((cin,), 0.25, np.float32)
        return p

    down, cin = [], 3
    for i, c in enumerate(DOWN_DIMS):
        down.append(block(cin, c, gated=i > 0))
        cin = c
    up, bot = [], DOWN_DIMS[-1]
    for skip, c in zip(DOWN_DIMS[-2::-1], UP_DIMS):
        up.append(block(bot + skip, c))
        bot = c
    return {"down": down, "up": up}


class DISK:
    """Extractor with a static top-K output.

    extract(images (B,H,W) gray or (B,H,W,3)) -> dict(keypoints (B,K,2)
    xy px, scores (B,K) raw heat, descriptors (B,K,128) L2-normalised,
    mask (B,K)).
    """

    def __init__(self, max_keypoints: int = 2048, nms_window_size: int = 5,
                 detection_threshold: float = 0.0, descriptor_dim: int = 128,
                 nms_radius: int | None = None, device=None):
        self.max_keypoints = int(max_keypoints)
        self.nms_window_size = int(2 * nms_radius + 1 if nms_radius
                                   else nms_window_size)
        self.detection_threshold = float(detection_threshold)
        self.descriptor_dim = int(descriptor_dim)
        self.device = resolve_device(device)
        self.net = DISKNet().to(self.device).eval()

    def load_state_dict(self, state_dict: dict) -> "DISK":
        self.net.load_state_dict(state_dict)
        return self

    @torch.inference_mode()
    def extract(self, images: torch.Tensor) -> dict:
        return self._extract(images.to(self.device))

    def _extract(self, images: torch.Tensor) -> dict:
        images = images.float()
        if images.ndim == 3:
            images = images[..., None]
        images = images.expand(*images.shape[:3], 3)
        b, h0, w0, _ = images.shape
        x = F.pad(images.permute(0, 3, 1, 2), (0, (-w0) % 16, 0, (-h0) % 16))
        out = self.net(x)
        desc = out[:, : self.descriptor_dim]
        heat = out[:, self.descriptor_dim]
        h, w = heat.shape[1:]

        keep = nms_window_mask(heat, self.nms_window_size)
        ys = torch.arange(h, device=heat.device)
        xs = torch.arange(w, device=heat.device)
        inside = (ys < h0)[:, None] & (xs < w0)[None, :]
        score = torch.where(keep & inside & (heat > self.detection_threshold),
                            heat, float("-inf"))
        k = min(self.max_keypoints, h * w)
        scores, idx = safe_top_k(score.reshape(b, -1), k)
        mask = torch.isfinite(scores)
        kpts = torch.stack([idx % w, idx // w], -1).float()
        d = torch.gather(desc.flatten(2), 2,
                         idx[:, None].expand(-1, self.descriptor_dim, -1))
        d = d.transpose(1, 2)
        d = d / d.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return {"keypoints": torch.where(mask[..., None], kpts, 0.0),
                "scores": torch.where(mask, scores, 0.0),
                "descriptors": torch.where(mask[..., None], d, 0.0),
                "mask": mask}
