"""Published ALIKED-n16 in PyTorch: Zhao et al., "ALIKED: A Lighter
Keypoint and Descriptor Extraction Network via Deformable
Transformation", IEEE TIM 2023 (arXiv:2304.03608); Shiaoming/ALIKED
`nets/aliked.py`, `ALIKED_CFGS["aliked-n16"]`, as vendored in cvg/LightGlue
`lightglue/aliked.py`. Widths c1..c4 = 16, 32, 64, 128, dim 128, K 3,
M 16; SELU is the gate everywhere. (`models/aliked.py` is the
repository's own, self-trained ALIKED-style network, a different one.)

  input        gray replicated to 3 channels in [0, 1], replicate-padded
               (centred) to a multiple of 32 as the published
               `InputPadder`; every map is cropped back to the tile
  block1       ConvBlock(3 -> 16) at 1/1: conv-bn-gate twice
  block2       ResBlock(16 -> 32) at 1/2 after a 2x2 average pool:
               conv-bn-gate, conv-bn, + 1x1 projection (with bias), gate
  block3       ResBlock(32 -> 64) at 1/8 after a 4x4 average pool, both
               3x3 convolutions deformable
  block4       ResBlock(64 -> 128) at 1/32 after another 4x4 pool,
               deformable
  deformable   `offset_conv` (3x3, bias, 18 channels) gives the taps'
               offsets, clamped to +-max(h, w) / 4 of the block's map;
               out[o, p] = sum_c sum_k W[o, c, k] x[c](p + p_k + d_k(p)),
               bilinear, zeros outside, (dy_k, dx_k) = offset[2k],
               offset[2k + 1] (torchvision's `deform_conv2d` layout), no
               modulation mask
  aggregation  gate(1x1 conv, no bias) of each block to 32 channels,
               bilinear (align_corners) up x2, x8, x32, concatenated to
               128 channels
  score head   sigmoid(1x1 128 -> 8, gate, 3x3 8 -> 4, gate, 3x3 4 -> 4,
               gate, 3x3 4 -> 1), no biases
  feature map  the concatenation L2-normalised over channels
  DKD          top-K mode (the published `detection_threshold` <= 0 with
               `max_num_keypoints` K): `simple_nms` at radius 2 and the
               published border zeroing (`ops/nms.py::fused_nms_border`,
               the card's kernel), top-K, soft-argmax over the 5x5 window
               of the raw score, exp((s - max) / 0.1) against the
               published `hw_grid`, and the score read bilinearly at the
               refined point
  SDDH         per keypoint: the 3x3 patch at the integer keypoint
               (`get_patches`, its clamp to [0, w - 1 - 3] included),
               `offset_conv` (3x3 valid 128 -> 32, gate, 1x1 32 -> 32)
               clamped to +-max(h, w) / 4, the first 16 channels x and the
               last 16 y; the map sampled bilinearly (zeros outside) at
               keypoint + offset, gate(`sf_conv` 1x1, no bias), and
               desc = sum_p f_p A_p with `agg_weights` (16, 128, 128),
               L2-normalised

Module and state-dict names are the published ones (`block1.conv1.weight`,
`block3.conv1.offset_conv.weight`, `block3.conv1.regular_conv.weight`,
`conv1`..`conv4`, `score_head.{0,2,4,6}`, `desc_head.offset_conv.{0,2}`,
`desc_head.sf_conv`, `desc_head.agg_weights`), so the published
`aliked-n16.pth` loads unchanged.

Departures from the published code, none of which changes the function:
  * batch norms (eval mode, eps 1e-5) are folded into the convolution
    before them, once a state dict is loaded;
  * the three identical input channels are one channel under block1's
    first convolution with its weights summed over the input channels;
  * a deformable convolution is plain PyTorch: the nine taps gathered
    bilinearly, then one 1x1 convolution over C * 9 channels (the
    published one is torchvision's `deform_conv2d`);
  * DKD runs in top-K mode only (a static K) and leaves out
    `scoredispersity`, which nothing downstream reads; a top-K slot that
    holds no NMS maximum is masked (none at full-size tiles);
  * keypoints stay in pixels, not through the published [-1, 1] round
    trip;
  * the aggregation `einsum` is one batched matrix product.

Every convolution and product runs in float32 with TF32 off (cuDNN
would take TF32 by default): the NMS maxima and the top-K boundary of
the dense score map move with the products' rounding, and at TF32 a
fifth to two fifths of a tile's 4096 keypoints differ from float32's
(random weights, H100); the products are a small part of an extraction,
which the full-resolution passes bound.

With an `AverageTimer` as `ALIKEDN16.timer` (the matcher hands its own),
an extraction records spans under `ALIKEDN16.span_prefix`
(`match.aliked`): `backbone` (blocks 1-4) holding the four `dcn` spans,
`head` (aggregation, upsampling, concatenation, score head,
normalisation), `dkd` and `sddh`, keys `aliked_<stage>`. `counters` (a
dict the matcher hands over and clears each call) adds up what the
extractions did: deformable convolutions run (`dcn`), valid keypoints of
each tile (`keypoints`, a list of device tensors, one an extraction),
SDDH offsets at the clamp (`offsets_clamped`) and `get_patches` patches
that its clamp moved off the keypoint (`patches_clamped`), device
scalars. No span or counter synchronises the device.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from icepy4d_tpu_torch.device import full_f32_matmul, resolve_device
from icepy4d_tpu_torch.models.superpoint import _topk_peaks
from icepy4d_tpu_torch.ops.nms import fused_nms_border

# ALIKED_CFGS["aliked-n16"]: c1, c2, c3, c4, dim, K, M
CHANNELS = (16, 32, 64, 128)
DIM = 128
PATCH = 3
N_POS = 16
BN_EPS = 1e-5
DIVISOR = 32            # the input padder's multiple
RADIUS = 2              # DKD's NMS radius and border
TEMPERATURE = 0.1       # DKD's soft-argmax temperature


class DeformableConv2d(nn.Module):
    """3x3 deformable convolution without a modulation mask."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.offset_conv = nn.Conv2d(cin, 18, 3, padding=1, bias=True)
        self.regular_conv = nn.Conv2d(cin, cout, 3, padding=1, bias=False)


def _conv(cin: int, cout: int, deformable: bool) -> nn.Module:
    return DeformableConv2d(cin, cout) if deformable \
        else nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, cout, False), nn.BatchNorm2d(cout)
        self.conv2, self.bn2 = _conv(cout, cout, False), nn.BatchNorm2d(cout)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, deformable: bool):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, cout, deformable), \
            nn.BatchNorm2d(cout)
        self.conv2, self.bn2 = _conv(cout, cout, deformable), \
            nn.BatchNorm2d(cout)
        self.downsample = nn.Conv2d(cin, cout, 1)


class SDDH(nn.Module):
    def __init__(self, dim: int = DIM, k: int = PATCH, m: int = N_POS):
        super().__init__()
        self.offset_conv = nn.Sequential(
            nn.Conv2d(dim, 2 * m, k, bias=True), nn.SELU(),
            nn.Conv2d(2 * m, 2 * m, 1, bias=True))
        self.sf_conv = nn.Conv2d(dim, dim, 1, bias=False)
        self.agg_weights = nn.Parameter(torch.zeros(m, dim, dim))


class ALIKEDN16Net(nn.Module):
    """The published module tree (parameters only; `ALIKEDN16` runs it)."""

    def __init__(self):
        super().__init__()
        c1, c2, c3, c4 = CHANNELS
        q = DIM // 4
        self.block1 = ConvBlock(3, c1)
        self.block2 = ResBlock(c1, c2, False)
        self.block3 = ResBlock(c2, c3, True)
        self.block4 = ResBlock(c3, c4, True)
        self.conv1 = nn.Conv2d(c1, q, 1, bias=False)
        self.conv2 = nn.Conv2d(c2, q, 1, bias=False)
        self.conv3 = nn.Conv2d(c3, q, 1, bias=False)
        self.conv4 = nn.Conv2d(DIM, q, 1, bias=False)
        self.score_head = nn.Sequential(
            nn.Conv2d(DIM, 8, 1, bias=False), nn.SELU(),
            nn.Conv2d(8, 4, 3, padding=1, bias=False), nn.SELU(),
            nn.Conv2d(4, 4, 3, padding=1, bias=False), nn.SELU(),
            nn.Conv2d(4, 1, 3, padding=1, bias=False))
        self.desc_head = SDDH()


def random_state_dict(seed: int = 0) -> dict:
    """Random weights in the published layout from numpy's
    default_rng(seed): LeCun-normal convolutions, batch norms away from
    the identity, offsets of a few pixels. For runs without a
    checkpoint; none is in the repository."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in ALIKEDN16Net().state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("num_batches_tracked"):
            a = np.zeros(shape, np.int64)
        elif name.endswith("running_var") or (
                ".bn" in name and name.endswith("weight")):
            a = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("running_mean") or name.endswith("bias"):
            a = rng.normal(0.0, 1.0 if "offset_conv" in name else 0.1,
                           shape)
        else:
            fan_in = int(np.prod(shape[1:]))
            a = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        out[name] = torch.as_tensor(np.asarray(a), dtype=t.dtype)
    return out


def load_state_dict_source(source) -> dict:
    """A published-layout state dict from a mapping of names to arrays
    or tensors, an `.npz` of those names, or a torch checkpoint
    (`aliked-n16.pth`)."""
    if isinstance(source, dict):
        items = source.items()
    elif str(source).endswith(".npz"):
        with np.load(source) as data:
            items = [(k, data[k]) for k in data.files]
    else:
        sd = torch.load(source, map_location="cpu", weights_only=True)
        items = sd.get("state_dict", sd).items()
    return {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
            else v for k, v in items}


def _bilinear(src: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
              h: int, w: int, oy: int = 0, ox: int = 0) -> torch.Tensor:
    """Bilinear samples of the h x w window at (oy, ox) of src (B, C, Hs,
    Ws), zeros outside the window (grid_sample's zeros padding with
    align_corners), at window pixel positions py, px (B, ...) ->
    (B, C, prod(...))."""
    b, c, hs, ws = src.shape
    flat = src.reshape(b, c, hs * ws)
    py, px = py.reshape(b, 1, -1), px.reshape(b, 1, -1)
    y0, x0 = torch.floor(py), torch.floor(px)
    fy, fx = py - y0, px - x0
    y0, x0 = y0.long(), x0.long()
    out = None
    for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                        (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yi, xi = y0 + dy, x0 + dx
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) + oy) * ws + xi.clamp(0, w - 1) + ox
        v = torch.gather(flat, 2, idx.expand(b, c, idx.shape[-1]))
        term = v * torch.where(valid, wgt, 0.0)
        out = term if out is None else out.add_(term)
    return out


def deform_conv3x3(x: torch.Tensor, offset: torch.Tensor,
                   weight: torch.Tensor, bias=None) -> torch.Tensor:
    """3x3 deformable convolution, padding 1, no mask: x (B, C, H, W),
    offset (B, 18, H, W) as (dy, dx) a tap in row-major tap order,
    weight (O, C, 3, 3) -> (B, O, H, W). The nine taps are read
    bilinearly (zeros outside the map) into (B, C * 9, H, W), then one
    1x1 convolution takes the product."""
    b, c, h, w = x.shape
    d = torch.arange(-1, 2, device=x.device, dtype=torch.float32)
    ky, kx = d.repeat_interleave(3), d.repeat(3)
    ys = torch.arange(h, device=x.device, dtype=torch.float32)
    xs = torch.arange(w, device=x.device, dtype=torch.float32)
    py = ys[None, None, :, None] + ky[None, :, None, None] + offset[:, 0::2]
    px = xs[None, None, None, :] + kx[None, :, None, None] + offset[:, 1::2]
    taps = _bilinear(x, py, px, h, w).reshape(b, c * 9, h, w)
    return F.conv2d(taps, weight.reshape(weight.shape[0], c * 9, 1, 1), bias)


class ALIKEDN16:
    """Extractor with a static top-K output, the interface of
    `models.superpoint.SuperPoint`.

    extract(images (B, H, W[, 1]) gray in [0, 1]) -> dict(keypoints
    (B, K, 2) sub-pixel xy, scores (B, K), descriptors (B, K, 128)
    L2-normalised, mask (B, K)). Any H, W.
    """

    def __init__(self, max_keypoints: int = 4096, nms_radius: int = RADIUS,
                 device=None):
        self.max_keypoints = int(max_keypoints)
        self.nms_radius = int(nms_radius)
        self.descriptor_dim = DIM
        self.device = resolve_device(device)
        self.net = ALIKEDN16Net().to(self.device).eval()
        self._folded: dict | None = None
        self.timer = None            # an AverageTimer: the spans' recorder
        self.span_prefix = "aliked"
        self.counters: dict = {}     # a matcher hands its own dict

    def load_state_dict(self, state_dict: dict) -> "ALIKEDN16":
        self.net.load_state_dict(state_dict)
        self._folded = None
        return self

    def _count(self, key: str, n) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    def _span(self, stage: str):
        if self.timer is None:
            return contextlib.nullcontext()
        return self.timer.span(f"{self.span_prefix}.{stage}",
                               f"aliked_{stage}")

    # -- weights ---------------------------------------------------------

    def _fold(self) -> dict:
        """{conv: (weight, bias)} with each eval-mode batch norm folded
        into the convolution before it; block1's first convolution
        summed over its three (identical) input channels."""
        if self._folded is not None:
            return self._folded
        n = self.net
        out = {}
        with torch.no_grad():
            for bname in ("block1", "block2", "block3", "block4"):
                blk = getattr(n, bname)
                for i in (1, 2):
                    conv, bn = getattr(blk, f"conv{i}"), getattr(blk, f"bn{i}")
                    w = conv.regular_conv.weight \
                        if isinstance(conv, DeformableConv2d) else conv.weight
                    s = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
                    w = w * s[:, None, None, None]
                    if bname == "block1" and i == 1:
                        w = w.sum(1, keepdim=True)
                    out[f"{bname}.conv{i}"] = (
                        w.contiguous(), bn.bias - bn.running_mean * s)
        self._folded = out
        return out

    # -- the dense map ------------------------------------------------------

    def _deformable(self, conv: DeformableConv2d, x: torch.Tensor,
                    weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        with self._span("dcn"):
            m = max(x.shape[2:]) / 4.0
            off = F.conv2d(x, conv.offset_conv.weight, conv.offset_conv.bias,
                           padding=1).clamp_(-m, m)
            out = deform_conv3x3(x, off, weight, bias)
            self._count("dcn", 1)
        return out

    def _res_block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        blk = getattr(self.net, name)
        fold = self._fold()

        def conv_bn(i, t):
            conv = getattr(blk, f"conv{i}")
            w, bias = fold[f"{name}.conv{i}"]
            if isinstance(conv, DeformableConv2d):
                return self._deformable(conv, t, w, bias)
            return F.conv2d(t, w, bias, padding=1)

        out = F.selu(conv_bn(1, x), inplace=True)
        out = conv_bn(2, out)
        out += F.conv2d(x, blk.downsample.weight, blk.downsample.bias)
        return F.selu(out, inplace=True)

    def _backbone(self, gray: torch.Tensor) -> tuple:
        """(B, 1, H, W) padded gray -> the four blocks' maps."""
        fold = self._fold()
        x = gray
        for i in (1, 2):
            w, bias = fold[f"block1.conv{i}"]
            x = F.selu(F.conv2d(x, w, bias, padding=1), inplace=True)
        x1 = x
        x2 = self._res_block("block2", F.avg_pool2d(x1, 2))
        x3 = self._res_block("block3", F.avg_pool2d(x2, 4))
        x4 = self._res_block("block4", F.avg_pool2d(x3, 4))
        return x1, x2, x3, x4

    def _head(self, maps: tuple) -> tuple:
        """-> (score map (B, H, W) padded, L2-normalised feature map (B,
        128, H, W) padded)."""
        n = self.net
        x1 = maps[0]
        b, _, h, w = x1.shape
        q = DIM // 4
        feat = x1.new_empty((b, DIM, h, w))
        for i, (x, conv) in enumerate(zip(maps, (n.conv1, n.conv2, n.conv3,
                                                 n.conv4))):
            y = F.selu(F.conv2d(x, conv.weight), inplace=True)
            if y.shape[2:] != (h, w):
                y = F.interpolate(y, size=(h, w), mode="bilinear",
                                  align_corners=True)
            feat[:, i * q:(i + 1) * q] = y
        sh = n.score_head
        s = F.selu(F.conv2d(feat, sh[0].weight), inplace=True)
        s = F.selu(F.conv2d(s, sh[2].weight, padding=1), inplace=True)
        s = F.selu(F.conv2d(s, sh[4].weight, padding=1), inplace=True)
        score = torch.sigmoid(F.conv2d(s, sh[6].weight, padding=1))[:, 0]
        feat.div_(feat.norm(dim=1, keepdim=True).clamp_min_(1e-12))
        return score, feat

    # -- keypoints and descriptors -----------------------------------------

    def _dkd(self, score: torch.Tensor) -> tuple:
        """score (B, h, w) -> (keypoints (B, K, 2) xy, scores, mask)."""
        b, h, w = score.shape
        r = self.nms_radius
        heat = fused_nms_border(score, r, r, h, w)
        top, kpts = _topk_peaks(heat, self.max_keypoints, r)
        mask = top > 0
        xi, yi = kpts[..., 0].long(), kpts[..., 1].long()
        d = torch.arange(-r, r + 1, device=score.device)
        dy, dx = d.repeat_interleave(2 * r + 1), d.repeat(2 * r + 1)
        yy = (yi[..., None] + dy).clamp(0, h - 1)
        xx = (xi[..., None] + dx).clamp(0, w - 1)
        win = torch.gather(score.reshape(b, -1), 1,
                           (yy * w + xx).reshape(b, -1)).reshape(yy.shape)
        e = torch.exp((win - win.amax(-1, keepdim=True)) / TEMPERATURE)
        res = torch.stack([(e * dx).sum(-1), (e * dy).sum(-1)], -1) \
            / e.sum(-1, keepdim=True)
        kpts = kpts + res
        s = _bilinear(score[:, None], kpts[..., 1], kpts[..., 0], h, w)[:, 0]
        return kpts, s, mask

    def _sddh(self, feat: torch.Tensor, kpts: torch.Tensor, h: int, w: int,
              oy: int, ox: int) -> torch.Tensor:
        """Descriptors (B, K, 128) at keypoints (B, K, 2) of the h x w
        window at (oy, ox) of the padded feature map (B, 128, H, W)."""
        sd = self.net.desc_head
        b, c, _, ws = feat.shape
        k = kpts.shape[1]
        kl = kpts.long()
        # get_patches: corner (kl - 3 / 2 + 1).long(), clamped
        corner = (kl.float() - 0.5).long()
        cx = corner[..., 0].clamp(0, w - 1 - PATCH)
        cy = corner[..., 1].clamp(0, h - 1 - PATCH)
        self._count("patches_clamped", ((cx != kl[..., 0] - 1)
                                        | (cy != kl[..., 1] - 1)).sum())
        a = torch.arange(PATCH, device=feat.device)
        rows = cy[..., None, None] + a[:, None] + oy        # (B, K, 3, 1)
        cols = cx[..., None, None] + a[None, :] + ox        # (B, K, 1, 3)
        idx = (rows * ws + cols).reshape(b, 1, -1)
        patch = torch.gather(feat.reshape(b, c, -1), 2,
                             idx.expand(b, c, idx.shape[-1]))
        patch = patch.reshape(b, c, k, PATCH, PATCH).transpose(1, 2) \
            .reshape(b * k, c, PATCH, PATCH)
        oc = sd.offset_conv
        off = F.conv2d(F.selu(F.conv2d(patch, oc[0].weight, oc[0].bias)),
                       oc[2].weight, oc[2].bias).reshape(b, k, 2 * N_POS)
        m = max(h, w) / 4.0
        self._count("offsets_clamped", (off.abs() >= m).sum())
        off = off.clamp(-m, m)
        px = kpts[..., 0, None] + off[..., :N_POS]            # (B, K, M)
        py = kpts[..., 1, None] + off[..., N_POS:]
        f = _bilinear(feat, py, px, h, w, oy, ox).reshape(b, c, k, N_POS)
        f = F.selu(F.conv2d(f, sd.sf_conv.weight), inplace=True)
        f = f.permute(3, 0, 2, 1).reshape(N_POS, b * k, c)
        desc = torch.bmm(f, sd.agg_weights).sum(0).reshape(b, k, c)
        return desc / desc.norm(dim=-1, keepdim=True).clamp_min(1e-12)

    # -- extraction ----------------------------------------------------------

    @torch.inference_mode()
    def extract(self, images: torch.Tensor) -> dict:
        with full_f32_matmul():
            return self._extract(images.to(self.device))

    def _extract(self, images: torch.Tensor) -> dict:
        if images.ndim == 4:
            images = images[..., 0]
        b, h0, w0 = images.shape
        ph, pw = (-h0) % DIVISOR, (-w0) % DIVISOR
        oy, ox = ph // 2, pw // 2
        with self._span("backbone"):
            x = F.pad(images.float()[:, None], (ox, pw - ox, oy, ph - oy),
                      mode="replicate")
            maps = self._backbone(x)
        with self._span("head"):
            score, feat = self._head(maps)
            del maps
            score = score[:, oy:oy + h0, ox:ox + w0].contiguous()
        with self._span("dkd"):
            kpts, scores, mask = self._dkd(score)
        with self._span("sddh"):
            desc = self._sddh(feat, kpts, h0, w0, oy, ox)
        self.counters.setdefault("keypoints", []).append(mask.sum(1))
        return {"keypoints": kpts,
                "scores": torch.where(mask, scores, 0.0),
                "descriptors": torch.where(mask[..., None], desc, 0.0),
                "mask": mask}
