"""SuperPoint detector/descriptor in PyTorch (counterpart of
`icepy4d_tpu/models/superpoint.py`).

  VGG encoder 4x(conv3x3, conv3x3, pool) 64/64/128/128 ch
  detector head convPa/convPb -> 65ch softmax -> 8x8 pixel shuffle
  NMS (radius 4) + border removal -> top-K -> threshold 0.005
  descriptor head convDa/convDb -> 256-d, bilinear sample at kpts, L2 norm

The JAX package computes the full-resolution convs in a space-to-depth
layout and pools by reshape; both are layout choices for the TPU and
the same math as the plain 3x3 convs and 2x2 max-pools used here.
Outputs keep the JAX shapes: a static K keypoints per image with a
validity mask.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.ops.image import bilinear_sample
from icepy4d_tpu_torch.ops.nms import fused_nms_border, simple_nms  # noqa: F401
from icepy4d_tpu_torch.ops.topk import safe_top_k


def _tf32_hi_lo(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 t = hi + lo exactly, hi with TF32's 10 mantissa bits."""
    hi = (t.view(torch.int32) & -(1 << 13)).view(torch.float32)
    return hi, t - hi


def split_tf32(x: torch.Tensor,
               w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A one-channel f32 convolution as a four-channel one that TF32
    runs to ~2^-20 of f32: input channels (hi, lo, hi, lo) of x (B, 1,
    H, W) against (w_hi, w_hi, w_lo, w_lo) of w (O, 1, kh, kw) sum x * w
    (the tensor cores form each product of TF32 values exactly; only
    lo and w_lo round). cuDNN's fused engines take four channels on the
    tensor cores, and run one in f32 on the CUDA cores 2.5x slower;
    plain TF32 would put conv1a 2^-11 off where the unfused NCHW engine
    ran f32. Both come back channels-last."""
    ch = torch.arange(4, device=x.device)
    hi, lo = _tf32_hi_lo(x[:, 0, :, :, None])
    w_hi, w_lo = _tf32_hi_lo(w[:, 0, :, :, None])
    # one broadcast pass writes the interleaved channels (a stack along
    # the last axis copies them several times slower)
    return (torch.where(ch % 2 == 1, lo, hi).permute(0, 3, 1, 2),
            torch.where(ch >= 2, w_lo, w_hi).permute(0, 3, 1, 2))


class SuperPointNet(nn.Module):
    """The CNN: gray (B, 1, H, W) -> (heat (B, H, W) f32,
    dense descriptors (B, D, H/8, W/8) f32, L2-normalised).

    H and W must be multiples of 8.

    On a CUDA input with autograd off, each 3x3 convolution that a ReLU
    follows runs as one cuDNN convolution-bias-ReLU graph, whose
    epilogue adds the bias and clamps before its one store, over
    channels-last (NHWC) activations: cuDNN's fused engines take that
    layout, so no pass transposes, adds the bias or clamps on its own.
    f32 conv1a runs as `split_tf32` says where TF32 is on.
    `fused_convs` counts those calls, 10 a forward. A CPU input, or a
    forward that records a graph for a backward (the fused op has
    none), runs the plain conv, bias and ReLU in NCHW.
    """

    fused_convs = 0

    def __init__(self, channels=(64, 64, 128, 128), descriptor_dim: int = 256):
        super().__init__()
        c1, c2, c3, c4 = channels
        conv = lambda i, o: nn.Conv2d(i, o, 3, padding=1)  # noqa: E731
        self.conv1a, self.conv1b = conv(1, c1), conv(c1, c1)
        self.conv2a, self.conv2b = conv(c1, c2), conv(c2, c2)
        self.conv3a, self.conv3b = conv(c2, c3), conv(c3, c3)
        self.conv4a, self.conv4b = conv(c3, c4), conv(c4, c4)
        self.convPa = conv(c4, 256)
        self.convPb = nn.Conv2d(256, 65, 1)
        self.convDa = conv(c4, 256)
        self.convDb = nn.Conv2d(256, descriptor_dim, 1)

    @staticmethod
    def _conv_relu(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return F.relu(conv(x), inplace=True)

    @staticmethod
    def _conv_relu_fused(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        SuperPointNet.fused_convs += 1
        w = conv.weight
        if (conv.in_channels == 1 and x.dtype == torch.float32
                and torch.backends.cudnn.allow_tf32):
            x, w = split_tf32(x, w)
        return torch.ops.aten.cudnn_convolution_relu(
            x, w, conv.bias, conv.stride, conv.padding, conv.dilation,
            conv.groups)

    def forward(self, x: torch.Tensor,
                raw: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """`raw=True` is the training surface: the 65-way cell logits
        (B, 65, H/8, W/8) f32 (class axis 1, where the JAX package's
        NHWC layout has it last) in place of the heat map."""
        x = x.to(self.conv1a.weight.dtype)
        conv_relu = self._conv_relu
        if x.is_cuda and not torch.is_grad_enabled():
            conv_relu = self._conv_relu_fused
            x = x.to(memory_format=torch.channels_last)
        for a, b in ((self.conv1a, self.conv1b), (self.conv2a, self.conv2b),
                     (self.conv3a, self.conv3b)):
            x = F.max_pool2d(conv_relu(b, conv_relu(a, x)), 2, 2)
        x = conv_relu(self.conv4b, conv_relu(self.conv4a, x))

        logits = self.convPb(conv_relu(self.convPa, x)).float()
        desc = self.convDb(conv_relu(self.convDa, x)).float()
        desc = desc / desc.norm(dim=1, keepdim=True).clamp_min(1e-12)
        if raw:
            return logits, desc
        probs = torch.softmax(logits, dim=1)[:, :64]
        heat = F.pixel_shuffle(probs, 8)[:, 0]          # 8x8 cells -> pixels
        return heat, desc


def _topk_peaks(heat: torch.Tensor, max_keypoints: int,
                nms_radius: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-K of an NMS-suppressed heatmap -> (scores (B,K), kpts (B,K,2) xy).

    After radius-r NMS, surviving peaks are more than r apart, so every
    r x r cell holds at most one nonzero: the top-K runs over cell maxima
    (argmax inside the cell), r*r times fewer values. Exact ties inside
    one cell keep only the first (argmax) position, as in the JAX
    package. The cell path is taken only when it keeps the output size
    K = min(max_keypoints, h*w).
    """
    b, h, w = heat.shape
    c = max(nms_radius, 1)
    k = min(max_keypoints, h * w)
    if h % c or w % c or (h // c) * (w // c) < k:
        scores, idx = safe_top_k(heat.reshape(b, -1), k)
        return scores, torch.stack([idx % w, idx // w], -1).float()
    hc, wc = h // c, w // c
    cells = heat.reshape(b, hc, c, wc, c).permute(0, 1, 3, 2, 4)
    cells = cells.reshape(b, hc * wc, c * c)
    cell_max = cells.amax(-1)
    cell_arg = cells.argmax(-1)
    scores, idx = safe_top_k(cell_max, k)
    sub = torch.gather(cell_arg, 1, idx)
    yy = (idx // wc) * c + sub // c
    xx = (idx % wc) * c + sub % c
    return scores, torch.stack([xx, yy], -1).float()


def sample_descriptors(dense_desc: torch.Tensor, kpts: torch.Tensor,
                       s: int = 8) -> torch.Tensor:
    """Bilinear-sample dense descriptors at pixel keypoints + L2 normalise.

    dense_desc (Hc, Wc, D); kpts (K, 2) pixel xy in the full image. The
    coordinate transform is torch grid_sample's (align_corners=False
    normalisation, then align_corners=True sampling):
    x_desc = (kp - s/2 + 0.5) / (wc*s - s/2 - 0.5) * (wc - 1).
    """
    hc, wc, _ = dense_desc.shape
    scale = kpts.new_tensor([wc * s - s / 2 - 0.5, hc * s - s / 2 - 0.5])
    span = kpts.new_tensor([wc - 1, hc - 1])
    xy = (kpts - s / 2 + 0.5) / scale * span
    desc = bilinear_sample(dense_desc, xy)
    return desc / desc.norm(dim=-1, keepdim=True).clamp_min(1e-12)


class SuperPoint:
    """Extractor with a static top-K output.

    extract(images) -> dict with
      keypoints   (B,K,2) float32 [x, y] pixels
      scores      (B,K)   float32
      descriptors (B,K,D) float32 L2-normalised
      mask        (B,K)   bool (above threshold, not in the border)

    `dtype` is the conv trunk's activation type; NMS, top-K and
    descriptor sampling always run in f32.
    """

    def __init__(
        self,
        max_keypoints: int = 2048,
        detection_threshold: float = 0.005,
        nms_radius: int = 4,
        remove_borders: int = 4,
        descriptor_dim: int = 256,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        self.max_keypoints = int(max_keypoints)
        self.detection_threshold = float(detection_threshold)
        self.nms_radius = int(nms_radius)
        self.remove_borders = int(remove_borders)
        self.descriptor_dim = int(descriptor_dim)
        self.device = resolve_device(device)
        # channels-last weights on the card, as the fused trunk takes them
        layout = (torch.channels_last if self.device.type == "cuda"
                  else torch.contiguous_format)
        self.net = SuperPointNet(descriptor_dim=descriptor_dim).to(
            device=self.device, dtype=dtype, memory_format=layout).eval()

    def load_state_dict(self, state_dict: dict) -> "SuperPoint":
        self.net.load_state_dict(state_dict)
        return self

    def extract_flops(self, h: int, w: int, batch: int = 1) -> float:
        """Convolution FLOPs one `extract` of (batch, h, w) frames
        executes: 2 * Cin * Cout * k^2 for each output pixel of every
        convolution, on the frame padded to the 8-px cell grid (NMS,
        top-K, sampling and the elementwise work are left out).

        The JAX package's `extract_flops` counts its full-resolution
        conv1a / conv1b in the space-to-depth form it runs on the TPU,
        which executes 4x the pixel-space MACs; here they are plain 3x3
        convolutions, so the count is lower by 3 * (2 * c1 * 9 + 2 * c1
        * c1 * 9) a pixel (169,608 against 394,248 FLOP a pixel at the
        default widths)."""
        n = self.net
        c1, c2, c3, c4 = (n.conv1a.out_channels, n.conv2a.out_channels,
                          n.conv3a.out_channels, n.conv4a.out_channels)
        dp, dd = n.convPa.out_channels, n.convDb.out_channels
        cells = -(-h // 8) * -(-w // 8)           # (H/8) * (W/8), padded
        per_cell = (
            64 * (2 * 1 * c1 * 9 + 2 * c1 * c1 * 9)     # conv1a/b, H
            + 16 * (2 * c1 * c2 * 9 + 2 * c2 * c2 * 9)  # conv2a/b, H/2
            + 4 * (2 * c2 * c3 * 9 + 2 * c3 * c3 * 9)   # conv3a/b, H/4
            + (2 * c3 * c4 * 9 + 2 * c4 * c4 * 9)       # conv4a/b, H/8
            + (2 * c4 * dp * 9 + 2 * dp * 65)           # convPa/Pb
            + (2 * c4 * dp * 9 + 2 * dp * dd)           # convDa/Db
        )
        return float(batch * cells * per_cell)

    @torch.inference_mode()
    def extract(self, images: torch.Tensor) -> dict:
        """images: (B, H, W) or (B, H, W, 1) grayscale in [0, 1].

        Any H, W: inputs are zero-padded to the 8-px cell grid, and the
        padded band is masked out like the border.
        """
        return self._extract(images.to(self.device))

    @torch.inference_mode()
    def describe_at(self, images: torch.Tensor,
                    kpts: torch.Tensor) -> torch.Tensor:
        """Descriptors at given pixel positions, no detection.

        images (B, H, W[, 1]) in [0, 1]; kpts (B, K, 2) xy pixels ->
        (B, K, D) L2-normalised, sampled from the dense map as
        `extract` samples its keypoints (inputs padded to the 8-px
        grid)."""
        images = images.to(self.device)
        if images.ndim == 4:
            images = images[..., 0]
        h0, w0 = images.shape[1:]
        x = F.pad(images.float(), (0, (-w0) % 8, 0, (-h0) % 8))
        _, dense_desc = self.net(x[:, None], raw=True)
        dense = dense_desc.permute(0, 2, 3, 1)
        kpts = kpts.to(self.device, torch.float32)
        return torch.stack([sample_descriptors(dense[i], kpts[i])
                            for i in range(len(kpts))])

    def _extract(self, images: torch.Tensor) -> dict:
        if images.ndim == 4:
            images = images[..., 0]
        b, h0, w0 = images.shape
        x = F.pad(images.float(), (0, (-w0) % 8, 0, (-h0) % 8))
        heat, dense_desc = self.net(x[:, None])

        # NMS + border removal against the original extent, not the padded
        heat = fused_nms_border(heat, self.nms_radius,
                                max(self.remove_borders, 1), h0, w0)
        scores, kpts = _topk_peaks(heat, self.max_keypoints, self.nms_radius)
        mask = scores > self.detection_threshold

        dense = dense_desc.permute(0, 2, 3, 1)             # (B, Hc, Wc, D)
        desc = torch.stack([sample_descriptors(dense[i], kpts[i])
                            for i in range(b)])
        return {
            "keypoints": kpts,
            "scores": torch.where(mask, scores, 0.0),
            "descriptors": torch.where(mask[..., None], desc, 0.0),
            "mask": mask,
        }
