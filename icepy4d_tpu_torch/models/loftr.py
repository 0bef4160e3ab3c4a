"""LoFTR detector-free matcher in PyTorch (counterpart of
`icepy4d_tpu/models/loftr.py`, the published architecture):

  ResNet-FPN 8-2 backbone (coarse 1/8 x 256, fine 1/2 x 128)
  sinusoidal 2-D positional encoding (with the published checkpoints'
    "temperature bug", temp_bug_fix=False)
  coarse transformer: 4 x (self + cross) linear attention
  dual-softmax coarse matching (T = 0.1), mutual NN, threshold, border
    removal; the matches are the top `max_matches` confidences of a pair
    (a static capacity with a validity mask, as in the JAX package)
  fine stage: 5x5 windows at 1/2, coarse-feature concat, 1 x (self +
    cross) transformer, centre-against-window softmax and the expected
    position

Linear attention is an einsum pair over (B, N, H, D) with no attention
matrix, plain PyTorch as in the JAX package (no kernel). The whole
forward is batched over tile pairs. Module names follow the JAX tree;
`models.convert.loftr_params` loads a JAX tree and `load_torch_loftr`
a kornia-layout checkpoint.

Given a `utils/timer.py::AverageTimer` as `LoFTR.timer`, a forward
records four spans under the name prefix `LoFTR.span_prefix` (the
caller's: the matcher hands its own timer and `match.loftr`):
`<prefix>.backbone` (key `backbone`), `<prefix>.coarse` (`coarse`:
position encoding and the coarse transformer), `<prefix>.coarse_match`
(`coarse_match`: the dual softmax's best matches, mutual NN, threshold,
border, top-k) and `<prefix>.fine` (`fine`: windows, merge, fine transformer,
expectation). None of them synchronises the device; without a timer
none is opened.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from icepy4d_tpu_torch.device import full_f32_matmul, resolve_device
from icepy4d_tpu_torch.ops import dual_softmax
from icepy4d_tpu_torch.ops.topk import safe_top_k

BN_EPS = 1e-5
LN_EPS = 1e-5


class BatchNorm2d(nn.Module):
    """Inference batch norm over dim 1 with the JAX tree's names and its
    arithmetic order, (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.var + BN_EPS) * self.weight
        return (x - self.mean[:, None, None]) * inv[:, None, None] \
            + self.bias[:, None, None]


def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     bias=False)


class _BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, cout, 3, stride), BatchNorm2d(cout)
        self.conv2, self.bn2 = _conv(cout, cout, 3), BatchNorm2d(cout)
        self.down = stride != 1
        if self.down:
            self.down_conv, self.down_bn = _conv(cin, cout, 1, stride), \
                BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.down:
            x = self.down_bn(self.down_conv(x))
        return F.relu(x + y)


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample of (B, C, H, W) with align_corners=True, in
    the JAX package's arithmetic (a * (1 - f) + b * f per axis)."""
    def lerp(t, n, dim):
        src = torch.arange(2 * n, device=t.device) * ((n - 1) / (2 * n - 1))
        i0 = torch.floor(src).long()
        i1 = (i0 + 1).clamp_max(n - 1)
        f = (src - i0).to(t.dtype)
        shape = [1, 1, 1, 1]
        shape[dim] = 2 * n
        f = f.reshape(shape)
        return t.index_select(dim, i0) * (1 - f) + t.index_select(dim, i1) * f

    x = lerp(x, x.shape[2], 2)
    return lerp(x, x.shape[3], 3)


class _OutConv2(nn.Module):
    def __init__(self, c: int, cout: int):
        super().__init__()
        self.conv1, self.bn, self.conv2 = _conv(c, c, 3), BatchNorm2d(c), \
            _conv(c, cout, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.leaky_relu(self.bn(self.conv1(x)), 0.01))


class Backbone(nn.Module):
    """ResNet-FPN 8-2: (B, 1, H, W) -> coarse (B, 256, H/8, W/8),
    fine (B, 128, H/2, W/2)."""

    def __init__(self, initial_dim: int = 128,
                 block_dims: tuple = (128, 196, 256)):
        super().__init__()
        d0, d1, d2 = block_dims
        self.conv1, self.bn1 = _conv(1, initial_dim, 7, 2), \
            BatchNorm2d(initial_dim)
        self.layer1 = nn.ModuleList([_BasicBlock(initial_dim, d0, 1),
                                     _BasicBlock(d0, d0, 1)])
        self.layer2 = nn.ModuleList([_BasicBlock(d0, d1, 2),
                                     _BasicBlock(d1, d1, 1)])
        self.layer3 = nn.ModuleList([_BasicBlock(d1, d2, 2),
                                     _BasicBlock(d2, d2, 1)])
        self.layer3_outconv = _conv(d2, d2, 1)
        self.layer2_outconv = _conv(d1, d2, 1)
        self.layer2_outconv2 = _OutConv2(d2, d1)
        self.layer1_outconv = _conv(d0, d1, 1)
        self.layer1_outconv2 = _OutConv2(d1, d0)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x1 = F.relu(self.bn1(self.conv1(x)))
        for blk in self.layer1:
            x1 = blk(x1)
        x2 = self.layer2[1](self.layer2[0](x1))
        x3 = self.layer3[1](self.layer3[0](x2))
        x3_out = self.layer3_outconv(x3)
        x2_out = self.layer2_outconv2(self.layer2_outconv(x2)
                                      + upsample2x_align_corners(x3_out))
        x1_out = self.layer1_outconv2(self.layer1_outconv(x1)
                                      + upsample2x_align_corners(x2_out))
        return x3_out, x1_out


def sine_pos_encoding(d_model: int, h: int, w: int,
                      temp_bug_fix: bool = False) -> np.ndarray:
    """Sinusoidal 2-D encoding, (h, w, d_model) channels-last.

    temp_bug_fix=False reproduces the original implementation, whose
    div_term evaluates to exp(-arange(0, d/2, 2)) through an operator
    precedence slip; the published checkpoints were trained with it.
    """
    steps = np.arange(0, d_model // 2, 2, dtype=np.float64)
    if temp_bug_fix:
        div_term = np.exp(steps * (-math.log(10000.0) / (d_model // 2)))
    else:
        div_term = np.exp(steps * (-math.log(10000.0) / d_model // 2))
    y_pos = np.arange(1, h + 1, dtype=np.float64)[:, None, None]
    x_pos = np.arange(1, w + 1, dtype=np.float64)[None, :, None]
    pe = np.zeros((h, w, d_model), np.float32)
    pe[:, :, 0::4] = np.sin(x_pos * div_term).astype(np.float32) \
        * np.ones((h, 1, 1), np.float32)
    pe[:, :, 1::4] = np.cos(x_pos * div_term).astype(np.float32) \
        * np.ones((h, 1, 1), np.float32)
    pe[:, :, 2::4] = np.sin(y_pos * div_term).astype(np.float32) \
        * np.ones((1, w, 1), np.float32)
    pe[:, :, 3::4] = np.cos(y_pos * div_term).astype(np.float32) \
        * np.ones((1, w, 1), np.float32)
    return pe


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_mask: torch.Tensor | None) -> torch.Tensor:
    """elu + 1 feature-map attention, (B, N, H, D) operands. V is scaled
    by the key length to avoid overflow; masked K / V rows are zeroed."""
    fq = F.elu(q) + 1.0
    fk = F.elu(k) + 1.0
    if kv_mask is not None:
        m = kv_mask[:, :, None, None].to(fk.dtype)
        fk = fk * m
        v = v * m
    n = v.shape[1]
    v = v / n
    kv = torch.einsum("bshd,bshv->bhdv", fk, v)
    z = 1.0 / (torch.einsum("blhd,bhd->blh", fq, fk.sum(1)) + 1e-6)
    return torch.einsum("blhd,bhdv,blh->blhv", fq, kv, z) * n


class EncoderLayer(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d, bias=False)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d, bias=False)
        self.merge = nn.Linear(d, d, bias=False)
        self.mlp0 = nn.Linear(2 * d, 2 * d, bias=False)
        self.mlp2 = nn.Linear(2 * d, d, bias=False)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, x, source, src_mask, nhead: int) -> torch.Tensor:
        b, n, d = x.shape
        dim = d // nhead
        q = self.q_proj(x).reshape(b, n, nhead, dim)
        k = self.k_proj(source).reshape(b, -1, nhead, dim)
        v = self.v_proj(source).reshape(b, -1, nhead, dim)
        msg = linear_attention(q, k, v, src_mask).reshape(b, n, d)
        msg = self.norm1(self.merge(msg))
        msg = self.mlp2(F.relu(self.mlp0(torch.cat([x, msg], -1))))
        return x + self.norm2(msg)


def _pairs(d: int, n: int) -> nn.ModuleList:
    return nn.ModuleList(nn.ModuleDict({"self": EncoderLayer(d),
                                        "cross": EncoderLayer(d)})
                         for _ in range(n))


def lft_apply(layers: nn.ModuleList, f0, f1, mask0, mask1, nhead: int):
    """['self', 'cross'] x n; the cross updates are sequential, as in the
    published model: feat1 attends to the already updated feat0."""
    for lp in layers:
        f0 = lp["self"](f0, f0, mask0, nhead)
        f1 = lp["self"](f1, f1, mask1, nhead)
        f0 = lp["cross"](f0, f1, mask1, nhead)
        f1 = lp["cross"](f1, f0, mask0, nhead)
    return f0, f1


def _border_ok(h: int, w: int, rm: int, device) -> torch.Tensor:
    i = torch.arange(h * w, device=device)
    r, c = i // w, i % w
    return (r >= rm) & (r < h - rm) & (c >= rm) & (c < w - rm)


def select_matches(bj: torch.Tensor, bv: torch.Tensor, bi: torch.Tensor,
                   mask0: torch.Tensor, mask1: torch.Tensor, hw0_c: tuple,
                   hw1_c: tuple, thr: float, border_rm: int,
                   max_matches: int):
    """Mutual-NN, threshold and border removal on each row's best column
    bj (B, L0) and its confidence bv (B, L0) and each column's best row bi
    (B, L1); the `max_matches` best survivors of each pair -> (i, j, conf,
    valid), each (B, M). Equal confidences come out in index order."""
    l0 = bj.shape[1]
    dev = bj.device
    mutual = torch.gather(bi, 1, bj) == torch.arange(l0, device=dev)
    ok = (mutual & (bv > thr)
          & _border_ok(*hw0_c, border_rm, dev)
          & _border_ok(*hw1_c, border_rm, dev)[bj]
          & mask0 & torch.gather(mask1, 1, bj))
    topv, topi = safe_top_k(torch.where(ok, bv, 0.0), max_matches)
    return topi, torch.gather(bj, 1, topi), topv, topv > 0.0


def coarse_match(conf: torch.Tensor, mask0: torch.Tensor, mask1: torch.Tensor,
                 hw0_c: tuple, hw1_c: tuple, thr: float, border_rm: int,
                 max_matches: int):
    """`select_matches` on the best matches of the confidences conf
    (B, L0, L1)."""
    return select_matches(*dual_softmax.best_of(conf), mask0, mask1, hw0_c,
                          hw1_c, thr, border_rm, max_matches)


def gather_windows(feat_f: torch.Tensor, idx: torch.Tensor, wc: int,
                   window: int, stride: int) -> torch.Tensor:
    """window x window fine-feature windows (B, M, window^2, C) centred
    on coarse cells idx (B, M) of feat_f (B, Hf, Wf, C); out-of-map taps
    read zeros."""
    b, hf, wf, c = feat_f.shape
    r = (idx // wc) * stride
    col = (idx % wc) * stride
    off = torch.arange(window, device=idx.device) - window // 2
    rows = r[..., None, None] + off[:, None]
    cols = col[..., None, None] + off[None, :]
    inb = (rows >= 0) & (rows < hf) & (cols >= 0) & (cols < wf)
    bi = torch.arange(b, device=idx.device)[:, None, None, None]
    win = feat_f[bi, rows.clamp(0, hf - 1), cols.clamp(0, wf - 1)]
    win = torch.where(inb[..., None], win, 0.0)
    return win.reshape(b, idx.shape[1], window * window, c)


def fine_match(f0: torch.Tensor, f1: torch.Tensor, window: int):
    """Centre-against-window softmax and expected position: f0 / f1
    (..., W*W, C) -> (coords (..., 2) in [-1, 1], std (...))."""
    ww, c = f0.shape[-2:]
    center = f0[..., ww // 2, :]
    sim = torch.einsum("...c,...rc->...r", center, f1) / math.sqrt(c)
    heat = torch.softmax(sim, -1)
    g = torch.linspace(-1.0, 1.0, window, device=f0.device)
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    coords = heat @ grid
    var = heat @ grid ** 2 - coords ** 2
    std = torch.sqrt(var.clamp_min(1e-10)).sum(-1)
    return coords, std


class LoFTRNet(nn.Module):
    """The parameters: backbone, coarse and fine transformer pairs, and
    the fine preprocessing projections."""

    def __init__(self, d_model_c: int = 256, d_model_f: int = 128,
                 coarse_pairs: int = 4, fine_pairs: int = 1,
                 initial_dim: int = 128,
                 block_dims: tuple = (128, 196, 256)):
        super().__init__()
        self.backbone = Backbone(initial_dim, block_dims)
        self.coarse = _pairs(d_model_c, coarse_pairs)
        self.fine_preprocess = nn.ModuleDict({
            "down_proj": nn.Linear(d_model_c, d_model_f),
            "merge_feat": nn.Linear(2 * d_model_f, d_model_f)})
        self.fine = _pairs(d_model_f, fine_pairs)


class LoFTR:
    """Batched LoFTR.

    match_pair(img0, img1) and match_batch(imgs0 (B,H,W), imgs1,
    pair_valid) return padded per-pair results: keypoints0/1 (B, M, 2)
    px, confidence (B, M), descriptors0/1 (B, M, 128) L2-normalised fine
    centre features, std (B, M), valid (B, M). Images are float gray in
    [0, 1]. `precision="highest"` runs the convs and products without
    TF32.
    """

    # the CPU's dense dual softmax holds an L0 x L1 f32 similarity: past
    # 32k coarse tokens a pair's forward would not fit one device (the
    # card's kernel holds none; the cap is the same on both)
    MAX_COARSE_TOKENS = 32768

    def __init__(self, d_model_c: int = 256, d_model_f: int = 128,
                 nhead: int = 8, coarse_pairs: int = 4, fine_pairs: int = 1,
                 initial_dim: int = 128, block_dims: tuple = (128, 196, 256),
                 temp_bug_fix: bool = False, thr: float = 0.2,
                 border_rm: int = 2, dsmax_temperature: float = 0.1,
                 fine_window: int = 5, max_matches: int = 1024,
                 precision: str = "default", device=None):
        self.d_model_c, self.d_model_f = d_model_c, d_model_f
        self.nhead = nhead
        self.temp_bug_fix = bool(temp_bug_fix)
        self.thr = float(thr)
        self.border_rm = int(border_rm)
        self.dsmax_temperature = float(dsmax_temperature)
        self.fine_window = int(fine_window)
        self.max_matches = int(max_matches)
        self.precision = precision
        self.device = resolve_device(device)
        self.timer = None       # an AverageTimer: the forward's spans
        self.span_prefix = "loftr"
        self.net = LoFTRNet(d_model_c, d_model_f, coarse_pairs, fine_pairs,
                            initial_dim, tuple(block_dims)).to(
            self.device).eval()

    def load_state_dict(self, state_dict: dict) -> "LoFTR":
        self.net.load_state_dict(state_dict)
        return self

    def _check_size(self, h: int, w: int) -> None:
        n = (h // 8) * (w // 8)
        if n > self.MAX_COARSE_TOKENS:
            raise ValueError(
                f"LoFTR coarse grid {h // 8}x{w // 8} = {n} tokens "
                f"(> {self.MAX_COARSE_TOKENS}): the L0xL1 similarity "
                f"matrix would not fit one chip. Use a lower Quality "
                f"or tile the frame (TileSelection.GRID/PRESELECTION "
                f"with a finer grid).")

    def _precision(self):
        return full_f32_matmul() if self.precision == "highest" \
            else contextlib.nullcontext()

    def _span(self, stage: str):
        """Span `<span_prefix>.<stage>`, key `stage`, on the timer (none
        without one)."""
        if self.timer is None:
            return contextlib.nullcontext()
        return self.timer.span(f"{self.span_prefix}.{stage}", stage)

    def coarse_features(self, imgs0: torch.Tensor, imgs1: torch.Tensor,
                        mask_c0: torch.Tensor, mask_c1: torch.Tensor):
        """Backbone, position encoding and the coarse transformer of a
        (B, H, W) pair batch (sides multiples of 8) -> (c0, c1 (B, L, C),
        fine maps ff0, ff1 (B, H/2, W/2, 128), coarse grids)."""
        net = self.net
        b = imgs0.shape[0]
        with self._span("backbone"):
            if imgs0.shape == imgs1.shape:
                fc, ff = net.backbone(torch.cat([imgs0, imgs1])[:, None])
                fc0, fc1, ff0, ff1 = fc[:b], fc[b:], ff[:b], ff[b:]
            else:
                fc0, ff0 = net.backbone(imgs0[:, None])
                fc1, ff1 = net.backbone(imgs1[:, None])
        hw0_c = tuple(fc0.shape[2:])
        hw1_c = tuple(fc1.shape[2:])

        def tokens(fc, hw):
            pe = torch.from_numpy(sine_pos_encoding(
                self.d_model_c, *hw, self.temp_bug_fix)).to(fc.device)
            return (fc.permute(0, 2, 3, 1) + pe).reshape(b, -1, self.d_model_c)

        with self._span("coarse"):
            c0, c1 = lft_apply(net.coarse, tokens(fc0, hw0_c),
                               tokens(fc1, hw1_c), mask_c0, mask_c1,
                               self.nhead)
        return (c0, c1, ff0.permute(0, 2, 3, 1), ff1.permute(0, 2, 3, 1),
                hw0_c, hw1_c)

    def coarse_confidence(self, c0: torch.Tensor, c1: torch.Tensor,
                          mask_c0: torch.Tensor,
                          mask_c1: torch.Tensor) -> torch.Tensor:
        """Dual-softmax confidences (B, L0, L1), the dense matrix (the
        forward takes only its best matches: `dual_softmax.best_matches`)."""
        return dual_softmax.confidence_plain(c0, c1, mask_c0, mask_c1,
                                             self.dsmax_temperature)

    def _forward(self, imgs0, imgs1, mask_c0, mask_c1) -> dict:
        c0, c1, ff0, ff1, hw0_c, hw1_c = self.coarse_features(
            imgs0, imgs1, mask_c0, mask_c1)
        with self._span("coarse_match"):
            # on a card the kernel, with no L0 x L1 matrix; on the CPU
            # the dense confidences and their reductions
            best = dual_softmax.best_matches(c0, c1, mask_c0, mask_c1,
                                             self.dsmax_temperature)
            l0 = hw0_c[0] * hw0_c[1]
            i, j, mconf, valid = select_matches(
                *best, mask_c0, mask_c1, hw0_c, hw1_c, self.thr,
                self.border_rm, min(self.max_matches, l0))
        with self._span("fine"):
            return self._fine(c0, c1, ff0, ff1, hw0_c, hw1_c, i, j, mconf,
                              valid)

    def _fine(self, c0, c1, ff0, ff1, hw0_c, hw1_c, i, j, mconf,
              valid) -> dict:
        """The fine stage on the kept coarse matches (i, j)."""

        def cells(idx, wc):
            return torch.stack([(idx % wc).float() * 8.0,
                                (idx // wc).float() * 8.0], -1)

        mkpts0_c = cells(i, hw0_c[1])
        mkpts1_c = cells(j, hw1_c[1])

        w = self.fine_window
        ww = w * w
        fp = self.net.fine_preprocess
        f0_win = gather_windows(ff0, i, hw0_c[1], w, 4)
        f1_win = gather_windows(ff1, j, hw1_c[1], w, 4)
        cf0 = fp["down_proj"](torch.gather(
            c0, 1, i[..., None].expand(-1, -1, c0.shape[-1])))
        cf1 = fp["down_proj"](torch.gather(
            c1, 1, j[..., None].expand(-1, -1, c1.shape[-1])))
        b, m = i.shape

        def merge(win, cf):
            return fp["merge_feat"](torch.cat(
                [win, cf[:, :, None].expand(b, m, ww, self.d_model_f)], -1))

        f0_win = merge(f0_win, cf0).reshape(b * m, ww, self.d_model_f)
        f1_win = merge(f1_win, cf1).reshape(b * m, ww, self.d_model_f)
        f0_win, f1_win = lft_apply(self.net.fine, f0_win, f1_win, None, None,
                                   self.nhead)
        f0_win = f0_win.reshape(b, m, ww, self.d_model_f)
        f1_win = f1_win.reshape(b, m, ww, self.d_model_f)
        coords, std = fine_match(f0_win, f1_win, w)
        mkpts1 = mkpts1_c + coords * (w // 2) * 2.0

        def l2n(d):
            return d / d.norm(dim=-1, keepdim=True).clamp_min(1e-12)

        vf = valid[..., None]
        return {"keypoints0": torch.where(vf, mkpts0_c, 0.0),
                "keypoints1": torch.where(vf, mkpts1, 0.0),
                "confidence": torch.where(valid, mconf, 0.0),
                "descriptors0": torch.where(vf, l2n(f0_win[:, :, ww // 2]),
                                            0.0),
                "descriptors1": torch.where(vf, l2n(f1_win[:, :, ww // 2]),
                                            0.0),
                "std": std, "valid": valid}

    @staticmethod
    def cell_mask(shape: tuple, hw: tuple, device) -> torch.Tensor:
        """Coarse cells (L,) of a padded (H, W) frame that start inside
        the true (h, w) extent."""
        hc, wc = shape[0] // 8, shape[1] // 8
        i = torch.arange(hc * wc, device=device)
        return ((i // wc) * 8 < hw[0]) & ((i % wc) * 8 < hw[1])

    @staticmethod
    def _pad8(im: torch.Tensor) -> torch.Tensor:
        return F.pad(im, (0, (-im.shape[-1]) % 8, 0, (-im.shape[-2]) % 8))

    @torch.inference_mode()
    def match_pair(self, img0, img1) -> dict:
        """One pair of (H, W) images, each padded to the 8-px grid; the
        result has a batch dim of 1."""
        img0 = torch.as_tensor(img0, dtype=torch.float32, device=self.device)
        img1 = torch.as_tensor(img1, dtype=torch.float32, device=self.device)
        self._check_size(*img0.shape)
        self._check_size(*img1.shape)
        p0, p1 = self._pad8(img0), self._pad8(img1)
        m0 = self.cell_mask(p0.shape, img0.shape, self.device)[None]
        m1 = self.cell_mask(p1.shape, img1.shape, self.device)[None]
        with self._precision():
            return self._forward(p0[None], p1[None], m0, m1)

    @torch.inference_mode()
    def match_batch(self, imgs0, imgs1, pair_valid) -> dict:
        """A (B, H, W) tile-pair batch; tiles pad to the 8-px grid (pad
        cells masked); pair_valid (B,) masks bucket padding."""
        imgs0 = torch.as_tensor(imgs0, dtype=torch.float32,
                                device=self.device)
        imgs1 = torch.as_tensor(imgs1, dtype=torch.float32,
                                device=self.device)
        self._check_size(*imgs0.shape[1:])
        b, h0, w0 = imgs0.shape
        p0, p1 = self._pad8(imgs0), self._pad8(imgs1)
        cell = self.cell_mask(p0.shape[1:], (h0, w0), self.device)
        cell = cell[None].expand(b, -1)
        with self._precision():
            out = self._forward(p0, p1, cell, cell)
        out["valid"] = out["valid"] & torch.as_tensor(
            pair_valid, device=self.device)[:, None]
        return out


def loftr_tree(seed: int = 0, d_model_c: int = 256, d_model_f: int = 128,
               coarse_pairs: int = 4, fine_pairs: int = 1,
               initial_dim: int = 128,
               block_dims: tuple = (128, 196, 256)) -> dict:
    """Random parameters in the JAX layout (fan-in scaled normals from
    numpy's default_rng(seed); unit batch-norm statistics; the
    transformer stacks with a leading pair axis)."""
    rng = np.random.default_rng(seed)

    def conv(kh, kw, cin, cout):
        return {"w": (rng.normal(size=(kh, kw, cin, cout))
                      / math.sqrt(kh * kw * cin)).astype(np.float32)}

    def bnp(c):
        return {"scale": np.ones(c, np.float32),
                "bias": np.zeros(c, np.float32),
                "mean": np.zeros(c, np.float32),
                "var": np.ones(c, np.float32)}

    def block(cin, cout, stride):
        p = {"conv1": conv(3, 3, cin, cout), "bn1": bnp(cout),
             "conv2": conv(3, 3, cout, cout), "bn2": bnp(cout)}
        if stride != 1:
            p["down_conv"] = conv(1, 1, cin, cout)
            p["down_bn"] = bnp(cout)
        return p

    d0, d1, d2 = block_dims
    backbone = {
        "conv1": conv(7, 7, 1, initial_dim), "bn1": bnp(initial_dim),
        "layer1": [block(initial_dim, d0, 1), block(d0, d0, 1)],
        "layer2": [block(d0, d1, 2), block(d1, d1, 1)],
        "layer3": [block(d1, d2, 2), block(d2, d2, 1)],
        "layer3_outconv": conv(1, 1, d2, d2),
        "layer2_outconv": conv(1, 1, d1, d2),
        "layer2_outconv2": {"conv1": conv(3, 3, d2, d2), "bn": bnp(d2),
                            "conv2": conv(3, 3, d2, d1)},
        "layer1_outconv": conv(1, 1, d0, d1),
        "layer1_outconv2": {"conv1": conv(3, 3, d1, d1), "bn": bnp(d1),
                            "conv2": conv(3, 3, d1, d0)},
    }

    def lin(din, dout, bias=False):
        p = {"w": (rng.normal(size=(din, dout)) / math.sqrt(din)
                   ).astype(np.float32)}
        if bias:
            p["b"] = np.zeros(dout, np.float32)
        return p

    def enc_layer(d):
        return {"q_proj": lin(d, d), "k_proj": lin(d, d),
                "v_proj": lin(d, d), "merge": lin(d, d),
                "mlp0": lin(2 * d, 2 * d), "mlp2": lin(2 * d, d),
                "norm1": {"scale": np.ones(d, np.float32),
                          "bias": np.zeros(d, np.float32)},
                "norm2": {"scale": np.ones(d, np.float32),
                          "bias": np.zeros(d, np.float32)}}

    def stack(*nodes):
        if isinstance(nodes[0], dict):
            return {k: stack(*[n[k] for n in nodes]) for k in nodes[0]}
        return np.stack(nodes)

    def stack_pairs(d, n):
        return stack(*[{"self": enc_layer(d), "cross": enc_layer(d)}
                       for _ in range(n)])

    return {"backbone": backbone,
            "coarse": stack_pairs(d_model_c, coarse_pairs),
            "fine_preprocess": {
                "down_proj": lin(d_model_c, d_model_f, bias=True),
                "merge_feat": lin(2 * d_model_f, d_model_f, bias=True)},
            "fine": stack_pairs(d_model_f, fine_pairs)}
