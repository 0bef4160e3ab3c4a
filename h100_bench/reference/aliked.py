"""Plain ALIKED-n16 (Zhao et al., "ALIKED: A Lighter Keypoint and
Descriptor Extraction Network via Deformable Transformation", IEEE TIM
2023; Shiaoming/ALIKED `nets/aliked.py`, `ALIKED_CFGS["aliked-n16"]`, as
vendored in cvg/LightGlue `lightglue/aliked.py`), and the random weights
of the `aliked_lightglue` configuration: ALIKED-n16's and LightGlue's at
`input_dim` 128.

The arithmetic follows the published modules, one tile at a time:
`InputPadder` (replicate, centred, to a multiple of 32), ConvBlock and
ResBlocks with eval-mode batch norms, the deformable convolution of
blocks 3 and 4 computed tap by tap from its definition (each of the nine
taps read bilinearly at p + p_k + offset, zeros outside the map, then
its 1x1 product), the aggregation and score head, `DKD.forward` in top-K
mode (`simple_nms`, the border zeroing, `torch.topk`, the unfolded 5x5
soft-argmax against `hw_grid`, `grid_sample` of the score) and
`SDDH.forward` (`get_patches`, `offset_conv`, `grid_sample`, `sf_conv`,
the `einsum` with `agg_weights`). `precision` names the operand
precision of every convolution and product ("f32": TF32 off, as the
caller's `full_f32` block sets); sampling, norms and softmax stay
float32.

Weights are a flat dict of the published state-dict names
(`block1.conv1.weight`, `block3.conv1.offset_conv.weight`, ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from h100_bench.reference.precision import round_to

C1, C2, C3, C4 = 16, 32, 64, 128
DIM, K_PATCH, N_POS = 128, 3, 16
BN_EPS = 1e-5
DIVISOR = 32
RADIUS = 2
TEMPERATURE = 0.1


def _conv(x, w, b, precision: str, padding: int = 0):
    return F.conv2d(round_to(x, precision), round_to(w, precision), b,
                    padding=padding)


def _bn(t: dict, name: str, x):
    return F.batch_norm(x, t[name + ".running_mean"],
                        t[name + ".running_var"], t[name + ".weight"],
                        t[name + ".bias"], False, 0.0, BN_EPS)


def bilinear_zeros(x: torch.Tensor, py: torch.Tensor,
                   px: torch.Tensor) -> torch.Tensor:
    """x (C, H, W) read at pixel positions (py, px) (...): the four
    neighbours' weighted sum, a neighbour outside the map reading 0
    (torchvision's `deform_conv2d` and `grid_sample`'s zeros padding with
    align_corners) -> (C, ...)."""
    _, h, w = x.shape
    y0, x0 = torch.floor(py), torch.floor(px)
    out = 0.0
    for yc, wy in ((y0, 1 - (py - y0)), (y0 + 1, py - y0)):
        for xc, wx in ((x0, 1 - (px - x0)), (x0 + 1, px - x0)):
            inside = (yc >= 0) & (yc <= h - 1) & (xc >= 0) & (xc <= w - 1)
            v = x[:, yc.clamp(0, h - 1).long(), xc.clamp(0, w - 1).long()]
            out = out + v * torch.where(inside, wy * wx, 0.0)
    return out


def deform_conv(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                precision: str) -> torch.Tensor:
    """3x3 deformable convolution, padding 1, stride 1, no mask, from its
    definition: out[o, p] = sum_k sum_c W[o, c, k] x[c](p + p_k +
    (offset[2k], offset[2k + 1])), (dy, dx) order. x (B, C, H, W),
    offset (B, 18, H, W), weight (O, C, 3, 3)."""
    b, _, h, w = x.shape
    ys = torch.arange(h, device=x.device, dtype=x.dtype)[:, None]
    xs = torch.arange(w, device=x.device, dtype=x.dtype)[None, :]
    out = []
    for i in range(b):
        acc = 0.0
        for k in range(9):
            ki, kj = divmod(k, 3)
            py = ys + (ki - 1) + offset[i, 2 * k]
            px = xs + (kj - 1) + offset[i, 2 * k + 1]
            tap = bilinear_zeros(x[i], py, px)                  # (C, H, W)
            acc = acc + torch.einsum(
                "oc,chw->ohw", round_to(weight[:, :, ki, kj], precision),
                round_to(tap, precision))
        out.append(acc)
    return torch.stack(out)


def _deformable(t: dict, name: str, x, precision: str):
    h, w = x.shape[2:]
    max_offset = max(h, w) / 4.0
    offset = _conv(x, t[name + ".offset_conv.weight"],
                   t[name + ".offset_conv.bias"], precision, 1)
    offset = offset.clamp(-max_offset, max_offset)
    return deform_conv(x, offset, t[name + ".regular_conv.weight"],
                       precision)


def _block_conv(t, name, x, deformable: bool, precision: str):
    if deformable:
        return _deformable(t, name, x, precision)
    return _conv(x, t[name + ".weight"], None, precision, 1)


def conv_block(t, name, x, precision):
    x = F.selu(_bn(t, name + ".bn1", _block_conv(t, name + ".conv1", x,
                                                 False, precision)))
    return F.selu(_bn(t, name + ".bn2", _block_conv(t, name + ".conv2", x,
                                                    False, precision)))


def res_block(t, name, x, deformable: bool, precision: str):
    out = F.selu(_bn(t, name + ".bn1", _block_conv(
        t, name + ".conv1", x, deformable, precision)))
    out = _bn(t, name + ".bn2", _block_conv(t, name + ".conv2", out,
                                            deformable, precision))
    out = out + _conv(x, t[name + ".downsample.weight"],
                      t[name + ".downsample.bias"], precision)
    return F.selu(out)


def _pads(h: int, w: int) -> list:
    """`InputPadder(h, w, 32)._pad`: [left, right, top, bottom]."""
    ph = (((h // DIVISOR) + 1) * DIVISOR - h) % DIVISOR
    pw = (((w // DIVISOR) + 1) * DIVISOR - w) % DIVISOR
    return [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2]


def dense(t: dict, image: torch.Tensor, precision: str) -> tuple:
    """`extract_dense_map` of (B, 1, H, W) gray in [0, 1] -> (feature map
    (B, 128, H, W) L2-normalised, score map (B, 1, H, W))."""
    image = image.expand(-1, 3, -1, -1)            # grayscale_to_rgb
    h, w = image.shape[2:]
    pad = _pads(h, w)
    x = F.pad(image, pad, mode="replicate")
    x1 = conv_block(t, "block1", x, precision)
    x2 = res_block(t, "block2", F.avg_pool2d(x1, 2), False, precision)
    x3 = res_block(t, "block3", F.avg_pool2d(x2, 4), True, precision)
    x4 = res_block(t, "block4", F.avg_pool2d(x3, 4), True, precision)
    x1 = F.selu(_conv(x1, t["conv1.weight"], None, precision))
    x2 = F.selu(_conv(x2, t["conv2.weight"], None, precision))
    x3 = F.selu(_conv(x3, t["conv3.weight"], None, precision))
    x4 = F.selu(_conv(x4, t["conv4.weight"], None, precision))
    up = [F.interpolate(v, scale_factor=s, mode="bilinear",
                        align_corners=True)
          for v, s in ((x2, 2), (x3, 8), (x4, 32))]
    x1234 = torch.cat([x1, *up], 1)
    s = F.selu(_conv(x1234, t["score_head.0.weight"], None, precision))
    s = F.selu(_conv(s, t["score_head.2.weight"], None, precision, 1))
    s = F.selu(_conv(s, t["score_head.4.weight"], None, precision, 1))
    score = torch.sigmoid(_conv(s, t["score_head.6.weight"], None,
                                precision, 1))
    feat = F.normalize(x1234, p=2, dim=1)
    ht, wd = x.shape[2:]
    crop = (slice(None), slice(None), slice(pad[2], ht - pad[3]),
            slice(pad[0], wd - pad[1]))
    return feat[crop], score[crop]


def simple_nms(scores: torch.Tensor, nms_radius: int) -> torch.Tensor:
    """The published `simple_nms` of (B, 1, H, W) scores."""
    zeros = torch.zeros_like(scores)

    def pool(x):
        return F.max_pool2d(x, nms_radius * 2 + 1, stride=1,
                            padding=nms_radius)

    max_mask = scores == pool(scores)
    for _ in range(2):
        supp_mask = pool(max_mask.float()) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == pool(supp_scores)
        max_mask = max_mask | (new_max_mask & (~supp_mask))
    return torch.where(max_mask, scores, zeros)


def hw_grid(device) -> torch.Tensor:
    x = torch.linspace(-RADIUS, RADIUS, 2 * RADIUS + 1, device=device)
    return torch.stack(torch.meshgrid([x, x], indexing="ij")).view(
        2, -1).t()[:, [1, 0]]


def dkd(score_map: torch.Tensor, top_k: int) -> tuple:
    """`DKD.forward` in top-K mode, image_size None: (keypoints (B, K, 2)
    in [-1, 1], scores (B, K), the top-K's NMS scores (B, K))."""
    b, _, h, w = score_map.shape
    nms = simple_nms(score_map, RADIUS)
    nms[:, :, :RADIUS, :] = 0
    nms[:, :, :, :RADIUS] = 0
    nms[:, :, -RADIUS:, :] = 0
    nms[:, :, :, -RADIUS:] = 0
    top = torch.topk(nms.view(b, -1), top_k)
    wh = torch.tensor([w - 1, h - 1], device=score_map.device)
    patches = F.unfold(score_map, kernel_size=2 * RADIUS + 1,
                       padding=RADIUS)
    grid = hw_grid(score_map.device).to(score_map)
    kpts, scores = [], []
    for i in range(b):
        idx = top.indices[i]
        patch = patches[i].t()[idx]
        xy_nms = torch.stack([idx % w, torch.div(idx, w,
                                                 rounding_mode="trunc")], 1)
        max_v = patch.max(dim=1).values[:, None]
        x_exp = ((patch - max_v) / TEMPERATURE).exp()
        xy_residual = x_exp @ grid / x_exp.sum(dim=1)[:, None]
        xy = (xy_nms + xy_residual) / wh * 2 - 1
        kpts.append(xy)
        scores.append(F.grid_sample(score_map[i][None], xy.view(1, 1, -1, 2),
                                    mode="bilinear",
                                    align_corners=True)[0, 0, 0, :])
    return torch.stack(kpts), torch.stack(scores), top.values


def get_patches(tensor: torch.Tensor, required_corners: torch.Tensor,
                ps: int) -> torch.Tensor:
    """The published `get_patches`: (N, C, ps, ps) patches of (C, H, W)
    at integer (N, 2) xy, the corner clamped to [0, w - 1 - ps]."""
    c, h, w = tensor.shape
    corner = (required_corners - ps / 2 + 1).long()
    corner[:, 0] = corner[:, 0].clamp(min=0, max=w - 1 - ps)
    corner[:, 1] = corner[:, 1].clamp(min=0, max=h - 1 - ps)
    offset = torch.arange(0, ps, device=tensor.device)
    x, y = torch.meshgrid(offset, offset, indexing="ij")
    patches = torch.stack((x, y)).permute(2, 1, 0).unsqueeze(2)
    patches = patches.to(corner) + corner[None, None]
    pts = patches.reshape(-1, 2)
    sampled = tensor.permute(1, 2, 0)[tuple(pts.T)[::-1]]
    sampled = sampled.reshape(ps, ps, -1, c)
    return sampled.permute(2, 3, 0, 1)


def sddh(t: dict, feat: torch.Tensor, keypoints: torch.Tensor,
         precision: str) -> torch.Tensor:
    """`SDDH.forward` (no mask, not conv2D): (B, C, H, W) map, (B, N, 2)
    keypoints in [-1, 1] -> (B, N, 128) descriptors."""
    b, c, h, w = feat.shape
    wh = torch.tensor([[w - 1, h - 1]], device=feat.device)
    max_offset = max(h, w) / 4.0
    out = []
    for i in range(b):
        xi, kptsi = feat[i], keypoints[i]
        kptsi_wh = (kptsi / 2 + 0.5) * wh
        n = len(kptsi)
        patch = get_patches(xi, kptsi_wh.long(), K_PATCH)
        off = F.selu(_conv(patch, t["desc_head.offset_conv.0.weight"],
                           t["desc_head.offset_conv.0.bias"], precision))
        off = _conv(off, t["desc_head.offset_conv.2.weight"],
                    t["desc_head.offset_conv.2.bias"], precision)
        off = off.clamp(-max_offset, max_offset)
        off = off[:, :, 0, 0].view(n, 2, N_POS).permute(0, 2, 1)
        pos = kptsi_wh.unsqueeze(1) + off
        pos = 2.0 * pos / wh[None] - 1
        pos = pos.reshape(1, n * N_POS, 1, 2)
        f = F.grid_sample(xi.unsqueeze(0), pos, mode="bilinear",
                          align_corners=True)
        f = f.reshape(c, n, N_POS, 1).permute(1, 0, 2, 3)
        f = F.selu(_conv(f, t["desc_head.sf_conv.weight"], None,
                         precision)).squeeze(-1)
        descs = torch.einsum("ncp,pcd->nd", round_to(f, precision),
                             round_to(t["desc_head.agg_weights"], precision))
        out.append(F.normalize(descs, p=2.0, dim=1))
    return torch.stack(out)


def extract(t: dict, image: torch.Tensor, max_keypoints: int,
            precision: str) -> dict:
    """(B, H, W) gray in [0, 1] -> keypoints (B, K, 2) pixel xy, scores,
    descriptors (B, K, 128), mask (B, K): a top-K slot holding an NMS
    maximum (every slot at full-size tiles)."""
    feat, score = dense(t, image[:, None].float(), precision)
    kpts, scores, nms = dkd(score, max_keypoints)
    desc = sddh(t, feat, kpts, precision)
    h, w = image.shape[1:]
    wh = torch.tensor([w - 1, h - 1], device=image.device)
    return {"keypoints": wh * (kpts + 1) / 2.0, "scores": scores,
            "descriptors": desc, "mask": nms > 0}


# -- random weights ---------------------------------------------------------

def _shapes() -> dict:
    """{name: shape} of ALIKED-n16's published state dict."""
    out = {}

    def bn(name, c):
        for s in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.{s}"] = (c,)
        out[f"{name}.num_batches_tracked"] = ()

    def conv(name, cin, cout, deformable):
        if deformable:
            out[f"{name}.offset_conv.weight"] = (18, cin, 3, 3)
            out[f"{name}.offset_conv.bias"] = (18,)
            out[f"{name}.regular_conv.weight"] = (cout, cin, 3, 3)
        else:
            out[f"{name}.weight"] = (cout, cin, 3, 3)

    for name, cin, cout, dcn, res in (("block1", 3, C1, False, False),
                                      ("block2", C1, C2, False, True),
                                      ("block3", C2, C3, True, True),
                                      ("block4", C3, C4, True, True)):
        conv(name + ".conv1", cin, cout, dcn)
        bn(name + ".bn1", cout)
        conv(name + ".conv2", cout, cout, dcn)
        bn(name + ".bn2", cout)
        if res:
            out[name + ".downsample.weight"] = (cout, cin, 1, 1)
            out[name + ".downsample.bias"] = (cout,)
    for i, cin in enumerate((C1, C2, C3, DIM), 1):
        out[f"conv{i}.weight"] = (DIM // 4, cin, 1, 1)
    for i, (cin, cout, k) in zip((0, 2, 4, 6), ((DIM, 8, 1), (8, 4, 3),
                                                (4, 4, 3), (4, 1, 3))):
        out[f"score_head.{i}.weight"] = (cout, cin, k, k)
    out["desc_head.offset_conv.0.weight"] = (2 * N_POS, DIM, K_PATCH, K_PATCH)
    out["desc_head.offset_conv.0.bias"] = (2 * N_POS,)
    out["desc_head.offset_conv.2.weight"] = (2 * N_POS, 2 * N_POS, 1, 1)
    out["desc_head.offset_conv.2.bias"] = (2 * N_POS,)
    out["desc_head.sf_conv.weight"] = (DIM, DIM, 1, 1)
    out["desc_head.agg_weights"] = (N_POS, DIM, DIM)
    return out


# std of a weight's normal draw as a multiple of 1 / sqrt(fan in), where
# it is not the LeCun draw (1) of SELU networks; and of the offset biases
WEIGHT_GAIN = {"offset_conv.weight": 0.5, "desc_head.offset_conv.0.weight": 11.0,
               "desc_head.offset_conv.2.weight": 2.0}
OFFSET_BIAS_STD = {"offset_conv.bias": 1.0, "desc_head.offset_conv.0.bias": 0.1,
                   "desc_head.offset_conv.2.bias": 2.0}


def _gain(table: dict, name: str, default: float) -> float:
    hits = [k for k in table if name.endswith(k)]
    return table[max(hits, key=len)] if hits else default


def aliked_tree(gen, device) -> dict:
    """Random ALIKED-n16 weights: convolutions normal with std gain /
    sqrt(fan in) (LeCun, gain 1, for SELU; `WEIGHT_GAIN` elsewhere),
    batch norms away from the identity (scale and running variance
    uniform in [0.5, 1.5], shift and running mean normal with std 0.1),
    the 1x1 projections' biases normal with std 0.1, the offset
    convolutions' biases normal (`OFFSET_BIAS_STD`): backbone offsets of
    about a pixel of their map and SDDH offsets of a few pixels, never
    zero."""
    out = {}
    for name, shape in _shapes().items():
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        if ".bn" in name and (name.endswith("weight")
                              or name.endswith("running_var")):
            t = 0.5 + torch.rand(shape, generator=gen, device=device)
        elif name.endswith("bias") or name.endswith("running_mean"):
            std = _gain(OFFSET_BIAS_STD, name, 0.1)
            t = std * torch.randn(shape, generator=gen, device=device)
        else:
            fan_in = 1
            for s in shape[1:]:
                fan_in *= s
            t = torch.randn(shape, generator=gen, device=device) \
                * _gain(WEIGHT_GAIN, name, 1.0) / fan_in ** 0.5
        out[name] = t
    return out


# std of a LightGlue kernel as a multiple of 1 / sqrt(fan in): a strong
# input projection (a softmax temperature for the descriptors' cosine)
# and weak residual branches, so the random matcher stays close to a
# nearest-neighbour match of the projected descriptors and leaves
# putatives for verification
LIGHTGLUE_GAIN = {"input_proj": 48.0, "out": 0.05, "dense2": 0.05}
MATCHABILITY_BIAS = 4.0


def lightglue_tree(gen, device, part: dict) -> dict:
    """Random LightGlue weights in the JAX layout the port and
    `reference/lightglue.py` read (dense layers {"kernel" (in, out),
    "bias"}), at the part's input_dim, descriptor_dim, n_layers and
    num_heads: kernels normal with std gain / sqrt(fan in)
    (`LIGHTGLUE_GAIN`, else 1), biases normal with std 0.02 (the
    matchability's `MATCHABILITY_BIAS`), layer norms' scales uniform in
    [0.8, 1.2] and shifts normal with std 0.02, the rotary frequencies
    normal with std 1."""
    d, n, heads = part["descriptor_dim"], part["n_layers"], part["num_heads"]

    def rand(*shape, std=1.0):
        return std * torch.randn(shape, generator=gen, device=device)

    def lin(din, dout, name=""):
        return {"kernel": rand(din, dout, std=LIGHTGLUE_GAIN.get(name, 1.0)
                               * din ** -0.5),
                "bias": rand(dout, std=0.02)}

    def ffn():
        return {"dense1": lin(2 * d, 2 * d),
                "norm": {"scale": 0.8 + 0.4 * torch.rand(
                    2 * d, generator=gen, device=device),
                    "bias": rand(2 * d, std=0.02)},
                "dense2": lin(2 * d, d, "dense2")}

    def head():
        m = lin(d, 1)
        m["bias"] = m["bias"] + MATCHABILITY_BIAS
        return {"matchability": m, "final_proj": lin(d, d)}

    tree = {"input_proj": lin(part["input_dim"], d, "input_proj"),
            "posenc": {"Wr": {"kernel": rand(2, d // heads // 2)}},
            "layers": [], "assign": [], "confidence": []}
    for i in range(n):
        tree["layers"].append({
            "self_attn": {"Wqkv": lin(d, 3 * d), "out": lin(d, d, "out"),
                          "ffn": ffn()},
            "cross_attn": {"to_qk": lin(d, d), "to_v": lin(d, d),
                           "out": lin(d, d, "out"), "ffn": ffn()}})
        tree["assign"].append(head())
        if i < n - 1:
            tree["confidence"].append({"token": lin(d, 1)})
    return tree


def random_tree(gen, device, part: dict) -> dict:
    """The random weights of an `aliked_lightglue` part: ALIKED-n16's
    (a flat dict of the published names) or LightGlue's."""
    if part["arch"] == "lightglue":
        return lightglue_tree(gen, device, part)
    return aliked_tree(gen, device)
