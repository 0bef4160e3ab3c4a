"""Plain LightGlue (Lindenberger et al., 2023; cvg/LightGlue
`lightglue.py`, SuperPoint features) at a static depth.

  input projection, learnable Fourier rotary encoding of the keypoints
  n_layers x (rotary self-attention + bidirectional cross-attention,
  each followed by an FFN on [x | message] with layer norm and GELU)
  the last layer's assignment head: sigmoid-log-double-softmax

Weights come as the tree of the bundled `.npz` (dense layers as
{"kernel" (in, out), "bias"}, Wqkv's columns in (head, head_dim, 3)
order). `precisions` names the operand precision of the trunk's
products ("trunk"), of attention ("attention") and of the input
projection and assignment head ("assignment").
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from h100_bench import flops as counts
from h100_bench.reference.precision import linear, round_to

NEG_INF = -1e9


def normalize(kpts: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Pixel keypoints (B, N, 2) -> [-1, 1] by the image size (B, 2)."""
    return (kpts - size[:, None] / 2) / (size.amax(-1) / 2)[:, None, None]


def attention(q, k, v, kmask, precision: str) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v over the unmasked keys; a row with no
    key gives zeros. q (B, H, Nq, hd), k and v (B, H, Nk, hd)."""
    scale = q.shape[-1] ** -0.5
    sim = round_to(q * scale, precision) @ round_to(k, precision).transpose(-1, -2)
    sim = sim.masked_fill(~kmask[:, None, None, :], float("-inf"))
    mx = sim.amax(-1, keepdim=True)
    p = torch.exp(sim - torch.where(mx == float("-inf"), 0.0, mx))
    den = p.sum(-1, keepdim=True)
    pv = round_to(p, precision) @ round_to(v, precision)
    return pv / den.clamp_min(1e-20)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([-x[..., 1::2], x[..., ::2]], -1).reshape(x.shape)


def _ffn(p: dict, x, message, prec: str) -> torch.Tensor:
    h = linear(torch.cat([x, message], -1), p["dense1"], prec)
    h = F.layer_norm(h, h.shape[-1:], p["norm"]["scale"], p["norm"]["bias"])
    return x + linear(F.gelu(h), p["dense2"], prec)


def _self_block(p, x, cos, sin, mask, heads: int, pr: dict):
    b, n, d = x.shape
    qkv = linear(x, p["Wqkv"], pr["trunk"]).reshape(b, n, heads, d // heads, 3)
    qkv = qkv.transpose(1, 2)
    q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
    q = q * cos[:, None] + _rotate_half(q) * sin[:, None]
    k = k * cos[:, None] + _rotate_half(k) * sin[:, None]
    ctx = attention(q, k, v, mask, pr["attention"])
    msg = linear(ctx.transpose(1, 2).reshape(b, n, d), p["out"], pr["trunk"])
    return _ffn(p["ffn"], x, msg, pr["trunk"])


def _cross_block(p, x0, x1, mask0, mask1, heads: int, pr: dict):
    b, _, d = x0.shape

    def split(t):
        return t.reshape(b, -1, heads, d // heads).transpose(1, 2)

    def merge(t):
        return linear(t.transpose(1, 2).reshape(b, -1, d), p["out"],
                      pr["trunk"])

    qk0, qk1 = (split(linear(x, p["to_qk"], pr["trunk"])) for x in (x0, x1))
    v0, v1 = (split(linear(x, p["to_v"], pr["trunk"])) for x in (x0, x1))
    m0 = merge(attention(qk0, qk1, v1, mask1, pr["attention"]))
    m1 = merge(attention(qk1, qk0, v0, mask0, pr["attention"]))
    return (_ffn(p["ffn"], x0, m0, pr["trunk"]),
            _ffn(p["ffn"], x1, m1, pr["trunk"]))


def log_assignment(tree: dict, data: dict, precisions: dict,
                   heads: int = 4) -> torch.Tensor:
    """data: kpts0 (B, M, 2), desc0 (B, M, D), mask0 (B, M), size0 (B, 2)
    as (w, h), and the same for side 1 -> log assignment (B, M+1, N+1),
    NEG_INF at invalid rows and columns of the match block."""
    pa = precisions["assignment"]
    enc = []
    x = []
    for s in "01":
        kn = normalize(data["kpts" + s], data["size" + s])
        proj = kn @ tree["posenc"]["Wr"]["kernel"]
        enc.append((torch.repeat_interleave(torch.cos(proj), 2, -1),
                    torch.repeat_interleave(torch.sin(proj), 2, -1)))
        desc = data["desc" + s]
        x.append(linear(desc, tree["input_proj"], pa)
                 if tree.get("input_proj") else desc)
    m0, m1 = data["mask0"], data["mask1"]
    x0, x1 = x
    for layer in tree["layers"]:
        x0 = _self_block(layer["self_attn"], x0, *enc[0], m0, heads, precisions)
        x1 = _self_block(layer["self_attn"], x1, *enc[1], m1, heads, precisions)
        x0, x1 = _cross_block(layer["cross_attn"], x0, x1, m0, m1, heads,
                              precisions)
    head = tree["assign"][len(tree["layers"]) - 1]
    md0, md1 = (linear(t, head["final_proj"], pa) for t in (x0, x1))
    dd = md0.shape[-1] ** 0.25
    sim = round_to(md0 / dd, pa) @ round_to(md1 / dd, pa).transpose(1, 2)
    z0 = linear(x0, head["matchability"], pa)[..., 0]
    z1 = linear(x1, head["matchability"], pa)[..., 0]
    valid = m0[:, :, None] & m1[:, None, :]
    sim = torch.where(valid, sim, NEG_INF)
    block = torch.log_softmax(sim, 2) + torch.log_softmax(sim, 1) \
        + F.logsigmoid(z0)[:, :, None] + F.logsigmoid(z1)[:, None, :]
    b, m, n = sim.shape
    out = sim.new_zeros((b, m + 1, n + 1))
    out[:, :m, :n] = torch.where(valid, block, NEG_INF)
    out[:, :m, n] = torch.where(m0, F.logsigmoid(-z0), NEG_INF)
    out[:, m, :n] = torch.where(m1, F.logsigmoid(-z1), NEG_INF)
    return out


def attention_calls(cfg: dict, m: int, n: int) -> list:
    """(nq, nk) of each attention one tile pair of m and n keypoints
    runs: per layer self-attention of each side and cross-attention both
    ways."""
    return [(m, m), (n, n), (m, n), (n, m)] * cfg["n_layers"]


def flops(cfg: dict, m: int, n: int) -> float:
    """Product FLOPs of one tile pair of m and n keypoints: the input
    projection (where the weights carry one), per layer the self block
    of each side (Wqkv, out, the FFN [2d -> 2d -> d]) and the cross
    block (to_qk, to_v, out, the FFN), every attention, and the last
    layer's assignment head (final projection, similarity,
    matchability)."""
    d, s = cfg["descriptor_dim"], m + n
    hd = d // cfg["num_heads"]
    total = 2.0 * s * d * d if cfg["input_proj"] else 0.0
    per_layer = 2.0 * s * (3 * d * d + d * d + 4 * d * d + 2 * d * d) \
        + 2.0 * s * (3 * d * d + 4 * d * d + 2 * d * d)
    total += cfg["n_layers"] * per_layer
    total += sum(counts.attention(1, cfg["num_heads"], a, b, hd)
                 for a, b in attention_calls(cfg, m, n))
    return total + 2.0 * s * d * d + 2.0 * m * n * d + 2.0 * s * d
