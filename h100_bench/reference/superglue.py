"""Plain SuperGlue (Sarlin et al., 2020; magicleap
SuperGluePretrainedNetwork `models/superglue.py`, outdoor).

  keypoint encoder MLP [3, 32, 64, 128, 256, 256] (batch norm, ReLU) on
  (x, y, score), added to the descriptor
  gnn_layers alternating self / cross attentional propagation (4 heads,
  channel c of a projection is head c % H, dimension c // H), each a
  residual MLP [2d, 2d, d] on [x | message]
  final projection, scores <md0, md1> / sqrt(d)
  log-space Sinkhorn with a learned dustbin, marginals from the valid
  counts

Weights come as the tree the benchmark draws (dense layers as
{"kernel" (in, out), "bias"}, batch norm as {"scale", "bias", "mean",
"var"}). `precisions` names the operand precision of the trunk's
products ("trunk") and of attention ("attention"); the Sinkhorn runs in
float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from h100_bench import flops as counts
from h100_bench.reference.lightglue import attention
from h100_bench.reference.precision import linear, round_to

NEG = -1e9
BN_EPS = 1e-5


def _mlp(layers: list, x: torch.Tensor, prec: str) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = linear(x, layer["dense"], prec)
        if "bn" in layer:
            bn = layer["bn"]
            x = (x - bn["mean"]) * torch.rsqrt(bn["var"] + BN_EPS) \
                * bn["scale"] + bn["bias"]
        if i < len(layers) - 1:
            x = F.relu(x)
    return x


def _propagate(p: dict, x, source, src_mask, heads: int, pr: dict):
    b, n, d = x.shape

    def split(t):       # channel c -> (head c % H, dim c // H)
        return t.reshape(b, -1, d // heads, heads).permute(0, 3, 1, 2)

    q = split(linear(x, p["q"], pr["trunk"]))
    k = split(linear(source, p["k"], pr["trunk"]))
    v = split(linear(source, p["v"], pr["trunk"]))
    ctx = attention(q, k, v, src_mask, pr["attention"])
    msg = linear(ctx.permute(0, 2, 3, 1).reshape(b, n, d), p["merge"],
                 pr["trunk"])
    return _mlp(p["mlp"], torch.cat([x, msg], -1), pr["trunk"])


def _sinkhorn(scores, alpha, iters: int, mask0, mask1) -> torch.Tensor:
    b, m, n = scores.shape
    ms = mask0.sum(-1).float()
    ns = mask1.sum(-1).float()
    scores = torch.where(mask0[:, :, None] & mask1[:, None, :], scores, NEG)
    bins0 = torch.where(mask0, alpha, NEG)[:, :, None]
    bins1 = torch.where(mask1, alpha, NEG)[:, None, :]
    Z = torch.cat([torch.cat([scores, bins0], -1),
                   torch.cat([bins1, alpha.expand(b, 1, 1)], -1)], 1)
    norm = -torch.log(ms + ns)
    log_mu = torch.cat([torch.where(mask0, norm[:, None], NEG),
                        (torch.log(ns) + norm)[:, None]], -1)
    log_nu = torch.cat([torch.where(mask1, norm[:, None], NEG),
                        (torch.log(ms) + norm)[:, None]], -1)
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(Z + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(Z + u[:, :, None], dim=1)
    return Z + u[:, :, None] + v[:, None, :] - norm[:, None, None]


def log_assignment(tree: dict, data: dict, precisions: dict, heads: int = 4,
                   sinkhorn_iterations: int = 20) -> torch.Tensor:
    """data: kpts0 (B, M, 2), desc0 (B, M, D), scores0 (B, M), mask0
    (B, M), size0 (B, 2) as (w, h), and side 1 -> log assignment
    (B, M+1, N+1) after the Sinkhorn."""
    pt = precisions["trunk"]
    x = []
    for s in "01":
        size = data["size" + s]
        kn = (data["kpts" + s] - size[:, None] / 2) \
            / (0.7 * size.amax(-1))[:, None, None]
        enc = _mlp(tree["kenc"], torch.cat([kn, data["scores" + s][..., None]],
                                           -1), pt)
        x.append(data["desc" + s] + enc)
    x0, x1 = x
    m0, m1 = data["mask0"], data["mask1"]
    gnn = tree["gnn"]
    for i in range(0, len(gnn), 2):
        x0 = x0 + _propagate(gnn[i], x0, x0, m0, heads, precisions)
        x1 = x1 + _propagate(gnn[i], x1, x1, m1, heads, precisions)
        d0 = _propagate(gnn[i + 1], x0, x1, m1, heads, precisions)
        d1 = _propagate(gnn[i + 1], x1, x0, m0, heads, precisions)
        x0, x1 = x0 + d0, x1 + d1
    md0, md1 = (linear(t, tree["final_proj"], pt) for t in (x0, x1))
    sim = round_to(md0, pt) @ round_to(md1, pt).transpose(1, 2)
    sim = sim / md0.shape[-1] ** 0.5
    return _sinkhorn(sim, tree["bin_score"], sinkhorn_iterations, m0, m1)


def random_tree(generator: torch.Generator, device, cfg: dict) -> dict:
    """SuperGlue weights at the widths of `cfg` (descriptor_dim,
    keypoint_encoder, gnn_layers) drawn from `generator` on `device` in
    one call: dense kernels normal with std 1 / sqrt(fan_in), biases
    zero, batch norms the identity, bin score 1.0."""
    d = cfg["descriptor_dim"]
    shapes = []

    def mlp(channels):
        out = []
        for i in range(1, len(channels)):
            shapes.append((channels[i - 1], channels[i]))
            out.append({"dense": len(shapes) - 1,
                        "bn": channels[i] if i < len(channels) - 1 else None})
        return out

    kenc = mlp([3, *cfg["keypoint_encoder"], d])
    gnn = []
    for _ in range(cfg["gnn_layers"]):
        layer = {}
        for name in ("q", "k", "v", "merge"):
            shapes.append((d, d))
            layer[name] = len(shapes) - 1
        layer["mlp"] = mlp([2 * d, 2 * d, d])
        gnn.append(layer)
    shapes.append((d, d))
    final = len(shapes) - 1
    sizes = [a * b for a, b in shapes]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    kernels = [c.reshape(s) / s[0] ** 0.5
               for c, s in zip(flat.split(sizes), shapes)]

    def dense(i):
        return {"kernel": kernels[i],
                "bias": torch.zeros(shapes[i][1], device=device)}

    def build_mlp(spec):
        out = []
        for layer in spec:
            node = {"dense": dense(layer["dense"])}
            if layer["bn"]:
                c = layer["bn"]
                node["bn"] = {"scale": torch.ones(c, device=device),
                              "bias": torch.zeros(c, device=device),
                              "mean": torch.zeros(c, device=device),
                              "var": torch.ones(c, device=device)}
            out.append(node)
        return out

    return {"kenc": build_mlp(kenc),
            "gnn": [{**{n: dense(g[n]) for n in ("q", "k", "v", "merge")},
                     "mlp": build_mlp(g["mlp"])} for g in gnn],
            "final_proj": dense(final),
            "bin_score": torch.tensor(1.0, device=device)}


def attention_calls(cfg: dict, m: int, n: int) -> list:
    """(nq, nk) of each attention one tile pair runs: even layers attend
    within each side, odd layers across, both ways."""
    out = []
    for i in range(cfg["gnn_layers"]):
        out += [(m, m), (n, n)] if i % 2 == 0 else [(m, n), (n, m)]
    return out


def flops(cfg: dict, m: int, n: int) -> float:
    """Product FLOPs of one tile pair of m and n keypoints: the keypoint
    encoder MLP on each keypoint, per layer each side's q, k, v, merge
    and MLP [2d -> 2d -> d], every attention, the final projection and
    the similarity (the Sinkhorn is element-wise)."""
    d, s = cfg["descriptor_dim"], m + n
    hd = d // cfg["num_heads"]
    chans = [3, *cfg["keypoint_encoder"], d]
    total = sum(2.0 * s * a * b for a, b in zip(chans, chans[1:]))
    total += cfg["gnn_layers"] * 2.0 * s * (4 * d * d + 4 * d * d + 2 * d * d)
    total += sum(counts.attention(1, cfg["num_heads"], a, b, hd)
                 for a, b in attention_calls(cfg, m, n))
    return total + 2.0 * s * d * d + 2.0 * m * n * d
