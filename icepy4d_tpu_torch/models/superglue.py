"""SuperGlue matcher in PyTorch (counterpart of
`icepy4d_tpu/models/superglue.py`).

  keypoint encoder MLP [3, 32, 64, 128, 256, 256] on (x, y, score)
  18 alternating self / cross attentional-propagation layers (4 heads)
  final projection, scores = <md0, md1> / sqrt(D)
  log-space Sinkhorn optimal transport with a learned dustbin
  mutual-max + threshold match extraction

Inputs are padded keypoint sets with validity masks. The Sinkhorn
marginals use the runtime valid counts, so a padded problem solves the
transport of the unpadded one. Every layer's attention goes through
`ops.attention.masked_attention` (the CUDA kernel on the card) unless
the caller passes another function as `attn`.

Head layout. The published checkpoints split a projection's channels
as c = d * H + h (head h, head-dim d). This module keeps its q, k and v
rows and the merge's input columns permuted to c' = h * hd + d instead
(`HEAD_ORDER`, applied once by the converters in `models/convert.py`),
so the heads are unit-stride (B, N, H, hd) views that the kernel reads
in place, and the kernel's output reshapes to the merge's input without
a copy. The permutation changes no result.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.models.lightglue import filter_matches
from icepy4d_tpu_torch.ops.attention import masked_attention

NEG = -1e9
BN_EPS = 1e-5


def head_order(d: int, num_heads: int) -> np.ndarray:
    """Channel permutation from the checkpoint order (c = d * H + h) to
    the head-major order: row c' = h * hd + d of the permuted weight is
    row `perm[c']` of the checkpoint's."""
    hd = d // num_heads
    c = np.arange(d)
    return (c % hd) * num_heads + c // hd


def normalize_keypoints(kpts: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """size (..., 2) = (width, height); centre and scale by 0.7 * the
    larger side."""
    size = size.to(kpts.dtype)
    center = size / 2.0
    scaling = size.amax(-1, keepdim=True) * 0.7
    return (kpts - center[..., None, :]) / scaling[..., None, :]


class BatchNorm(nn.Module):
    """Inference batch norm over the last (channel) dim, with the JAX
    package's parameter names and arithmetic order."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) * torch.rsqrt(self.var + BN_EPS) \
            * self.weight + self.bias


def _mlp_module(channels: list[int]) -> nn.ModuleList:
    """Dense layers with batch norm on all but the last."""
    out = nn.ModuleList()
    for i in range(1, len(channels)):
        layer = nn.ModuleDict({"dense": nn.Linear(channels[i - 1],
                                                  channels[i])})
        if i < len(channels) - 1:
            layer["bn"] = BatchNorm(channels[i])
        out.append(layer)
    return out


def _mlp(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    n = len(layers)
    for i, layer in enumerate(layers):
        x = layer["dense"](x)
        if "bn" in layer:
            x = layer["bn"](x)
        if i < n - 1:
            x = F.relu(x)
    return x


def keypoint_encoder(layers: nn.ModuleList, kpts_n: torch.Tensor,
                     scores: torch.Tensor) -> torch.Tensor:
    return _mlp(layers, torch.cat([kpts_n, scores[..., None]], -1))


def attn_propagation(p: nn.ModuleDict, x: torch.Tensor, source: torch.Tensor,
                     src_mask: torch.Tensor, num_heads: int,
                     attn=None) -> torch.Tensor:
    """MLP([x | merge(MHA(x, source, source))]), heads head-major."""
    b, n, d = x.shape
    hd = d // num_heads

    def heads(t):
        return t.view(b, -1, num_heads, hd).transpose(1, 2)

    q = heads(p["q"](x))
    k = heads(p["k"](source))
    v = heads(p["v"](source))
    ctx = (attn or masked_attention)(q, k, v, src_mask)    # (B, H, N, hd)
    message = p["merge"](ctx.transpose(1, 2).reshape(b, n, d))
    return _mlp(p["mlp"], torch.cat([x, message], -1))


def log_sinkhorn(Z: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                 iters: int) -> torch.Tensor:
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(Z + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(Z + u[:, :, None], dim=1)
    return Z + u[:, :, None] + v[:, None, :]


def log_optimal_transport(scores: torch.Tensor, alpha: torch.Tensor,
                          iters: int, mask0: torch.Tensor,
                          mask1: torch.Tensor) -> torch.Tensor:
    """Masked optimal transport: the marginals use the runtime valid
    counts; padded rows and columns get ~zero mass."""
    b, m, n = scores.shape
    ms = mask0.sum(-1).to(scores.dtype)
    ns = mask1.sum(-1).to(scores.dtype)
    alpha = alpha.to(scores.dtype)
    scores = torch.where(mask0[:, :, None] & mask1[:, None, :], scores, NEG)
    bins0 = torch.where(mask0, alpha, NEG)[:, :, None]
    bins1 = torch.where(mask1, alpha, NEG)[:, None, :]
    couplings = torch.cat([
        torch.cat([scores, bins0], -1),
        torch.cat([bins1, alpha.expand(b, 1, 1)], -1)], 1)
    norm = -torch.log(ms + ns)
    log_mu = torch.cat([torch.where(mask0, norm[:, None], NEG),
                        (torch.log(ns) + norm)[:, None]], -1)
    log_nu = torch.cat([torch.where(mask1, norm[:, None], NEG),
                        (torch.log(ms) + norm)[:, None]], -1)
    Z = log_sinkhorn(couplings, log_mu, log_nu, iters)
    return Z - norm[:, None, None]


class SuperGlue(nn.Module):
    """Batched SuperGlue.

    match(data) with data = dict(kpts0 (B,M,2), desc0 (B,M,D),
    scores0 (B,M), mask0 (B,M), size0 (B,2) as (w, h), and the same for
    side 1) -> dict(matches0 (B,M) int32, matches1, mscores0, mscores1,
    log_assignment (B,M+1,N+1)).

    Parameter names follow the JAX tree (kenc, gnn, final_proj,
    bin_score); `models.convert.superglue_params` loads a JAX tree and
    `load_torch_superglue` an official checkpoint, both into the
    head-major layout.
    """

    def __init__(self, descriptor_dim: int = 256,
                 keypoint_encoder: tuple = (32, 64, 128, 256),
                 gnn_layers: int = 18, num_heads: int = 4,
                 sinkhorn_iterations: int = 100,
                 match_threshold: float = 0.2, device=None):
        super().__init__()
        if gnn_layers % 2:
            raise ValueError("gnn layers must alternate self / cross in "
                             "pairs")
        self.device = resolve_device(device)
        d = descriptor_dim
        self.descriptor_dim = d
        self.num_heads = num_heads
        self.sinkhorn_iterations = int(sinkhorn_iterations)
        self.match_threshold = float(match_threshold)
        self.kenc = _mlp_module([3, *keypoint_encoder, d])
        self.gnn = nn.ModuleList(
            nn.ModuleDict({"q": nn.Linear(d, d), "k": nn.Linear(d, d),
                           "v": nn.Linear(d, d), "merge": nn.Linear(d, d),
                           "mlp": _mlp_module([2 * d, 2 * d, d])})
            for _ in range(gnn_layers))
        self.final_proj = nn.Linear(d, d)
        self.bin_score = nn.Parameter(torch.tensor(1.0))
        self.to(self.device).eval()

    @torch.inference_mode()
    def match(self, data: dict, attn=None) -> dict:
        """`attn` replaces every layer's attention (the default is
        `ops.attention.masked_attention`)."""
        data = {k: v.to(self.device) if isinstance(v, torch.Tensor) else v
                for k, v in data.items()}
        return self._match(data, attn)

    def _match(self, data: dict, attn=None) -> dict:
        mask0, mask1 = data["mask0"], data["mask1"]
        kn0 = normalize_keypoints(data["kpts0"], data["size0"])
        kn1 = normalize_keypoints(data["kpts1"], data["size1"])
        d0 = data["desc0"].float() + keypoint_encoder(self.kenc, kn0,
                                                      data["scores0"])
        d1 = data["desc1"].float() + keypoint_encoder(self.kenc, kn1,
                                                      data["scores1"])
        nh = self.num_heads
        for i in range(0, len(self.gnn), 2):
            sl, cl = self.gnn[i], self.gnn[i + 1]
            d0 = d0 + attn_propagation(sl, d0, d0, mask0, nh, attn)
            d1 = d1 + attn_propagation(sl, d1, d1, mask1, nh, attn)
            delta0 = attn_propagation(cl, d0, d1, mask1, nh, attn)
            delta1 = attn_propagation(cl, d1, d0, mask0, nh, attn)
            d0, d1 = d0 + delta0, d1 + delta1

        md0 = self.final_proj(d0)
        md1 = self.final_proj(d1)
        sim = torch.bmm(md0, md1.transpose(1, 2)) / self.descriptor_dim ** 0.5
        scores = log_optimal_transport(sim, self.bin_score,
                                       self.sinkhorn_iterations, mask0, mask1)
        matches0, matches1, ms0, ms1 = filter_matches(scores,
                                                      self.match_threshold)
        return {"matches0": torch.where(mask0, matches0, -1),
                "matches1": torch.where(mask1, matches1, -1),
                "mscores0": torch.where(mask0, ms0, 0.0),
                "mscores1": torch.where(mask1, ms1, 0.0),
                "log_assignment": scores}


def superglue_tree(descriptor_dim: int = 256,
                   keypoint_encoder: tuple = (32, 64, 128, 256),
                   gnn_layers: int = 18, seed: int = 0) -> dict:
    """Random parameters in the JAX layout, drawn as the JAX package's
    `SuperGlue.init(seed)` draws them (numpy's default_rng(seed)), so
    both packages hold the same random weights for one seed."""
    d = descriptor_dim
    npr = np.random.default_rng(seed)

    def lin(din, dout):
        return {"kernel": (npr.normal(size=(din, dout)) / np.sqrt(din)
                           ).astype(np.float32),
                "bias": np.zeros((dout,), np.float32)}

    def mlp(channels):
        out = []
        for i in range(1, len(channels)):
            layer = {"dense": lin(channels[i - 1], channels[i])}
            if i < len(channels) - 1:
                c = channels[i]
                layer["bn"] = {"scale": np.ones(c, np.float32),
                               "bias": np.zeros(c, np.float32),
                               "mean": np.zeros(c, np.float32),
                               "var": np.ones(c, np.float32)}
            out.append(layer)
        return out

    params = {"kenc": mlp([3, *keypoint_encoder, d]), "gnn": [],
              "final_proj": lin(d, d), "bin_score": np.float32(1.0)}
    for _ in range(gnn_layers):
        params["gnn"].append({"q": lin(d, d), "k": lin(d, d),
                              "v": lin(d, d), "merge": lin(d, d),
                              "mlp": mlp([2 * d, 2 * d, d])})
    return params
