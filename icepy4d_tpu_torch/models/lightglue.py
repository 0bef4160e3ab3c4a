"""LightGlue matcher in PyTorch (counterpart of the `match` and
`match_adaptive` forwards of `icepy4d_tpu/models/lightglue.py`).

  learnable Fourier rotary positional encoding
  n_layers x (rotary self-attention + bidirectional cross-attention,
              each followed by a concat-FFN)
  sigmoid-log-double-softmax match assignment
  mutual-max + threshold match extraction

Inputs are padded keypoint sets with validity masks; attention and the
assignment are mask-aware. Every self and cross block's attention goes
through `ops.attention.masked_attention` (the CUDA kernel on the card)
unless the caller passes another function as `attn`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.ops.attention import masked_attention

NEG_INF = -1e9


def normalize_keypoints(kpts: torch.Tensor, size) -> torch.Tensor:
    """Pixel kpts (..., N, 2) -> [-1, 1] by image size (..., 2) as (w, h),
    or by the keypoints' extent when size is None."""
    if size is None:
        size = 1.0 + kpts.amax(-2) - kpts.amin(-2)
    else:
        size = torch.as_tensor(size, dtype=kpts.dtype, device=kpts.device)
    shift = size / 2.0
    scale = size.amax(-1) / 2.0
    return (kpts - shift[..., None, :]) / scale[..., None, None]


def _linear(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    # weights cast to the activation dtype: a bf16 trunk runs bf16 matmuls
    if isinstance(p, nn.Identity):
        return x
    bias = None if p.bias is None else p.bias.to(x.dtype)
    return F.linear(x, p.weight.to(x.dtype), bias)


def _layer_norm(p: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    # statistics in f32 whatever the activation dtype
    y = F.layer_norm(x.float(), p.normalized_shape, p.weight, p.bias, p.eps)
    return y.to(x.dtype)


def _ffn(p: nn.Module, x: torch.Tensor, message: torch.Tensor) -> torch.Tensor:
    """x + FFN([x | message]); GELU is the exact erf form."""
    h = _linear(p.dense1, torch.cat([x, message], -1))
    h = F.gelu(_layer_norm(p.norm, h))
    return x + _linear(p.dense2, h)


def rotary_encoding(p: nn.Module, kpts: torch.Tensor):
    """Learnable Fourier features -> (cos, sin), each (..., N, head_dim)."""
    proj = F.linear(kpts, p.Wr.weight)           # (..., N, head_dim / 2)
    return (torch.repeat_interleave(torch.cos(proj), 2, dim=-1),
            torch.repeat_interleave(torch.sin(proj), 2, dim=-1))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([-x[..., 1::2], x[..., ::2]], -1).reshape(x.shape)


def _apply_rotary(t: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor) -> torch.Tensor:
    """t (B,H,N,hd); cos/sin (B,N,hd) broadcast over heads."""
    return t * cos[:, None] + _rotate_half(t) * sin[:, None]


def self_block(p: nn.Module, x: torch.Tensor, enc, mask: torch.Tensor,
               num_heads: int, attn=None) -> torch.Tensor:
    b, n, d = x.shape
    hd = d // num_heads
    # column layout (H, hd, 3), as the reference unflattens Wqkv's output
    qkv = _linear(p.Wqkv, x).reshape(b, n, num_heads, hd, 3).transpose(1, 2)
    q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
    cos, sin = enc
    q = _apply_rotary(q, cos, sin)
    k = _apply_rotary(k, cos, sin)
    ctx = (attn or masked_attention)(q, k, v, mask)
    message = _linear(p.out, ctx.transpose(1, 2).reshape(b, n, d))
    return _ffn(p.ffn, x, message)


def cross_block(p: nn.Module, x0: torch.Tensor, x1: torch.Tensor,
                mask0: torch.Tensor, mask1: torch.Tensor, num_heads: int,
                attn=None) -> tuple[torch.Tensor, torch.Tensor]:
    b, n0, d = x0.shape
    n1 = x1.shape[1]
    hd = d // num_heads

    def heads(t):
        return t.reshape(b, -1, num_heads, hd).transpose(1, 2)

    qk0 = heads(_linear(p.to_qk, x0))
    qk1 = heads(_linear(p.to_qk, x1))
    v0 = heads(_linear(p.to_v, x0))
    v1 = heads(_linear(p.to_v, x1))
    run = attn or masked_attention
    m0 = run(qk0, qk1, v1, mask1)
    m1 = run(qk1, qk0, v0, mask0)
    m0 = _linear(p.out, m0.transpose(1, 2).reshape(b, n0, d))
    m1 = _linear(p.out, m1.transpose(1, 2).reshape(b, n1, d))
    return _ffn(p.ffn, x0, m0), _ffn(p.ffn, x1, m1)


def sigmoid_log_double_softmax(sim, z0, z1, mask0, mask1) -> torch.Tensor:
    """Log assignment matrix (B, M+1, N+1), mask-aware: invalid rows and
    columns get NEG_INF in the match block."""
    b, m, n = sim.shape
    pair_valid = mask0[:, :, None] & mask1[:, None, :]
    sim = torch.where(pair_valid, sim, NEG_INF)
    certainties = F.logsigmoid(z0)[:, :, None] + F.logsigmoid(z1)[:, None, :]
    block = torch.log_softmax(sim, 2) + torch.log_softmax(sim, 1) + certainties
    scores = sim.new_zeros((b, m + 1, n + 1))
    scores[:, :m, :n] = torch.where(pair_valid, block, NEG_INF)
    scores[:, :m, n] = torch.where(mask0, F.logsigmoid(-z0), NEG_INF)
    scores[:, m, :n] = torch.where(mask1, F.logsigmoid(-z1), NEG_INF)
    return scores


def match_assignment(p: nn.Module, d0, d1, mask0, mask1) -> torch.Tensor:
    # the assignment head always scores in f32
    d0, d1 = d0.float(), d1.float()
    md0 = _linear(p.final_proj, d0)
    md1 = _linear(p.final_proj, d1)
    dd = md0.shape[-1]
    sim = (md0 / dd ** 0.25) @ (md1 / dd ** 0.25).transpose(1, 2)
    z0 = _linear(p.matchability, d0)[..., 0]
    z1 = _linear(p.matchability, d1)[..., 0]
    return sigmoid_log_double_softmax(sim, z0, z1, mask0, mask1)


def matchability(p: nn.Module, d: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(_linear(p.matchability, d)[..., 0])


def token_confidence(p: nn.Module, d: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(_linear(p.token, d)[..., 0])


def filter_matches(scores: torch.Tensor, th: float):
    """Mutual-max match extraction from the log assignment.

    Returns (matches0 (B,M) int32, -1 = unmatched; matches1 (B,N);
    mscores0 (B,M); mscores1 (B,N)).
    """
    block = scores[:, :-1, :-1]
    b, m, n = block.shape
    m0 = block.argmax(2)
    m1 = block.argmax(1)
    max0 = block.amax(2)
    inds0 = torch.arange(m, device=scores.device)[None]
    inds1 = torch.arange(n, device=scores.device)[None]
    mutual0 = inds0 == torch.gather(m1, 1, m0)
    mutual1 = inds1 == torch.gather(m0, 1, m1)
    mscores0 = torch.where(mutual0, max0.exp(), 0.0)
    mscores1 = torch.where(mutual1, torch.gather(mscores0, 1, m1), 0.0)
    valid0 = mutual0 & (mscores0 > th)
    valid1 = mutual1 & torch.gather(valid0, 1, m1)
    matches0 = torch.where(valid0, m0, -1).to(torch.int32)
    matches1 = torch.where(valid1, m1, -1).to(torch.int32)
    return matches0, matches1, mscores0, mscores1


def _ffn_module(d: int) -> nn.ModuleDict:
    return nn.ModuleDict({"dense1": nn.Linear(2 * d, 2 * d),
                          "norm": nn.LayerNorm(2 * d),
                          "dense2": nn.Linear(2 * d, d)})


class LightGlue(nn.Module):
    """Batched LightGlue: `match` at static depth, `match_adaptive` with
    early exit and point pruning.

    match(data) where data = dict(
      kpts0 (B,M,2), desc0 (B,M,D), mask0 (B,M), size0 (B,2) or None,
      kpts1, desc1, mask1, size1)
    -> dict(matches0 (B,M) int32, matches1, mscores0, mscores1,
            log_assignment (B,M+1,N+1)).

    Module names follow the JAX parameter tree, so
    `models.convert.lightglue_params` output loads with load_state_dict.
    """

    def __init__(
        self,
        n_layers: int = 9,
        num_heads: int = 4,
        descriptor_dim: int = 256,
        input_dim: int = 256,
        filter_threshold: float = 0.1,
        activation_dtype: str = "float32",
        device=None,
    ):
        super().__init__()
        self.device = resolve_device(device)
        d = descriptor_dim
        self.n_layers = n_layers
        self.num_heads = num_heads
        self.filter_threshold = float(filter_threshold)
        # layer norm statistics, the attention softmax and the
        # assignment head stay f32 whatever this is
        self.activation_dtype = getattr(torch, str(activation_dtype))
        self.input_proj = nn.Linear(input_dim, d)
        self.posenc = nn.Module()
        self.posenc.Wr = nn.Linear(2, d // num_heads // 2, bias=False)
        self.layers = nn.ModuleList(
            nn.ModuleDict({
                "self_attn": nn.ModuleDict({
                    "Wqkv": nn.Linear(d, 3 * d), "out": nn.Linear(d, d),
                    "ffn": _ffn_module(d)}),
                "cross_attn": nn.ModuleDict({
                    "to_qk": nn.Linear(d, d), "to_v": nn.Linear(d, d),
                    "out": nn.Linear(d, d), "ffn": _ffn_module(d)}),
            }) for _ in range(n_layers))
        self.assign = nn.ModuleList(
            nn.ModuleDict({"matchability": nn.Linear(d, 1),
                           "final_proj": nn.Linear(d, d)})
            for _ in range(n_layers))
        self.confidence = nn.ModuleList(
            nn.ModuleDict({"token": nn.Linear(d, 1)})
            for _ in range(n_layers - 1))
        self.to(self.device).eval()

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """As nn.Module's; a state dict with no input_proj entries (the
        published checkpoints, whose projection is the identity when the
        descriptors are already descriptor_dim wide) makes input_proj
        the identity, as an empty input_proj does in the JAX package."""
        proj = self.input_proj
        if not any(k.startswith("input_proj.") for k in state_dict) \
                and isinstance(proj, nn.Linear) \
                and proj.in_features == proj.out_features:
            self.input_proj = nn.Identity()
        return super().load_state_dict(state_dict, strict, assign)

    def match_flops(self, batch: int, m: int, n: int | None = None) -> float:
        """Matmul FLOPs of one `match` over (batch, m, n) padded keypoint
        sets (2 * m * n * k a product; softmax, rotary, layer norm and
        the elementwise work left out), the JAX package's formula: the
        input projection (none when it is the identity, as after a state
        dict without input_proj), per layer the self block (Wqkv, out,
        the FFN and attention of each side) and the cross block (to_qk,
        to_v, out, the FFN, both attention directions), then the
        assignment head."""
        n = m if n is None else n
        d = self.layers[0].self_attn.out.in_features
        L = self.n_layers
        s = float(m + n)
        p = self.input_proj
        proj = 0.0 if isinstance(p, nn.Identity) else 2 * s * p.in_features * d
        self_b = 20 * d * d * s + 4 * d * (float(m) * m + float(n) * n)
        cross_b = 18 * s * d * d + 8 * float(m) * n * d
        assign = 2 * s * d * d + 2 * float(m) * n * d + 2 * s * d
        return float(batch * (proj + L * (self_b + cross_b) + assign))

    @torch.inference_mode()
    def match(self, data: dict, attn=None) -> dict:
        """`attn` replaces the attention of every block (the default is
        `ops.attention.masked_attention`)."""
        data = {k: v.to(self.device) if isinstance(v, torch.Tensor) else v
                for k, v in data.items()}
        return self._match(data, attn)

    def _match(self, data: dict, attn=None) -> dict:
        kpts0 = normalize_keypoints(data["kpts0"], data.get("size0"))
        kpts1 = normalize_keypoints(data["kpts1"], data.get("size1"))
        mask0, mask1 = data["mask0"], data["mask1"]
        d0 = _linear(self.input_proj, data["desc0"].float())
        d1 = _linear(self.input_proj, data["desc1"].float())
        enc0 = rotary_encoding(self.posenc, kpts0)
        enc1 = rotary_encoding(self.posenc, kpts1)

        act = self.activation_dtype
        d0, d1 = d0.to(act), d1.to(act)
        enc0 = tuple(e.to(act) for e in enc0)
        enc1 = tuple(e.to(act) for e in enc1)

        nh = self.num_heads
        for layer in self.layers:
            d0 = self_block(layer.self_attn, d0, enc0, mask0, nh, attn)
            d1 = self_block(layer.self_attn, d1, enc1, mask1, nh, attn)
            d0, d1 = cross_block(layer.cross_attn, d0, d1, mask0, mask1, nh,
                                 attn)

        scores = match_assignment(self.assign[-1], d0, d1, mask0, mask1)
        matches0, matches1, ms0, ms1 = filter_matches(
            scores, self.filter_threshold)
        return {
            "matches0": torch.where(mask0, matches0, -1),
            "matches1": torch.where(mask1, matches1, -1),
            "mscores0": torch.where(mask0, ms0, 0.0),
            "mscores1": torch.where(mask1, ms1, 0.0),
            "log_assignment": scores,
        }

    # -- adaptive depth and width ------------------------------------------

    def confidence_threshold(self, layer_index: int) -> float:
        """Token-confidence exit threshold after layer `layer_index`."""
        return 0.8 + 0.1 * float(np.exp(-4.0 * layer_index / self.n_layers))

    def _run_segment(self, layers, d0, d1, enc0, enc1, mask0, mask1,
                     attn=None):
        nh = self.num_heads
        for layer in layers:
            d0 = self_block(layer.self_attn, d0, enc0, mask0, nh, attn)
            d1 = self_block(layer.self_attn, d1, enc1, mask1, nh, attn)
            d0, d1 = cross_block(layer.cross_attn, d0, d1, mask0, mask1, nh,
                                 attn)
        return d0, d1

    @staticmethod
    def _gather_side(d, cos, sin, keep, cap: int):
        """Pack the `cap` highest-ranked tokens of one side: kept tokens
        first, each group in index order (a stable sort on the 0/1 keep
        scores, the order of the JAX package's top-k). Returns packed
        (d, cos, sin, mask, idx), idx mapping packed slot -> input slot."""
        idx = torch.sort(keep.to(torch.float32), dim=1, descending=True,
                         stable=True).indices[:, :cap]

        def take(a):
            return torch.gather(a, 1, idx[..., None].expand(
                -1, -1, a.shape[-1]))

        return (take(d), take(cos), take(sin), torch.gather(keep, 1, idx),
                idx)

    @torch.inference_mode()
    def match_adaptive(self, data: dict, depth_confidence: float = 0.95,
                       width_confidence: float = 0.99, check_every: int = 3,
                       min_capacity: int = 64, attn=None) -> dict:
        """Adaptive-depth and -width forward (counterpart of
        `LightGlue.match_adaptive` in the JAX package), in f32 whatever
        the activation dtype, as there.

        The layers run in segments of `check_every`. After each segment's
        last layer j: if the share of confident tokens (token confidence
        above `confidence_threshold(j)`), counted over the whole pair
        batch, reaches `depth_confidence`, the forward stops and layer
        j's assignment head gives the matches; otherwise tokens that are
        confident with matchability at most 1 - `width_confidence` are
        pruned: the rest are packed into a power-of-two capacity (at
        least `min_capacity`, and only when it is at most half the
        larger input side), the padding masked. Matches are mapped back
        to the input slots. Each segment's blocks run through
        `ops.attention.masked_attention` (or `attn`), so pruned segments
        launch the attention kernel at their packed shapes.

        Returns match()'s dict without "log_assignment", plus
        "layers_run" and "capacity" (side 0's final capacity)."""
        data = {k: v.to(self.device) if isinstance(v, torch.Tensor) else v
                for k, v in data.items()}
        mask0, mask1 = data["mask0"], data["mask1"]
        b, m = mask0.shape
        n = mask1.shape[1]
        d0 = _linear(self.input_proj, data["desc0"].float())
        d1 = _linear(self.input_proj, data["desc1"].float())
        enc0 = rotary_encoding(self.posenc, normalize_keypoints(
            data["kpts0"], data.get("size0")))
        enc1 = rotary_encoding(self.posenc, normalize_keypoints(
            data["kpts1"], data.get("size1")))
        dev = mask0.device
        idx0 = torch.arange(m, device=dev).expand(b, m)
        idx1 = torch.arange(n, device=dev).expand(b, n)

        start, exited_at = 0, self.n_layers
        assign = self.assign[-1]
        for j in range(check_every, self.n_layers, check_every):
            d0, d1 = self._run_segment(self.layers[start:j], d0, d1, enc0,
                                       enc1, mask0, mask1, attn)
            start, li = j, j - 1
            th = self.confidence_threshold(li)
            conf0 = (token_confidence(self.confidence[li], d0) > th) & mask0
            conf1 = (token_confidence(self.confidence[li], d1) > th) & mask1
            nvalid = int(mask0.sum() + mask1.sum())
            ratio = int(conf0.sum() + conf1.sum()) / max(nvalid, 1)
            if depth_confidence > 0 and ratio >= depth_confidence:
                exited_at, assign = j, self.assign[li]
                break
            if width_confidence > 0:
                prune_th = 1.0 - width_confidence
                keep0 = mask0 & (~conf0 | (matchability(
                    self.assign[li], d0) > prune_th))
                keep1 = mask1 & (~conf1 | (matchability(
                    self.assign[li], d1) > prune_th))
                cap = max(int(keep0.sum(1).max()) if b else 0,
                          int(keep1.sum(1).max()) if b else 0, min_capacity)
                cap = 1 << (cap - 1).bit_length()
                if cap <= max(m, n) // 2:
                    d0, c0, s0, mask0, g0 = self._gather_side(
                        d0, *enc0, keep0, cap)
                    d1, c1, s1, mask1, g1 = self._gather_side(
                        d1, *enc1, keep1, cap)
                    enc0, enc1 = (c0, s0), (c1, s1)
                    idx0 = torch.gather(idx0, 1, g0)
                    idx1 = torch.gather(idx1, 1, g1)
        else:
            d0, d1 = self._run_segment(self.layers[start:], d0, d1, enc0,
                                       enc1, mask0, mask1, attn)

        scores = match_assignment(assign, d0, d1, mask0, mask1)
        pm0, pm1, pms0, pms1 = filter_matches(scores, self.filter_threshold)
        pm0 = torch.where(mask0, pm0, -1)
        pm1 = torch.where(mask1, pm1, -1)
        pms0 = torch.where(mask0, pms0, 0.0)
        pms1 = torch.where(mask1, pms1, 0.0)

        def scatter(idx_self, idx_other, pm, pms, size):
            tgt = torch.where(pm > -1, torch.gather(
                idx_other, 1, pm.clamp_min(0).long()), -1)
            matches = torch.full((b, size), -1, dtype=torch.int32,
                                 device=dev)
            scores_out = torch.zeros((b, size), device=dev)
            return (matches.scatter_(1, idx_self, tgt.to(torch.int32)),
                    scores_out.scatter_(1, idx_self, pms))

        matches0, mscores0 = scatter(idx0, idx1, pm0, pms0, m)
        matches1, mscores1 = scatter(idx1, idx0, pm1, pms1, n)
        return {"matches0": matches0, "matches1": matches1,
                "mscores0": mscores0, "mscores1": mscores1,
                "layers_run": exited_at, "capacity": int(mask0.shape[1])}


def lightglue_tree(n_layers: int = 9, input_dim: int = 256,
                   descriptor_dim: int = 256, num_heads: int = 4,
                   seed: int = 0) -> dict:
    """Random parameters in the JAX layout, drawn as the JAX package's
    `LightGlue.init(seed)` draws them (numpy's default_rng(seed)), so
    both packages hold the same random weights for one seed."""
    d = descriptor_dim
    hd = d // num_heads
    npr = np.random.default_rng(seed)

    def lin(din, dout):
        return {"kernel": (npr.normal(size=(din, dout)) / np.sqrt(din)
                           ).astype(np.float32),
                "bias": np.zeros((dout,), np.float32)}

    def ffn():
        return {"dense1": lin(2 * d, 2 * d),
                "norm": {"scale": np.ones(2 * d, np.float32),
                         "bias": np.zeros(2 * d, np.float32)},
                "dense2": lin(2 * d, d)}

    params = {"input_proj": lin(input_dim, d),
              "posenc": {"Wr": {"kernel": npr.normal(
                  size=(2, hd // 2)).astype(np.float32)}},
              "layers": [], "assign": [], "confidence": []}
    for i in range(n_layers):
        params["layers"].append({
            "self_attn": {"Wqkv": lin(d, 3 * d), "out": lin(d, d),
                          "ffn": ffn()},
            "cross_attn": {"to_qk": lin(d, d), "to_v": lin(d, d),
                           "out": lin(d, d), "ffn": ffn()}})
        params["assign"].append({"matchability": lin(d, 1),
                                 "final_proj": lin(d, d)})
        if i < n_layers - 1:
            params["confidence"].append({"token": lin(d, 1)})
    return params
