"""Sequence-parallel LightGlue: keypoint tokens sharded over a mesh axis
(counterpart of `icepy4d_tpu/parallel/lightglue_sp.py`).

Both token sets are sharded over the axis and the whole matcher runs
distributed:

- self and cross attention: ring attention (`ring_attention.py`);
- the sigmoid-log-double-softmax assignment is never built whole: the
  row and column log-sum-exps and the mutual argmax come from more ring
  passes, so a shard holds (N / S)^2 scores at a time, not N^2;
- only O(N) outputs (matches, scores) are gathered at the end.

    sp_lg = make_sequence_parallel_lightglue(mesh, lg, axis="seq")
    out = sp_lg(data)       # LightGlue.match's data; no log_assignment

The trunk runs in `lg`'s activation dtype, as `LightGlue._match` does;
the assignment head in f32.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from icepy4d_tpu_torch.models.lightglue import (NEG_INF, _linear, cross_block,
                                                normalize_keypoints,
                                                rotary_encoding, self_block)
from icepy4d_tpu_torch.parallel._ring import axis_of
from icepy4d_tpu_torch.parallel.mesh import Mesh
from icepy4d_tpu_torch.parallel.ring_attention import _ring_attention_local


def _lse_step(md_q, mask_q, mdk, mk, mx, se):
    """One ring block of the masked similarity and the running row
    log-sum-exp over it: (sim, pair mask, new max, new sum)."""
    sim = md_q @ mdk.transpose(1, 2)
    pair = mask_q[:, :, None] & mk[:, None, :]
    sim = torch.where(pair, sim, NEG_INF)
    m_new = torch.maximum(mx, sim.amax(-1))
    se = se * torch.exp(mx - m_new) \
        + torch.exp(sim - m_new[..., None]).sum(-1)
    return sim, pair, m_new, se


def _row_lse_and_argmax(md_q, z_k, mask_q, mask_k, md_k, col_lse, axis,
                        n_loc: int):
    """For each local query row: the log-sum-exp of sim over all keys,
    and the argmax (global index) of the assignment block's key-dependent
    part 2 * sim - key_lse + log_sigmoid(z_k); masked keys excluded.

    The blocks move forward (s -> s + 1), so at step i a shard holds the
    block that started on shard s - i: its own first, then s - 1, s - 2,
    ... With the strict `v > bmax` this order breaks ties as the JAX
    ring does."""
    rows, m_loc = mask_q.shape
    my_shard = axis.row_shards(rows)
    dev = md_q.device
    mx = torch.full((rows, m_loc), float("-inf"), device=dev)
    se = torch.zeros((rows, m_loc), device=dev)
    bmax = torch.full((rows, m_loc), float("-inf"), device=dev)
    barg = torch.zeros((rows, m_loc), dtype=torch.int64, device=dev)
    blocks = (md_k, z_k, mask_k, col_lse)
    for i in range(axis.size):
        mdk, zk, mk, clse = blocks
        shard = (my_shard - i) % axis.size
        sim, pair, mx, se = _lse_step(md_q, mask_q, mdk, mk, mx, se)
        val = 2.0 * sim - clse[:, None, :] + F.logsigmoid(zk)[:, None, :]
        val = torch.where(pair, val, float("-inf"))
        v = val.amax(-1)
        a = val.argmax(-1) + shard[:, None] * n_loc
        upd = v > bmax
        bmax = torch.where(upd, v, bmax)
        barg = torch.where(upd, a, barg)
        if i + 1 < axis.size:
            blocks = tuple(axis.ppermute(t) for t in blocks)
    return mx + torch.log(se.clamp_min(1e-30)), bmax, barg


def _plain_lse(md_q, mask_q, md_k, mask_k, axis):
    """Row log-sum-exp of the masked sim over all ring blocks."""
    rows, m_loc = mask_q.shape
    mx = torch.full((rows, m_loc), float("-inf"), device=md_q.device)
    se = torch.zeros((rows, m_loc), device=md_q.device)
    for i in range(axis.size):
        _, _, mx, se = _lse_step(md_q, mask_q, md_k, mask_k, mx, se)
        if i + 1 < axis.size:
            md_k, mask_k = axis.ppermute(md_k), axis.ppermute(mask_k)
    return mx + torch.log(se.clamp_min(1e-30))


def make_sequence_parallel_lightglue(mesh: Mesh, lg, axis: str = "seq"):
    """Token-sharded forward of the LightGlue module `lg` over `mesh`'s
    `axis`.

    run(data): LightGlue.match's data dict, with size0 and size1 (the
    rotary encoding needs the frame extents, not each shard's keypoint
    extent); the token dims must divide by the axis size. Returns
    matches0/1 and mscores0/1 with global indices; no log_assignment,
    the O(N^2) object this forward avoids."""
    ax = axis_of(mesh, axis)
    nh = lg.num_heads
    th = lg.filter_threshold
    attn = partial(_ring_attention_local, axis=ax)

    def tokens(data, s):
        kpts = ax.shard(data[f"kpts{s}"], 1)
        size = data[f"size{s}"]
        if size.ndim == 2:
            size = ax.replicate(size)
        desc = _linear(lg.input_proj, ax.shard(data[f"desc{s}"], 1).float())
        enc = rotary_encoding(lg.posenc, normalize_keypoints(kpts, size))
        act = lg.activation_dtype
        return (desc.to(act), tuple(e.to(act) for e in enc),
                ax.shard(data[f"mask{s}"], 1))

    @torch.inference_mode()
    def run(data: dict) -> dict:
        if data.get("size0") is None or data.get("size1") is None:
            raise ValueError(
                "sequence-parallel LightGlue needs size0 and size1 (each "
                "shard's keypoint extent would corrupt the rotary "
                "encoding)")
        data = {k: v.to(ax.device) if torch.is_tensor(v) else v
                for k, v in data.items()}
        d0, enc0, mask0 = tokens(data, 0)
        d1, enc1, mask1 = tokens(data, 1)
        for layer in lg.layers:
            d0 = self_block(layer.self_attn, d0, enc0, mask0, nh, attn)
            d1 = self_block(layer.self_attn, d1, enc1, mask1, nh, attn)
            d0, d1 = cross_block(layer.cross_attn, d0, d1, mask0, mask1, nh,
                                 attn)

        ap = lg.assign[-1]
        d0, d1 = d0.float(), d1.float()
        dd = ap.final_proj.out_features ** 0.25
        md0 = _linear(ap.final_proj, d0) / dd
        md1 = _linear(ap.final_proj, d1) / dd
        z0 = _linear(ap.matchability, d0)[..., 0]
        z1 = _linear(ap.matchability, d1)[..., 0]
        m_loc, n_loc = mask0.shape[1], mask1.shape[1]

        # the double softmax distributed: the column lse first (over side
        # 0), then side 0's argmax pass, which fuses the row lse
        col_lse = _plain_lse(md1, mask1, md0, mask0, ax)
        row_lse, bmax0, arg0 = _row_lse_and_argmax(
            md0, z1, mask0, mask1, md1, col_lse, ax, n_loc)
        _, _, arg1 = _row_lse_and_argmax(
            md1, z0, mask1, mask0, md0, row_lse, ax, m_loc)
        ms0 = torch.exp(bmax0 - row_lse + F.logsigmoid(z0))

        # the mutual check needs the other side's argmax globally
        rows = mask0.shape[0]
        shard = ax.row_shards(rows)[:, None]
        index0 = shard * m_loc + torch.arange(m_loc, device=ax.device)
        index1 = shard * n_loc + torch.arange(n_loc, device=ax.device)
        back0 = torch.gather(ax.all_gather(arg1), 1, arg0)
        # as LightGlue's filter_matches: scores are mutual-gated before
        # the threshold, which only the matches apply
        mut0 = mask0 & (back0 == index0) \
            & torch.gather(ax.all_gather(mask1), 1, arg0)
        mscores0 = torch.where(mut0, ms0, 0.0)
        valid0 = mut0 & (ms0 > th)
        matches0 = torch.where(valid0, arg0, -1).to(torch.int32)

        back1 = torch.gather(ax.all_gather(arg0), 1, arg1)
        mutual1 = mask1 & (back1 == index1)
        mscores1 = torch.where(
            mutual1, torch.gather(ax.all_gather(mscores0), 1, arg1), 0.0)
        valid1 = mutual1 & torch.gather(ax.all_gather(valid0), 1, arg1)
        matches1 = torch.where(valid1, arg1, -1).to(torch.int32)
        out = {"matches0": matches0, "matches1": matches1,
               "mscores0": mscores0, "mscores1": mscores1}
        return {k: ax.unshard(v, 1) for k, v in out.items()}

    return run
