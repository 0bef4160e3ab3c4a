"""Sequence-parallel SuperGlue: the token-sharded GNN and a rows-sharded
Sinkhorn (counterpart of `icepy4d_tpu/parallel/superglue_sp.py`).

Both token sets are sharded over a mesh axis; the attentional GNN runs
with ring attention, and the optimal transport is rows-sharded: each
shard holds its (m_local, N + 1) slice of the couplings (memory
O(N^2 / S)), the u-update is local, and the v-update combines the
shards' column log-sum-exps with a log-space all-reduce. The dustbin row
is one row, so every shard computes it.

    sp_sg = make_sequence_parallel_superglue(mesh, sg, axis="seq")
    out = sp_sg(data)       # SuperGlue.match's data; no log_assignment
"""

from __future__ import annotations

from functools import partial

import torch

from icepy4d_tpu_torch.models.superglue import (NEG, attn_propagation,
                                                keypoint_encoder,
                                                normalize_keypoints)
from icepy4d_tpu_torch.parallel._ring import axis_of
from icepy4d_tpu_torch.parallel.mesh import Mesh
from icepy4d_tpu_torch.parallel.ring_attention import _ring_attention_local


def _allreduce_lse(partial_lse: torch.Tensor, axis) -> torch.Tensor:
    """The shards' log-sum-exps combined into the global one."""
    g = axis.pmax(partial_lse)
    return g + torch.log(axis.psum(torch.exp(partial_lse - g)) + 1e-30)


def make_sequence_parallel_superglue(mesh: Mesh, sg, axis: str = "seq"):
    """Token-sharded forward of the SuperGlue module `sg` over `mesh`'s
    `axis`: its heads (head-major), Sinkhorn iterations, match threshold
    and descriptor scale.

    run(data): SuperGlue.match's data dict; token dims divisible by the
    axis size. Returns matches0/1 and mscores0/1 with global indices
    (the log assignment only ever exists rows-sharded)."""
    ax = axis_of(mesh, axis)
    nh = sg.num_heads
    iters = sg.sinkhorn_iterations
    th = sg.match_threshold
    attn = partial(_ring_attention_local, axis=ax)

    def tokens(data, s):
        kpts = ax.shard(data[f"kpts{s}"], 1)
        size = data[f"size{s}"]
        if size.ndim == 2:
            size = ax.replicate(size)
        d = ax.shard(data[f"desc{s}"], 1).float() + keypoint_encoder(
            sg.kenc, normalize_keypoints(kpts, size),
            ax.shard(data[f"scores{s}"], 1))
        return d, ax.shard(data[f"mask{s}"], 1)

    @torch.inference_mode()
    def run(data: dict) -> dict:
        data = {k: v.to(ax.device) if torch.is_tensor(v) else v
                for k, v in data.items()}
        d0, mask0 = tokens(data, 0)
        d1, mask1 = tokens(data, 1)
        for i in range(0, len(sg.gnn), 2):
            sl, cl = sg.gnn[i], sg.gnn[i + 1]
            d0 = d0 + attn_propagation(sl, d0, d0, mask0, nh, attn)
            d1 = d1 + attn_propagation(sl, d1, d1, mask1, nh, attn)
            delta0 = attn_propagation(cl, d0, d1, mask1, nh, attn)
            delta1 = attn_propagation(cl, d1, d0, mask0, nh, attn)
            d0, d1 = d0 + delta0, d1 + delta1

        md0 = sg.final_proj(d0)
        md1 = sg.final_proj(d1)
        rows, m_loc = mask0.shape
        n_loc = mask1.shape[1]
        alpha = sg.bin_score.to(md0.dtype)

        # side 1's tokens gathered (O(N)); the rows stay sharded
        g_md1 = ax.all_gather(md1)
        g_mask1 = ax.all_gather(mask1)
        n = g_mask1.shape[1]
        sim = (md0 @ g_md1.transpose(1, 2)) / sg.descriptor_dim ** 0.5
        sim = torch.where(mask0[:, :, None] & g_mask1[:, None, :], sim, NEG)

        # local rows [sim | bin0]; the dustbin row [bin1 | alpha] on every
        # shard
        bins0 = torch.where(mask0, alpha, NEG)[:, :, None]
        Z = torch.cat([sim, bins0], -1)                  # (L*B, m_loc, N+1)
        del sim
        dust = torch.cat([torch.where(g_mask1, alpha, NEG),
                          alpha.expand(rows, 1)], -1)    # (L*B, N+1)

        ms = ax.psum(mask0.sum(-1)).to(Z.dtype)
        ns = ax.psum(mask1.sum(-1)).to(Z.dtype)
        norm = -torch.log(ms + ns)
        log_mu = torch.where(mask0, norm[:, None], NEG)
        log_mu_dust = torch.log(ns) + norm
        log_nu = torch.cat([torch.where(g_mask1, norm[:, None], NEG),
                            (torch.log(ms) + norm)[:, None]], -1)

        u = torch.zeros((rows, m_loc), device=Z.device)
        v = torch.zeros((rows, n + 1), device=Z.device)
        for _ in range(iters):
            u = log_mu - torch.logsumexp(Z + v[:, None, :], 2)
            u_dust = log_mu_dust - torch.logsumexp(dust + v, 1)
            # v: the column lse over every shard's rows and the dustbin row
            col = _allreduce_lse(torch.logsumexp(Z + u[:, :, None], 1), ax)
            col = torch.logaddexp(col, dust + u_dust[:, None])
            v = log_nu - col

        block = Z[:, :, :n]
        block += u[:, :, None] + v[:, None, :n] - norm[:, None, None]
        m0 = block.argmax(2)
        ms0 = torch.exp(block.amax(2))

        # matches1: the column argmax over the shards, ties to the first
        shard = ax.row_shards(rows)[:, None]
        index0 = shard * m_loc + torch.arange(m_loc, device=Z.device)
        cmax = block.amax(1)                              # (L*B, N)
        carg = shard * m_loc + block.argmax(1)
        best = ax.all_gather(cmax[:, None], 1).argmax(1, keepdim=True)
        m1_full = torch.gather(ax.all_gather(carg[:, None], 1), 1,
                               best)[:, 0]                 # (L*B, N)
        index1 = shard * n_loc + torch.arange(n_loc, device=Z.device)
        m1 = torch.gather(m1_full, 1, index1)

        # as SuperGlue's filter_matches: scores mutual-gated before the
        # threshold, which only the matches apply
        mutual0 = mask0 & (torch.gather(m1_full, 1, m0) == index0)
        mscores0 = torch.where(mutual0, ms0, 0.0)
        valid0 = mutual0 & (ms0 > th)
        matches0 = torch.where(valid0, m0, -1).to(torch.int32)

        mutual1 = mask1 & (torch.gather(ax.all_gather(m0), 1, m1) == index1)
        mscores1 = torch.where(
            mutual1, torch.gather(ax.all_gather(mscores0), 1, m1), 0.0)
        valid1 = mutual1 & torch.gather(ax.all_gather(valid0), 1, m1)
        matches1 = torch.where(valid1, m1, -1).to(torch.int32)
        out = {"matches0": matches0, "matches1": matches1,
               "mscores0": mscores0, "mscores1": mscores1}
        return {k: ax.unshard(v, 1) for k, v in out.items()}

    return run
