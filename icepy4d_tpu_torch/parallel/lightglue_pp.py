"""Pipeline-parallel LightGlue: the transformer layers staged over a mesh
axis (counterpart of `icepy4d_tpu/parallel/lightglue_pp.py`).

Stage s holds layers [s * L / S, (s + 1) * L / S); the pair batch is
cut into microbatches that stream through the stages GPipe-style: at
step t stage s works on microbatch t - s, and its activations go on to
stage s + 1. Rotary encodings and masks are computed once and cut into
the same microbatches; the assignment head runs whole after the stages.

The JAX body is one SPMD program, so its stages compute on garbage in
the S - 1 bubble slots and discard it; here the bubble slots are
skipped, so on the card the attention kernel launches exactly
n_micro * 4 * n_layers / S times a stage (4 * n_layers a microbatch in
all). In the mesh form the stages are the axis's slots, which may name
one card or several: the handoff is the tensor itself, moved to the next
slot's device where that differs. In the process form (the process axis
of `global_mesh`) each process is one stage and the handoff is the
axis's partial shift [(s, s + 1)].

    pp_lg = make_pipeline_parallel_lightglue(mesh, lg, axis="pp")
    out = pp_lg(data)       # LightGlue.match's data and result
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn

from icepy4d_tpu_torch.models.lightglue import (_linear, filter_matches,
                                                match_assignment,
                                                normalize_keypoints,
                                                rotary_encoding)
from icepy4d_tpu_torch.parallel._ring import group_axis
from icepy4d_tpu_torch.parallel.mesh import Mesh


def stages_of(mesh: Mesh, axis: str):
    """(the process-form axis or None, each stage's device)."""
    group = group_axis(mesh, axis)
    if group is not None:
        return group, [group.device] * group.size
    return None, mesh.slots(axis)


def split_stages(modules: nn.ModuleList, devices: list, what: str) -> list:
    """`modules` cut into len(devices) contiguous stages, each on its
    device (a copy where the weights lie on another)."""
    n = len(devices)
    if len(modules) % n:
        raise ValueError(f"{what}={len(modules)} not divisible by {n} "
                         f"stages")
    per = len(modules) // n
    out = []
    for s, dev in enumerate(devices):
        part = modules[s * per:(s + 1) * per]
        if next(part.parameters()).device != torch.device(dev):
            part = copy.deepcopy(part).to(dev)
        out.append(part)
    return out


def micro_batches(b: int, n_micro: int | None, n_stages: int) -> int:
    """The microbatch count (default: one a stage, the fewest that fill
    the pipeline); the batch must divide by it."""
    nm = n_micro or n_stages
    if b % nm:
        raise ValueError(f"batch {b} not divisible by n_micro={nm}")
    return nm


def run_pipeline(group, devices: list, stage_fn, first, nm: int) -> tuple:
    """GPipe over the stages. first(m) is microbatch m's input tuple to
    stage 0; stage_fn(s, m, x) runs stage s on microbatch m's input
    tuple x and returns a tuple of the same shapes. Returns the last
    stage's outputs concatenated over the microbatches, to every
    process (in the process form, from the last stage by broadcast)."""
    n = len(devices)
    steps = nm + n - 1
    if group is None:
        inbox = [None] * n
        outs = [None] * nm
        for t in range(steps):
            # the later stages first: each takes what its predecessor
            # handed on at step t - 1 before that one hands on again
            for s in reversed(range(n)):
                m = t - s
                if not 0 <= m < nm:
                    continue
                y = stage_fn(s, m, first(m) if s == 0 else inbox[s])
                if s + 1 < n:
                    inbox[s + 1] = tuple(a.to(devices[s + 1]) for a in y)
                else:
                    outs[m] = y
        return tuple(torch.cat(parts) for parts in zip(*outs))

    s = group.rank
    carry, outs = None, []
    for t in range(steps):
        m = t - s
        y = None
        if 0 <= m < nm:
            y = stage_fn(s, m, first(m) if s == 0 else carry)
            if s == n - 1:
                outs.append(y)
        if t + 1 < steps:
            # every stage joins the shift; an idle one sends zeros
            send = y if y is not None else tuple(
                torch.zeros_like(a) for a in first(0))
            carry = tuple(group.ppermute(a, 1, wrap=False) for a in send)
    whole = tuple(torch.cat(parts) for parts in zip(*outs)) if outs else \
        tuple(torch.cat([torch.zeros_like(a)] * nm) for a in first(0))
    return tuple(group.broadcast(a, n - 1) for a in whole)


def make_pipeline_parallel_lightglue(mesh: Mesh, lg, axis: str = "pp",
                                     n_micro: int | None = None):
    """A pipeline-parallel forward of the LightGlue module `lg` over
    `mesh[axis]` stages. n_layers must divide by the stage count, the
    pair batch by n_micro (default: one microbatch a stage).

    pp_match(data) takes and returns what LightGlue.match does,
    log_assignment included. The trunk runs in `lg`'s activation dtype
    and every block's attention through `ops.attention.masked_attention`
    (the kernel on the card)."""
    group, devices = stages_of(mesh, axis)
    stages = split_stages(lg.layers, devices, "n_layers")

    @torch.inference_mode()
    def pp_match(data: dict) -> dict:
        dev = lg.posenc.Wr.weight.device
        data = {k: v.to(dev) if torch.is_tensor(v) else v
                for k, v in data.items()}
        nm = micro_batches(data["desc0"].shape[0], n_micro, len(devices))
        act = lg.activation_dtype
        mask0, mask1 = data["mask0"], data["mask1"]
        parts = {"mask0": mask0, "mask1": mask1}
        for s in (0, 1):
            kpts = normalize_keypoints(data[f"kpts{s}"], data.get(f"size{s}"))
            cos, sin = rotary_encoding(lg.posenc, kpts)
            parts.update({
                f"d{s}": _linear(lg.input_proj,
                                 data[f"desc{s}"].float()).to(act),
                f"cos{s}": cos.to(act), f"sin{s}": sin.to(act)})
        parts = {k: v.chunk(nm) for k, v in parts.items()}

        def first(m):
            return parts["d0"][m], parts["d1"][m]

        def stage_fn(s, m, x):
            at = {k: v[m].to(devices[s]) for k, v in parts.items()
                  if not k.startswith("d")}
            return lg._run_segment(stages[s], *x, (at["cos0"], at["sin0"]),
                                   (at["cos1"], at["sin1"]), at["mask0"],
                                   at["mask1"])

        d0, d1 = run_pipeline(group, devices, stage_fn, first, nm)
        scores = match_assignment(lg.assign[-1], d0.to(dev), d1.to(dev),
                                  mask0, mask1)
        matches0, matches1, ms0, ms1 = filter_matches(
            scores, lg.filter_threshold)
        return {
            "matches0": torch.where(mask0, matches0, -1),
            "matches1": torch.where(mask1, matches1, -1),
            "mscores0": torch.where(mask0, ms0, 0.0),
            "mscores1": torch.where(mask1, ms1, 0.0),
            "log_assignment": scores,
        }

    return pp_match
