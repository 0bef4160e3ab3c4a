#!/usr/bin/env python3
"""SuperPoint's convolutions on one card, layer by layer and whole.

    python3 scripts/time_superpoint_convs.py [--batch 2] [--height 2400]
                                             [--width 3400] [--reps 10]

The tiled match runs SuperPoint's trunk over (2, 1, 2400, 3400) tiles.
For each 3x3 convolution that a ReLU follows (conv1a ... conv4b, convPa,
convDa) at the shape the trunk gives it, this prints CUDA-event times
in ms, with TF32 on as the configurations run them, of

  plain   F.conv2d + bias + ReLU on NCHW activations and weights (the
          CPU and autograd path, and the card's before the fused path)
  nhwc    the same three passes on channels-last activations
  fused   torch.ops.aten.cudnn_convolution_relu on channels-last
          activations and weights, as SuperPointNet runs it on the card
          (conv1a, one input channel, split into four TF32 channels by
          `split_tf32`, the split included)
  tf32    conv1a only: the fused op on its one channel, TF32 on
  f32     conv1a only: the same with TF32 off

and each 2x2 max-pool in NCHW and in NHWC. Then, for the whole trunk
(`SuperPointNet.forward`, bundled weights) in f32 and bf16, plain
against fused: each one's largest relative gap to the exact run (f32,
TF32 off) with TF32 on, their gap to each other with TF32 off, their
forward times and the device ops of one forward of each under
torch.profiler. Exits 1 where the fused forward counts other than 10
`fused_convs` or gives a value that is not finite (the card test
`tests/test_torch_superpoint_fused.py` checks the layers). Needs one
CUDA device.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from icepy4d_tpu_torch.device import card_line, full_f32_matmul  # noqa: E402
from icepy4d_tpu_torch.models.convert import (  # noqa: E402
    load_params, superpoint_state_dict)
from icepy4d_tpu_torch.models.superpoint import SuperPointNet  # noqa: E402

CL = torch.channels_last
WEIGHTS = Path(__file__).resolve().parents[1] / "weights" / \
    "superpoint_synthetic.npz"


def layer_inputs(b: int, h: int, w: int) -> dict[str, tuple]:
    """(B, Cin, H, W) of each fused layer's input in the trunk."""
    shapes = {}
    for name, cin, s in (("conv1a", 1, 1), ("conv1b", 64, 1),
                         ("conv2a", 64, 2), ("conv2b", 64, 2),
                         ("conv3a", 64, 4), ("conv3b", 128, 4),
                         ("conv4a", 128, 8), ("conv4b", 128, 8),
                         ("convPa", 128, 8), ("convDa", 128, 8)):
        shapes[name] = (b, cin, h // s, w // s)
    return shapes


def event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fused(x, wt, bias):
    return torch.ops.aten.cudnn_convolution_relu(
        x, wt, bias, (1, 1), (1, 1), (1, 1), 1)


def plain(x, wt, bias):
    return F.relu(F.conv2d(x, wt, bias, padding=1), inplace=True)


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def time_layers(net: SuperPointNet, b: int, h: int, w: int, reps: int,
                dev) -> None:
    print(f"per layer, f32, TF32 on, ms (input shape; {reps} reps)")
    cols = ("plain", "nhwc", "fused", "tf32", "f32")
    print(f"{'layer':8} {'shape':>22} " + " ".join(f"{c:>8}" for c in cols))
    for name, shape in layer_inputs(b, h, w).items():
        conv = getattr(net, name)
        wt, bias = conv.weight.detach(), conv.bias.detach()
        wt_cl = wt.to(memory_format=CL)
        x = torch.rand(shape, device=dev)
        x_cl = x.to(memory_format=CL)
        conv_cl = torch.nn.Conv2d(shape[1], wt.shape[0], 3, padding=1).to(
            dev, memory_format=CL)
        conv_cl.load_state_dict(conv.state_dict())
        row = {"plain": event_ms(lambda: plain(x, wt, bias), reps),
               "nhwc": event_ms(lambda: plain(x_cl, wt_cl, bias), reps),
               "fused": event_ms(
                   lambda: SuperPointNet._conv_relu_fused(conv_cl, x_cl),
                   reps)}
        if shape[1] == 1:
            row["tf32"] = event_ms(lambda: fused(x_cl, wt_cl, bias), reps)
            with full_f32_matmul():
                row["f32"] = event_ms(lambda: fused(x_cl, wt_cl, bias), reps)
        print(f"{name:8} {str(shape):>22} " + " ".join(
            f"{row.get(k, float('nan')):8.3f}" for k in cols), flush=True)
        del x, x_cl
        torch.cuda.empty_cache()
    for s in (1, 2, 4):
        shape = (b, 64 if s < 4 else 128, h // s, w // s)
        x = torch.rand(shape, device=dev)
        x_cl = x.to(memory_format=CL)
        t = [event_ms(lambda: F.max_pool2d(v, 2, 2), reps) for v in (x, x_cl)]
        print(f"max_pool {str(shape):>22} nchw {t[0]:.3f} nhwc {t[1]:.3f}",
              flush=True)
        del x, x_cl
        torch.cuda.empty_cache()


def trunk(net: SuperPointNet, x: torch.Tensor, fused_path: bool):
    ctx = torch.inference_mode() if fused_path else torch.enable_grad()
    with ctx:
        return net(x)


def device_ops(fn, rows: int = 12) -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_time_total", 0) > 0]
    evs.sort(key=lambda e: -e.device_time_total)
    for e in evs[:rows]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms x{e.count:<3} "
              f"{e.key[:110]}")


def time_trunk(b: int, h: int, w: int, reps: int, dev, dtype) -> bool:
    state = superpoint_state_dict(load_params(WEIGHTS))
    nets = {}
    for name, d, fmt in (("exact", torch.float32, torch.contiguous_format),
                         ("plain", dtype, torch.contiguous_format),
                         ("fused", dtype, CL)):
        nets[name] = SuperPointNet().to(dev, d, memory_format=fmt).eval()
        nets[name].load_state_dict(state)
        nets[name].requires_grad_(False)
    nchw, nhwc = nets["plain"], nets["fused"]
    x = torch.rand((b, 1, h, w), device=dev)
    with full_f32_matmul():
        exact = trunk(nets.pop("exact"), x, False)
    n0 = SuperPointNet.fused_convs
    heat_f, desc_f = trunk(nhwc, x, True)
    counted = SuperPointNet.fused_convs - n0
    heat_p, desc_p = trunk(nchw, x, False)
    finite = bool(torch.isfinite(heat_f).all() and torch.isfinite(desc_f).all())
    print(f"trunk {str(dtype)[6:]} {(b, 1, h, w)}, bundled weights: "
          f"fused_convs {counted} a forward, heat {tuple(heat_f.shape)} "
          f"contiguous {heat_f.is_contiguous()}, desc {tuple(desc_f.shape)} "
          f"nhwc {desc_f.is_contiguous(memory_format=CL)}, finite {finite}")
    print(f"  TF32 on, rel_gap to the exact run (f32, TF32 off): heat plain "
          f"{rel_gap(heat_p, exact[0]):.3e} fused {rel_gap(heat_f, exact[0]):.3e}"
          f", desc plain {rel_gap(desc_p, exact[1]):.3e} fused "
          f"{rel_gap(desc_f, exact[1]):.3e}")
    del heat_f, desc_f, heat_p, desc_p
    with full_f32_matmul():
        heat_f, desc_f = trunk(nhwc, x, True)
        heat_p, desc_p = trunk(nchw, x, False)
        print(f"  TF32 off, fused against plain: heat rel_gap "
              f"{rel_gap(heat_f, heat_p):.3e}, desc {rel_gap(desc_f, desc_p):.3e}")
    del heat_f, desc_f, heat_p, desc_p, exact
    t_p = event_ms(lambda: trunk(nchw, x, False), reps)
    t_f = event_ms(lambda: trunk(nhwc, x, True), reps)
    t_p2 = event_ms(lambda: trunk(nchw, x, False), reps)
    t_f2 = event_ms(lambda: trunk(nhwc, x, True), reps)
    print(f"  forward ms, TF32 on: plain {t_p:.3f} / {t_p2:.3f}, fused "
          f"{t_f:.3f} / {t_f2:.3f}", flush=True)
    print("  device ops, plain forward:")
    device_ops(lambda: trunk(nchw, x, False))
    print("  device ops, fused forward:")
    device_ops(lambda: trunk(nhwc, x, True), rows=20)
    return finite and counted == 10


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--height", type=int, default=2400)
    ap.add_argument("--width", type=int, default=3400)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    print(card_line(dev), "| torch", torch.__version__, "cuda",
          torch.version.cuda, "cudnn", torch.backends.cudnn.version(),
          "| cudnn.allow_tf32", torch.backends.cudnn.allow_tf32, flush=True)
    b, h, w = args.batch, args.height, args.width
    torch.manual_seed(0)
    net = SuperPointNet().to(dev)
    with torch.inference_mode():
        time_layers(net, b, h, w, args.reps, dev)
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        ok &= time_trunk(b, h, w, args.reps, dev, dtype)
    print({"ok": bool(ok)})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
