#!/usr/bin/env python3
"""Times of the port's kernels on one card, by input.

    python3 scripts/time_torch_kernels.py [--kernel nms|attention|sweep|both|all]
                                          [--sass DIR] [--variants SPEC ...]

`chip_smoke.py` times each kernel once, at the main path's shape with
its own inputs. This script times what that one figure hides: the
attention kernel at B=16, H=4, Nq=Nk=4096, hd=64 bf16 under a random 0.9
key mask (every tile mixed), an all-ones mask (no tile masked), a
3000-key prefix mask (padded tiles skipped) and LightGlue's strided
(B, N, H, hd) head views, beside PyTorch's scaled_dot_product_attention;
and the sweep kernel at (4008, 6012), 128 hypotheses, window 7 on a
synthetic shifted pair, three times over; and the NMS kernel at
(2, 2400, 3400), r = 4 on uniform random scores, on the SuperPoint heat
map of two tiles of the synthetic pair (sparse peaks over a near-zero
background: a shortcut that depends on the data would show here), at a
width that is no multiple of 4 (4-byte loads and stores), at r = 2 and
at (1, 296, 160). `--variants HxWORDSxTHREADSxBLOCKS ...` also builds
the NMS source with another window (rows x 32-pixel words), thread count
and minimum blocks per SM, checks each against the default build and
times it at the main shape. `--kernel both` is attention and sweep. Prints the card, `ptxas`'s
registers and spills of each build, and CUDA-event times in ms. With
`--sass DIR` it also writes each library's SASS (`cuobjdump -sass`)
there. Needs one CUDA device; checks no result (chip_smoke.py does).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
ATT_SHAPE = (16, 4, 4096, 4096)


def print_ptxas(src: str, text: str, only: str = "") -> None:
    """ptxas's registers, shared memory and spills of each entry whose
    mangled name contains `only`."""
    name = ""
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = entry.group(1)
        elif only in name and ("registers" in line or "spill" in line):
            print(f"  {src} ..{name[-36:]}: {line.strip()}")


def superpoint_heat(cs, dev, shape) -> torch.Tensor:
    """SuperPoint's heat map (before NMS) of the top-left tiles of the
    synthetic pair, bundled weights."""
    from icepy4d_tpu_torch.matching import LightGlueMatcher

    _, h, w = shape
    imgs = cs.shifted_pair()
    x = torch.stack([torch.from_numpy(im[:h, :w].copy()) for im in imgs])
    x = x.to(dev).float() / 255.0
    net = LightGlueMatcher({"max_keypoints": 4096})._superpoint(4096).net
    with torch.inference_mode():
        heat, _ = net(x[:, None])
    return heat.contiguous()


def build_nms_variant(_build, spec: str):
    """nms.cu built with another window, thread count and minimum
    blocks per SM; returns a callable like ops.nms.fused_nms_border."""
    win_h, words, threads, blocks = (int(v) for v in spec.split("x"))
    out = _build.BUILD_DIR / f"nms-variant-{spec}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build._flags("nms.cu"), f"-DNMS_WIN_H={win_h}",
           f"-DNMS_WIN_WORDS={words}", f"-DNMS_THREADS={threads}",
           f"-DNMS_MIN_BLOCKS={blocks}", "-o", str(out),
           str(_build.CSRC / "nms.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {spec}\n{done.stdout}{done.stderr}")
    print_ptxas(f"nms.cu {spec}", done.stdout + done.stderr, "ILi4E")
    fn = ctypes.CDLL(str(out)).fused_nms_border
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(heat, r, border, h0, w0):
        res = torch.empty_like(heat)
        err = fn(heat.data_ptr(), res.data_ptr(), *heat.shape, r, border, h0,
                 w0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant {spec}: CUDA error {err}")
        return res

    return run


def time_nms(cs, _build, dev, variants) -> None:
    from icepy4d_tpu_torch.ops import nms

    shape = (2, 2400, 3400)
    rand = cs.heat_map(shape, dev)
    sp = superpoint_heat(cs, dev, shape)
    print(f"SuperPoint heat map: max {sp.max().item():.4f}, share above "
          f"0.005: {(sp > 0.005).float().mean().item():.4f}")
    odd = cs.heat_map((2, 2400, 3399), dev)
    small = cs.heat_map((1, 296, 160), dev)
    runs = [("random scores, r=4", rand, 4), ("SuperPoint heat map, r=4", sp, 4),
            ("random scores, W=3399 (4-byte path), r=4", odd, 4),
            ("random scores, r=2", rand, 2), ("random scores, r=1", rand, 1),
            ("(1, 296, 160), r=4", small, 4)]
    for _ in range(2):
        for name, heat, r in runs:
            _, h, w = heat.shape
            ms = cs.cuda_ms(lambda: nms.fused_nms_border(heat, r, 4, h, w), 20)
            print(f"nms {tuple(heat.shape)} {name}: {ms:.4f} ms", flush=True)
    for spec in variants:
        run = build_nms_variant(_build, spec)
        for heat in (rand, sp):
            if not torch.equal(run(heat, 4, 4, 2400, 3400),
                               nms.fused_nms_border(heat, 4, 4, 2400, 3400)):
                raise AssertionError(f"variant {spec} differs from the build")
        ms = [cs.cuda_ms(lambda: run(rand, 4, 4, 2400, 3400), 20)
              for _ in range(2)]
        print(f"nms variant {spec} (rows x words x threads x blocks/SM), "
              f"random scores, r=4: {ms[0]:.4f} {ms[1]:.4f} ms", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="both",
                    choices=("nms", "attention", "sweep", "both", "all"))
    ap.add_argument("--variants", nargs="*", default=[],
                    metavar="HxWORDSxTHREADSxBLOCKS",
                    help="other NMS windows to build and time")
    ap.add_argument("--sass", type=Path, default=None,
                    help="directory to write each library's SASS into")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_torch_kernels: no CUDA device")
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from icepy4d_tpu_torch.ops import _build, attention, dense

    dev = torch.device("cuda")
    print(cs.card_line(), "| torch", torch.__version__, flush=True)
    sources = {"nms": ["nms.cu"], "attention": ["attention.cu"],
               "sweep": ["sweep.cu"], "both": ["attention.cu", "sweep.cu"],
               "all": ["nms.cu", "attention.cu", "sweep.cu"]}[args.kernel]
    _build.build_all(sources)
    for src, text in _build.build_logs.items():
        print_ptxas(src, text)
    if args.sass is not None:
        args.sass.mkdir(parents=True, exist_ok=True)
        cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
        for src in sources:
            out = subprocess.run([str(cuobjdump), "-sass",
                                  str(_build._lib_path(src))],
                                 capture_output=True, text=True, check=True)
            (args.sass / f"{src}.sass").write_text(out.stdout)

    if args.kernel in ("nms", "all"):
        time_nms(cs, _build, dev, args.variants)

    if args.kernel in ("attention", "both", "all"):
        b, _, _, nk = ATT_SHAPE
        q, k, v, rand = cs.attention_inputs(*ATT_SHAPE, dev, seed=1)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        keys = torch.arange(nk, device=dev)[None].expand(b, -1)
        masks = {"random 0.9": rand, "all ones": torch.ones_like(rand),
                 "prefix 3000": (keys < 3000).contiguous()}
        for name, mask in masks.items():
            ms = cs.cuda_ms(
                lambda: attention.masked_attention(q, k, v, mask), 10)
            print(f"attention, {name} mask: {ms:.4f} ms", flush=True)
        qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2)
                      for t in (q, k, v))
        ms = cs.cuda_ms(
            lambda: attention.masked_attention(qs, ks, vs, rand), 10)
        print(f"attention, random 0.9 mask, head views: {ms:.4f} ms")
        ms = cs.cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=rand[:, None, None, :]), 10)
        print(f"scaled_dot_product_attention, random 0.9 mask: {ms:.4f} ms",
              flush=True)

    if args.kernel in ("sweep", "both", "all"):
        I0, I1 = cs.sweep_inputs(dev, cs.H_IMG, cs.W_IMG, 200.0)
        for _ in range(3):
            ms = cs.cuda_ms(lambda: dense.disparity_sweep(
                I0, I1, 95.3, 323.8, n_disp=128, window=7), 5)
            print(f"sweep ({cs.H_IMG}, {cs.W_IMG}) x 128, window 7: "
                  f"{ms:.3f} ms", flush=True)


if __name__ == "__main__":
    main()
