#!/usr/bin/env python3
"""Times of the port's attention and sweep kernels on one card, by input.

    python3 scripts/time_torch_kernels.py [--kernel attention|sweep|both]
                                          [--sass DIR]

`chip_smoke.py` times each kernel once, at the main path's shape with
its own inputs. This script times what that one figure hides: the
attention kernel at B=16, H=4, Nq=Nk=4096, hd=64 bf16 under a random 0.9
key mask (every tile mixed), an all-ones mask (no tile masked), a
3000-key prefix mask (padded tiles skipped) and LightGlue's strided
(B, N, H, hd) head views, beside PyTorch's scaled_dot_product_attention;
and the sweep kernel at (4008, 6012), 128 hypotheses, window 7 on a
synthetic shifted pair, three times over. Prints the card, `ptxas`'s
registers and spills of each build, and CUDA-event times in ms. With
`--sass DIR` it also writes each library's SASS (`cuobjdump -sass`)
there. Needs one CUDA device; checks no result (chip_smoke.py does).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
ATT_SHAPE = (16, 4, 4096, 4096)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("attention", "sweep", "both"),
                    default="both")
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
    sources = {"attention": ["attention.cu"], "sweep": ["sweep.cu"],
               "both": ["attention.cu", "sweep.cu"]}[args.kernel]
    _build.build_all(sources)
    for src, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    if args.sass is not None:
        args.sass.mkdir(parents=True, exist_ok=True)
        cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
        for src in sources:
            out = subprocess.run([str(cuobjdump), "-sass",
                                  str(_build._lib_path(src))],
                                 capture_output=True, text=True, check=True)
            (args.sass / f"{src}.sass").write_text(out.stdout)

    if args.kernel in ("attention", "both"):
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

    if args.kernel in ("sweep", "both"):
        I0, I1 = cs.sweep_inputs(dev, cs.H_IMG, cs.W_IMG, 200.0)
        for _ in range(3):
            ms = cs.cuda_ms(lambda: dense.disparity_sweep(
                I0, I1, 95.3, 323.8, n_disp=128, window=7), 5)
            print(f"sweep ({cs.H_IMG}, {cs.W_IMG}) x 128, window 7: "
                  f"{ms:.3f} ms", flush=True)


if __name__ == "__main__":
    main()
