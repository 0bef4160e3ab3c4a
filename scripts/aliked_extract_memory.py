"""Bytes an ALIKED-n16 extraction allocates a tile pixel on the card.

    python3 scripts/aliked_extract_memory.py [--tiles 1,2,4] \
        [--height 2400] [--width 3400]

For each batch of tiles: `torch.cuda.max_memory_allocated` over one warm
`ALIKEDN16.extract` (random weights, random frames), less what was
allocated before it, over the batch's tile pixels; and the extraction's
warm seconds a tile (CUDA events). The matcher's
`matchers.py::ALIKED_N16_BYTES_PER_PIXEL` is set from these readings;
`_extract_chunk` sizes its tile chunks by it. Prints one JSON line a
batch, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from icepy4d_tpu_torch.device import card_line  # noqa: E402
from icepy4d_tpu_torch.models.aliked_n16 import (ALIKEDN16,  # noqa: E402
                                                 random_state_dict)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", default="1,2,4")
    ap.add_argument("--height", type=int, default=2400)
    ap.add_argument("--width", type=int, default=3400)
    ap.add_argument("--keypoints", type=int, default=4096)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    print(json.dumps({"card": card_line(dev)}), flush=True)
    ext = ALIKEDN16(max_keypoints=args.keypoints, device=dev)
    ext.load_state_dict(random_state_dict(0))
    for t in (int(v) for v in args.tiles.split(",")):
        x = torch.rand(t, args.height, args.width, device=dev)
        ext.extract(x)                                   # warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = ext.extract(x)
        b.record()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        px = t * args.height * args.width
        print(json.dumps({"tiles": t, "peak_bytes": peak,
                          "bytes_per_pixel": peak / px,
                          "s_per_tile": a.elapsed_time(b) / 1e3 / t,
                          "keypoints": int(out["mask"].sum())}), flush=True)
        del x, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
