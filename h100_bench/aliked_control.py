"""Readings that set the ALIKED-n16 cell's limits: the program's numbers
and its controls', seed by seed, at the cell's own sizes.

    python3 -m h100_bench.aliked_control --workload <cell> --seeds 1,2,3 \
        [--pairs 2] [--out FILE]

For each seed the cell's loop is set up as a run sets it up, matches
`--pairs` pairs (the traffic's first ones), and each pair is judged
three times against the float32 reference
(`reference/aliked_check.py`): what the program produced, and in the
program's place `control`, the reference with its operands one precision
step below the configuration's (a bfloat16 extractor; LightGlue's trunk
and attention float8, its assignment bfloat16), and `stated`, the
reference at the configuration's own precisions (TF32 extractor). One
JSON line a pair and side, each judged against the configuration's
limits (`correct`); the last line sums up each side as
`loftr_control.summary` does: how many pairs came out correct, with the
control's least and the other sides' largest reading of each limited
number over every pair and seed. The limits have to pass the program and
fail the control. The benchmark's own runs never run
the controls.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from h100_bench import spec
from h100_bench.loftr_control import summary
from h100_bench.reference.aliked_check import (Reference, control, judge,
                                               stated)
from h100_bench.reference.check import reference_record

# the sides of `loftr_control.summary`
CONTROLS = {"control": control, "stated": stated}


def readings(workload: str, seed: int, n_pairs: int, device) -> list:
    bench = spec.load()
    config = spec.config(bench, spec.cell(bench, workload)["config"])
    limits = config["limits"]
    traffic = dict(spec.traffic(spec.cell(bench, workload)["traffic"]),
                   check_pairs=n_pairs)
    loop = spec.module("loops", traffic["loop"]).Loop(config, traffic, seed,
                                                      device)
    loop.setup()
    for _ in range(n_pairs):
        loop.step()
    loop.release()
    trees = loop.reference_trees()
    ref = Reference(config, traffic, trees, device)
    ctls = {side: make(config, traffic, trees, device)
            for side, make in CONTROLS.items()}
    out = []
    for rec in sorted(loop.samples, key=lambda r: r["pair"]):
        img0, img1 = loop.pairs[rec["pair"]]
        recs = [rec] + [reference_record(c, img0, img1)
                        for c in ctls.values()]
        for side, nums in zip(["program", *ctls],
                              judge(ref, img0, img1, recs)):
            nums.pop("counts")
            ok = all(nums[k] <= lim for k, lim in limits.items())
            out.append({"workload": workload, "seed": seed,
                        "pair": rec["pair"], "side": side, **nums,
                        "correct": ok})
    del loop
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("h100_bench.aliked_control: no CUDA device", file=sys.stderr)
        return 2
    sink = open(args.out, "a") if args.out else None
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        for line in readings(args.workload, seed, args.pairs,
                             torch.device("cuda")):
            lines.append(line)
            text = json.dumps(line)
            print(text, flush=True)
            if sink:
                sink.write(text + "\n")
                sink.flush()
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr,
              flush=True)
    bench = spec.load()
    limits = spec.config(bench, spec.cell(bench, args.workload)["config"])[
        "limits"]
    text = json.dumps({"workload": args.workload, "seeds": args.seeds,
                       **summary(lines, limits)})
    print(text, flush=True)
    if sink:
        sink.write(text + "\n")
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
