"""Cells cut to a size the CPU runs in seconds, for the harness's tests:
240 x 320 frames, 2 x 2 tiles of 160 x 200, 128 keypoints a tile, the
faces' disparities whole 8-px cells (f 320 px, 10 m baseline)."""

from __future__ import annotations

import time

import torch

from h100_bench import run, spec

CPU = torch.device("cpu")
SEED = 2 ** 31 + 11      # past 32 signed bits: seeds may be that large


def shrink(config: dict, traffic: dict) -> tuple:
    config = {**config, "extractor": dict(config["extractor"],
                                          max_keypoints=128),
              "program": {**config["program"],
                          "opt": dict(config["program"]["opt"],
                                      max_keypoints=128)}}
    traffic = dict(traffic, height=240, width=320, focal_px=320.0,
                   baseline_m=10.0, cell_px=10.0, overlap=20, pairs=2,
                   check_pairs=1, trace_seconds=0.0)
    return config, traffic


def cell(workload: str) -> tuple:
    """(BENCHMARK.json, config, traffic) of the cell, cut down."""
    bench = spec.load()
    c = spec.cell(bench, workload)
    return (bench, *shrink(spec.config(bench, c["config"]),
                           spec.traffic(c["traffic"])))


def perform(workload: str, trace: bool = False, seed: int = SEED) -> tuple:
    """A whole run of the cut-down cell on the CPU, one item long."""
    bench, config, traffic = cell(workload)
    return run.perform(bench, workload, config, traffic, seed, 1e-6, trace,
                       CPU, time.perf_counter())
