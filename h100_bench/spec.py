"""`BENCHMARK.json` and the files it names, found by name.

  configuration  the `file` of its `configs` entry
  traffic mix    h100_bench/traffic/<traffic>.json (parameters, and the
                 name of the loop that drives them)
  loop           h100_bench/loops/<loop>.py, a `Loop` class
  metric         h100_bench/metrics/<name>.py, a `read(run)` function

A configuration, mix, loop, metric or cell is added with new files and
entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"unknown workload {workload!r}; the benchmark has "
                     + ", ".join(w["name"] for w in bench["workloads"]))


def config(bench: dict, name: str) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return json.loads((ROOT / entry["file"]).read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def module(kind: str, name: str):
    """h100_bench/<kind>/<name>.py, loaded by its path (names may hold
    dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"h100_bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The cell's metric entries: with trace its per_layer ones, else its
    end_to_end ones (an entry without `workloads` belongs to every cell)."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if workload in m.get("workloads", [workload])]
