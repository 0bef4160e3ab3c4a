"""A configuration, a traffic mix, a loop, a metric and a cell added as
files and entries only are found and run by name, and BENCHMARK.json
keeps to the form the harness reads."""

import json
import re
import shutil
import time

import torch

from h100_bench import run, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_names_existing_files():
    bench = spec.load()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in bench["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        assert NAME.match(c["name"])
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"])
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
        for w in m.get("workloads", []):
            spec.cell(bench, w)
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        t = spec.traffic(w["traffic"])
        assert (spec.HERE / "loops" / f"{t['loop']}.py").is_file()
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer one
        e2e = {m["name"] for m in spec.metrics_of(bench, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(bench, w["name"], True)


LOOP = '''
class Loop:
    def __init__(self, config, traffic, seed, device):
        self.setup_parts = {}
        self.n = 0
        self.config = config

    def setup(self):
        pass

    def step(self):
        self.n += 1

    def item_lines(self):
        return []

    def release(self):
        pass

    def check(self):
        return {"steps_missing": (0.0 if self.n else 1.0,
                                  self.config["limits"]["steps_missing"])}
'''

METRIC = '''
def read(run):
    return float(len(run.items))
'''


def test_a_cell_added_as_files_runs(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    here = root / "h100_bench"
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.load()
    (here / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "limits": {"steps_missing": 0.5}}))
    (here / "traffic" / "toy_mix.json").write_text(json.dumps(
        {"loop": "toy_loop"}))
    (here / "loops" / "toy_loop.py").write_text(LOOP)
    (here / "metrics" / "toy_items.py").write_text(METRIC)
    bench["configs"].append({"name": "toy", "source": "https://example.org",
                             "file": "h100_bench/configs/toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy.cell", "config": "toy",
                               "traffic": "toy_mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "toy_items", "unit": "items",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["toy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "ROOT", root)
    monkeypatch.setattr(spec, "HERE", here)

    bench = spec.load()
    config = spec.config(bench, "toy")
    rc, out, checks = run.perform(bench, "toy.cell", config,
                                  spec.traffic("toy_mix"), 7, 1e-3, False,
                                  torch.device("cpu"), time.perf_counter())
    assert rc == 0 and out["correct"] is True
    assert out["metrics"]["toy_items"]["value"] == out["attempted"] >= 1
    assert set(out["metrics"]) == {"setup_s", "toy_items"}
    assert checks == {"steps_missing": (0.0, 0.5)}
