"""The control, the reference one precision step below the
configuration's in the program's place, comes out not correct: at a size
a test run holds (on the card `python3 -m h100_bench.control` reads it
at the cells' own sizes)."""

import pytest
import torch

from h100_bench import control, spec
from h100_bench.tests import bench_tiny


@pytest.mark.parametrize("workload", ["sp_lightglue.pairs",
                                      "sp_superglue.pairs"])
def test_control_fails_a_limit(workload, monkeypatch):
    traffic, config = spec.traffic, spec.config

    def tiny_traffic(name):
        return bench_tiny.shrink({"extractor": {}, "program": {"opt": {}}},
                                 traffic(name))[1]

    def tiny_config(bench, name):
        return bench_tiny.shrink(config(bench, name), {})[0]

    monkeypatch.setattr(spec, "traffic", tiny_traffic)
    monkeypatch.setattr(spec, "config", tiny_config)
    lines = control.readings(workload, bench_tiny.SEED, 1, torch.device("cpu"))
    ctl = next(x for x in lines if x["side"] == "control")
    assert ctl["correct"] is False, ctl
    assert control.summary(lines, {})["control"]["correct_pairs"] == 0
