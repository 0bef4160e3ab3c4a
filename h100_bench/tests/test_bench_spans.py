"""The readers of the matcher's spans: a traced tiny run of each cell
reports them, and the matcher's host idle counts only the gaps named
after its own ranges."""

from types import SimpleNamespace

import pytest

from h100_bench import spec, trace
from h100_bench.tests import bench_tiny
from h100_bench.tests.test_bench_trace import Event

SPAN_METRICS = {"upload_s", "model_s", "assemble_s", "dedup_s",
                "match_host_idle_s"}


@pytest.mark.parametrize("workload", ["sp_lightglue.pairs",
                                      "sp_superglue.pairs"])
def test_traced_run_reports_the_span_metrics(workload):
    rc, out, _ = bench_tiny.perform(workload, trace=True)
    assert rc == 0
    metrics = out["metrics"]
    assert SPAN_METRICS <= set(metrics)
    assert all(metrics[m]["value"] >= 0.0 for m in SPAN_METRICS)


def test_match_host_idle_sums_the_matchers_gaps():
    ms = 1_000_000
    events = [
        Event("bench.window", 0, 100 * ms, "CPU", "user_annotation"),
        Event("bench.item", 0, 100 * ms, "CPU", "user_annotation"),
        Event("match", 6 * ms, 95 * ms, "CPU", "user_annotation"),
        Event("match.matching", 40 * ms, 80 * ms, "CPU", "user_annotation"),
        Event("match.dedup", 60 * ms, 80 * ms, "CPU", "user_annotation"),
        Event("aten::copy_", 20 * ms, 30 * ms, "CPU", "cpu_op"),
        Event("kernel", 10 * ms, 20 * ms, "CUDA", "kernel"),
        Event("kernel", 30 * ms, 40 * ms, "CUDA", "kernel"),
        Event("kernel", 45 * ms, 55 * ms, "CUDA", "kernel"),
        Event("match.dedup", 60 * ms, 80 * ms, "CUDA", "gpu_user_annotation"),
    ]
    t = trace.read(events, 0, 100 * ms)
    gaps = dict(t.idle_gaps)
    # 0-10 ms bench.item, 20-30 aten::copy_, 40-45 match.matching,
    # 55-100: its middle (77.5 ms) lies in match.dedup
    assert gaps == pytest.approx({"bench.item": 0.010, "aten::copy_": 0.010,
                                  "match.matching": 0.005,
                                  "match.dedup": 0.045})
    run = SimpleNamespace(trace=t, traced_items=2,
                          loop=SimpleNamespace(stats=[{"upload": 0.01}] * 2))
    read = spec.module("metrics", "match_host_idle_s").read
    assert read(run) == pytest.approx((0.005 + 0.045) / 2)
    # a program without the matcher's spans: nothing to read
    run.loop.stats = [{"extraction": 0.2}] * 2
    assert read(run) is None
    run.trace = None
    assert read(run) is None
