"""The port's span recorder (`utils/timer.py::AverageTimer`) and the spans
of `ImageMatcherBase.match`: nesting, call ids and summed keys; every
stage of a tiny tiled LightGlue match, as `times` keys and as profiler
ranges inside their parents; and, on a CUDA device, a match that never
synchronises it.

The card's test runs where JAX is not installed:
python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from icepy4d_tpu_torch.matching import (GeometricVerification,
                                        LightGlueMatcher,
                                        NearestNeighborMatcher, Quality,
                                        TileSelection)
from icepy4d_tpu_torch.utils.timer import AverageTimer
from torch_port_inputs import lightglue_tree, shifted_pair, superpoint_tree

# profiler range -> (`times` key, parent range) of a tiled match
SPANS = {
    "match.upload": ("upload", "match"),
    "match.preselection": ("preselection", "match"),
    "match.extraction": ("extraction", "match"),
    "match.matching": ("matching", "match"),
    "match.model": ("model", "match.matching"),
    "match.assemble": ("assemble", "match.matching"),
    "match.dedup": ("dedup", "match.matching"),
    "match.verification": ("geometric_verification", "match"),
}
KEYS = {key for key, _ in SPANS.values()}
CHILDREN = ("model", "assemble", "dedup")


def test_recorder_nesting_calls_and_sums():
    t = AverageTimer()
    with t.call("run"):
        with t.span("run.a", "a"):
            with t.span("run.a.b", "b"):
                pass
        with t.span("run.a", "a"):
            t.update("check")
        t.begin("run.open", "open")         # left open: closes with the call
    assert t.call_id == 1
    assert [(s.name, s.parent, s.call) for s in t.spans] == [
        ("run", None, 1), ("run.a", 0, 1), ("run.a.b", 1, 1),
        ("run.a", 0, 1), ("check", 3, 1), ("run.open", 0, 1)]
    assert all(s.end_ns >= s.start_ns for s in t.spans)
    assert set(t.times) == {"a", "b", "check", "open"}
    a = [s.seconds for s in t.spans if s.key == "a"]
    assert t.times["a"] == pytest.approx(sum(a))
    assert set(t.stages()) == {"a", "open"}
    with pytest.raises(RuntimeError, match="innermost"):
        with t.call("next"):
            t.begin("next.x")
            t.end("next.y")
    assert t.call_id == 2 and {s.call for s in t.spans} == {2}
    assert t.current is None


class FakeEvent:
    """A CUDA timing event whose clock ticks once a record."""

    clock = 0
    made = 0

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        FakeEvent.clock += 1
        self.t = FakeEvent.clock

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_device_spans_read_events_and_record_them_again(monkeypatch):
    """On a CUDA device a span's seconds come from its two events, read
    only when `times` is; the next call records the same events again."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: "stream")
    t = AverageTimer(device="cuda")
    made = []
    for _ in range(3):
        with t.call("run"):
            with t.span("run.a", "a"):
                t.update("check")
            t.update("check")
        assert all(s.seconds is None for s in t.spans)
        # 1 ms a tick: run.a spans 2 records, the checkpoints 2 and 3
        assert t.times == {"a": 2e-3, "check": 5e-3}
        events = [e for s in t.spans for e in (s.start_event, s.end_event)]
        assert len({id(e) for e in events}) == 7
        made.append(FakeEvent.made)
    assert made[1] == made[2] == made[0]


# the scale of test_torch_matcher.py cut to 128 keypoints on a 208 x 272
# pair: under six xdist workers sharing the cores the 256-key 312 x 400
# match took ten times its time alone
@pytest.fixture(scope="module")
def matcher_opt():
    return {"max_keypoints": 128, "n_layers": 2, "filter_threshold": 0.0,
            "activation_dtype": "float32", "precision": "highest",
            "superpoint_params": superpoint_tree(seed=2),
            "matcher_params": lightglue_tree(2, 256, 4, seed=3)}


def _pair():
    return shifted_pair(208, 272)


def _match(m, images, selection="EXHAUSTIVE", verification="PYDEGENSAC"):
    t0 = time.perf_counter()
    m.match(*images, quality=Quality.HIGH,
            tile_selection=TileSelection[selection], grid=[2, 2],
            overlap=20, min_matches_per_tile=2, threshold=2.0,
            geometric_verification=GeometricVerification[verification])
    m.timer.times                        # waits for the last event
    return time.perf_counter() - t0


def _check_tiled(m, wall):
    times = m.timer.times
    assert KEYS <= set(times)
    assert all(v >= 0.0 for v in times.values())
    for child in CHILDREN:
        assert times[child] <= times["matching"]
    assert sum(times[c] for c in CHILDREN) <= times["matching"]
    assert sum(m.timer.stages().values()) <= wall
    names = {s.name: s for s in m.timer.spans}
    for name, (key, parent) in SPANS.items():
        assert names[name].key == key
        assert m.timer.spans[names[name].parent].name == parent


def test_tiled_match_times_every_stage(matcher_opt):
    m = LightGlueMatcher(matcher_opt, device="cpu")
    images = _pair()
    wall = _match(m, images)
    _check_tiled(m, wall)
    assert len(m.mkpts0) > 30
    first = m.timer.call_id
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _match(m, images)
    assert m.timer.call_id == first + 1
    ranges = {}
    for e in prof.events():
        if e.name == "match" or e.name.startswith("match."):
            ranges[e.name] = (e.time_range.start, e.time_range.end)
    assert set(SPANS) | {"match"} <= set(ranges)
    for name, (_, parent) in SPANS.items():
        (a, b), (pa, pb) = ranges[name], ranges[parent]
        assert pa <= a <= b <= pb, name


def test_preselection_sums_its_two_extractions(matcher_opt):
    """The coarse match inside `preselection` and the tiles' extraction
    both record `extraction`: the key holds their sum. (The nearest-
    neighbour matcher shares the path and spares the coarse match's
    4096-slot LightGlue forward.)"""
    m = NearestNeighborMatcher(matcher_opt, device="cpu")
    _match(m, _pair(), "PRESELECTION", "NONE")
    spans = m.timer.spans
    ext = [s for s in spans if s.name == "match.extraction"]
    assert len(ext) == 2
    assert spans[ext[0].parent].name == "match.preselection"
    assert spans[ext[1].parent].name == "match"
    assert m.timer.times["extraction"] == pytest.approx(
        sum(s.seconds for s in ext))
    # the coarse match opens no `matching` of its own
    assert [s.parent for s in spans if s.name == "match.matching"] == [0]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_match_never_synchronises_the_card(cuda, matcher_opt, monkeypatch):
    m = LightGlueMatcher(matcher_opt, device=cuda)
    images = _pair()
    _match(m, images)                    # builds the kernels
    calls = []
    inner = torch.cuda.synchronize

    def counted(*args, **kwargs):
        calls.append(args)
        return inner(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    wall = _match(m, images)
    assert calls == []
    _check_tiled(m, wall)
    assert all(s.start_event is not None for s in m.timer.spans)
