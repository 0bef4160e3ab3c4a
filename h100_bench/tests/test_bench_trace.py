"""The reading of a profiler trace, on hand-built events."""

import pytest

from h100_bench import trace


class Event:
    def __init__(self, name, start, end, device, kind):
        self._v = (name, start, end, device, kind)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType." + self._v[3]

    def activity_type(self):
        return self._v[4]


def test_busy_idle_and_gaps():
    ms = 1_000_000
    events = [
        Event("bench.window", 0, 100 * ms, "CPU", "user_annotation"),
        Event("matching", 40 * ms, 70 * ms, "CPU", "user_annotation"),
        Event("np.unique", 50 * ms, 60 * ms, "CPU", "cpu_op"),
        Event("nms_border_kernel", 10 * ms, 20 * ms, "CUDA", "kernel"),
        # two streams overlapping: counted once
        Event("conv", 15 * ms, 30 * ms, "CUDA", "kernel"),
        Event("copy", 70 * ms, 80 * ms, "CUDA", "gpu_memcpy"),
        # a host range mirrored on the device timeline is no work
        Event("matching", 40 * ms, 70 * ms, "CUDA", "gpu_user_annotation"),
        # outside the window: clipped away
        Event("late", 100 * ms, 120 * ms, "CUDA", "kernel"),
    ]
    t = trace.read(events, 0, 100 * ms)
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx(0.030)        # 10-30 and 70-80 ms
    assert t.idle_share == pytest.approx(0.7)
    assert t.kernel_time("nms_border") == pytest.approx(0.010)
    gaps = dict(t.idle_gaps)
    # 30-70 ms: its middle (50 ms) lies in np.unique, inside matching
    assert gaps["np.unique"] == pytest.approx(0.040)
    assert gaps["bench.window"] == pytest.approx(0.030)   # 0-10, 80-100
    b = t.breakdown()
    assert b["device_ops"][0] == ["conv", pytest.approx(0.015)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


class OlderEvent(Event):
    """An event of a profiler that gives no activity type."""

    def __getattribute__(self, name):
        if name == "activity_type":
            raise AttributeError(name)
        return super().__getattribute__(name)


def test_mirrored_ranges_found_by_name():
    ms = 1_000_000
    events = [OlderEvent("bench.item", 0, 50 * ms, "CPU", ""),
              OlderEvent("bench.item", 0, 50 * ms, "CUDA", ""),
              OlderEvent("masked_attention_kernel", 5 * ms, 10 * ms, "CUDA",
                         "")]
    t = trace.read(events, 0, 50 * ms)
    assert t.busy_s == pytest.approx(0.005)
    assert set(t.kernel_s) == {"masked_attention_kernel"}
