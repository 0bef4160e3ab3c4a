"""Reading a `torch.profiler` trace of the window.

The reading of `scripts/profile_torch_match.py` (one stream, so busy time
is the device's kernels and copies, and the idle share is the rest of the
wall window), taken from the profiler's raw events: device intervals are
merged so that work on two streams is counted once. Idle gaps are named
by the innermost host range or op that spans the gap's middle.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

TOP = 10


def _ns(e, which: str) -> int:
    return int(getattr(e, f"{which}_ns")())


def _mirrored(e, host_names: set) -> bool:
    """Whether a device event is a host range mirrored on the device's
    timeline (no work): by its activity type where the profiler gives
    one, else by a name that a host event also carries (no kernel or
    copy is named as a host op or range)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return "annotation" in str(kind())
    return e.name() in host_names


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)    # name -> device seconds
    idle_gaps: list = field(default_factory=list)   # [(host name, s)]

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernel_time(self, fragment: str) -> float:
        """Device seconds of every kernel whose name holds `fragment`."""
        return sum(v for k, v in self.kernel_s.items() if fragment in k)

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in self.idle_gaps[:TOP]]}


def read(events, t0_ns: int, t1_ns: int) -> Trace:
    """`events`: the profiler's raw events (`prof.profiler.kineto_results
    .events()`); the window runs from t0_ns to t1_ns on their clock."""
    dev, host = [], []
    kernel_s: dict = {}
    events = list(events)
    host_names = {e.name() for e in events
                  if not str(e.device_type()).endswith("CUDA")}
    for e in events:
        a, b = _ns(e, "start"), _ns(e, "end")
        if b <= t0_ns or a >= t1_ns:
            continue
        a, b = max(a, t0_ns), min(b, t1_ns)
        if str(e.device_type()).endswith("CUDA"):
            if _mirrored(e, host_names):
                continue
            dev.append((a, b))
            name = e.name()
            kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) / 1e9
        else:
            host.append((a, b, e.name()))
    dev.sort()
    merged = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) / 1e9
    gaps = []
    edge = t0_ns
    for a, b in merged + [[t1_ns, t1_ns]]:
        if a > edge:
            gaps.append((a - edge, edge, a))
        edge = max(edge, b)
    # name each gap by the shortest host interval spanning its middle:
    # a sweep over the middles in order, with a heap of the intervals
    # begun so far keyed by length (ended ones are dropped from its top)
    host.sort()
    heap: list = []
    j = 0
    named: dict = {}
    for length, a, b in sorted(gaps, key=lambda g: g[1] + g[2]):
        mid = (a + b) // 2
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(heap, (host[j][1] - host[j][0], host[j][1],
                                  host[j][2]))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "(no host range)"
        named[name] = named.get(name, 0.0) + length / 1e9
    idle = sorted(named.items(), key=lambda kv: -kv[1])
    return Trace((t1_ns - t0_ns) / 1e9, busy, kernel_s, idle)
