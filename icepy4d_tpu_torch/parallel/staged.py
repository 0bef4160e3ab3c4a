"""Two-stage extract/match pipeline (counterpart of
`icepy4d_tpu/parallel/staged.py`).

The extractor runs on one device and the matcher on another while a
stream of batches flows through: extract(batch t + 1) overlaps
match(batch t). The JAX package gets the overlap from asynchronous
dispatch onto two disjoint device groups and so needs two devices. Here
each stage runs on its own CUDA stream, and the device list may name
one card twice: on one H100, `devices=["cuda", "cuda"]` overlaps the two
stages on two streams of the card. The handoff records an event on
stage A's stream that stage B's stream waits on; the features are
marked as used by stage B's stream (`record_stream`) so the allocator
does not hand their memory back to stage A early, and between two
distinct cards they cross with a non-blocking copy. On the CPU the same
class runs the stages one after the other.

    pipe = StagedPipeline(extract_fn, match_fn, devices=["cuda", "cuda"])
    outs = pipe.run(batches)     # the outputs of sequential calls, in order
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, Sequence

import torch

from icepy4d_tpu_torch.parallel.mesh import _leaves, _to, _visible, tree_map


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def split_devices(devices=None, split: float = 0.5
                  ) -> tuple[list[torch.device], list[torch.device]]:
    """(extract devices, match devices): the first round(n * split)
    entries (at least one, and one left) and the rest. A device may
    appear in both. Default: every visible card. Fewer than two entries
    raise ValueError."""
    devs = [_device(d) for d in (devices if devices is not None
                                 else _visible(torch.device("cuda")))]
    if len(devs) < 2:
        raise ValueError("staged pipeline needs >= 2 devices")
    k = max(1, min(len(devs) - 1, int(round(len(devs) * split))))
    return devs[:k], devs[k:]


def _record(tree, stream) -> None:
    for t in _leaves(tree):
        if torch.is_tensor(t) and t.is_cuda:
            t.record_stream(stream)


@dataclass
class StagedPipeline:
    """extract_fn(batch) runs on the first device of the extract group,
    match_fn(features) on the first of the match group; both take and
    return trees (dicts, lists, tuples) of tensors."""

    extract_fn: Callable[[Any], Any]
    match_fn: Callable[[Any], Any]
    devices: Sequence | None = None
    split: float = 0.5

    def __post_init__(self):
        self.devices_a, self.devices_b = split_devices(self.devices,
                                                       self.split)
        self.device_a, self.device_b = self.devices_a[0], self.devices_b[0]
        self._cuda = self.device_a.type == "cuda"
        if self._cuda:
            self.stream_a = torch.cuda.Stream(self.device_a)
            self.stream_b = torch.cuda.Stream(self.device_b)

    def _stage_a(self, batch):
        """Upload and extract on stage A's stream; returns the features
        and the event that marks them ready."""
        sa = self.stream_a
        # a batch already on the card was made on the caller's stream
        sa.wait_stream(torch.cuda.current_stream(self.device_a))
        with torch.cuda.stream(sa):
            batch = tree_map(_to(self.device_a, True), batch)
            _record(batch, sa)
            feats = self.extract_fn(batch)
            ready = torch.cuda.Event()
            ready.record(sa)
        return feats, ready

    def _stage_b(self, feats, ready):
        sb = self.stream_b
        with torch.cuda.stream(sb):
            sb.wait_event(ready)
            # stage B reads (or copies) memory that stage A's stream
            # allocated: keep it from being reused before B is done
            _record(feats, sb)
            if self.device_b != self.device_a:
                feats = tree_map(_to(self.device_b, True), feats)
            out = self.match_fn(feats)
            done = torch.cuda.Event()
            done.record(sb)
        return out, done

    def run(self, batches: Iterable, prefetch: int = 2) -> list:
        """The match outputs of every batch, in order. Stage A runs up
        to `prefetch` batches ahead of the outputs handed back."""
        if not self._cuda:
            return [self.match_fn(tree_map(_to(self.device_b),
                                           self.extract_fn(tree_map(
                                               _to(self.device_a), b))))
                    for b in batches]
        caller = torch.cuda.current_stream(self.device_b)
        results: list = []
        in_flight: list = []

        def finish():
            out, done = in_flight.pop(0)
            caller.wait_event(done)
            # the caller's stream uses (and frees) what stage B made
            _record(out, caller)
            results.append(out)

        for batch in batches:
            in_flight.append(self._stage_b(*self._stage_a(batch)))
            while len(in_flight) > prefetch:
                finish()
        while in_flight:
            finish()
        return results
