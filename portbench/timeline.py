"""The profiler's timeline of a traced slice, reduced to what the per-layer
metrics read.

``record(fn)`` runs ``fn`` (which makes the slice's calls and ends with a
synchronise) under ``torch.profiler`` inside one annotation; the caller
synchronises first, since the profiler records no work enqueued before
it starts and the device's time on such work would read as idle. It
exports the Chrome trace to a temporary file, reads it and deletes it.
The slice's window is that annotation. Device operations are the trace's
kernels, memsets and copies; busy time is the union of their intervals
inside the window, so overlapping operations count once and nothing is
taken from a wall time measured elsewhere.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
SLICE = "portbench.slice"


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments;
    a copy's or a memset's as it is."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    cut = name.find("(")
    return name[:cut] if cut > 0 else name


@dataclass
class Op:
    name: str
    start: float        # microseconds on the profiler's clock
    end: float


@dataclass
class Slice:
    calls: int
    start: float
    end: float
    device: list = field(default_factory=list)   # Op, sorted by start
    host: list = field(default_factory=list)     # Op on the caller's thread

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_intervals(self, ops=None) -> list:
        """The union of the ops' intervals (all device ops by default),
        clipped to the window, as sorted disjoint (start, end) pairs."""
        merged = []
        for op in sorted(self.device if ops is None else ops,
                         key=lambda o: o.start):
            s, e = max(op.start, self.start), min(op.end, self.end)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self, ops=None) -> float:
        return sum(e - s for s, e in self.busy_intervals(ops)) * 1e-6

    def ops_of(self, *names) -> list:
        """The device ops whose name holds any of names."""
        return [op for op in self.device if any(k in op.name for k in names)]

    def device_ops_top(self, n: int = 10) -> list:
        total: dict = {}
        for op in self.device:
            k = short_name(op.name)
            total[k] = total.get(k, 0.0) + (op.end - op.start) * 1e-6
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps_top(self, n: int = 10) -> list:
        """Idle time inside the window, summed by the innermost host
        operation that was running at the middle of each gap."""
        busy = self.busy_intervals()
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        starts = [op.start for op in self.host]
        reach, most = [], float("-inf")     # latest end among ops 0..j
        for op in self.host:
            most = max(most, op.end)
            reach.append(most)
        total: dict = {}
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid, name = (s + e) / 2, "host: untraced"
            j = bisect.bisect_right(starts, mid) - 1
            while j >= 0 and reach[j] >= mid:
                if self.host[j].end >= mid:
                    name = self.host[j].name
                    break
                j -= 1
            total[name] = total.get(name, 0.0) + (e - s) * 1e-6
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:n]


def parse(path: str, calls: int) -> Slice:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks = [e for e in events if e.get("name") == SLICE
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the traced slice's annotation is missing")
    mark = marks[0]
    start = float(mark["ts"])
    sl = Slice(calls, start, start + float(mark["dur"]))
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        op = Op(e.get("name", ""), float(e["ts"]),
                float(e["ts"]) + float(e["dur"]))
        if e.get("cat") in DEVICE_CATS:
            if op.end > sl.start and op.start < sl.end:
                sl.device.append(op)
        elif (e.get("cat") in HOST_CATS and e.get("tid") == mark.get("tid")
              and e is not mark):
            sl.host.append(op)
    sl.device.sort(key=lambda o: o.start)
    sl.host.sort(key=lambda o: o.start)
    return sl


def record(fn) -> Slice:
    """Profile fn() (which returns the number of calls it made, the last
    one synchronised) and read its slice; call it on an empty queue."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(SLICE):
            calls = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return parse(path, calls)
    finally:
        os.unlink(path)
