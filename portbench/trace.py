"""Reduction of a `torch.profiler` trace of the measured window.

The harness opens a span (`record_function(SPAN)`) around each unit of
work.  From the trace this takes the spans, the device's activity (kernels,
copies, sets) and the host's torch operations, and gives what the readers
of the per-layer metrics and the result's `breakdown` need: the traced
window (first span's start to last span's end), the device's busy time in
it and in each span (all of it, or leaving out the copies between host
and card), the operations that took most device time, and the idle
gaps by what the host was doing.
"""
from __future__ import annotations

import bisect

SPAN = "portbench.unit"
NAME_CHARS = 120  # an operation's name as the breakdown gives it
HOST_COPIES = ("Memcpy HtoD", "Memcpy DtoH")  # the profiler's names of copies over PCIe


def _union(intervals) -> list:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(union: list, starts: list, s: float, e: float) -> float:
    """Length of [s, e) that the disjoint sorted intervals `union` cover."""
    total = 0.0
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    while i < len(union) and union[i][0] < e:
        total += max(0.0, min(e, union[i][1]) - max(s, union[i][0]))
        i += 1
    return total


class Trace:
    """A window's trace: spans (us), device intervals (us, name), host ops."""

    def __init__(self, spans, device, host):
        self.spans = sorted(spans)
        self.device = [d for d in device if d[1] > d[0]]
        self.host = sorted(host)
        if self.spans:
            self.start, self.end = self.spans[0][0], self.spans[-1][1]
        else:
            self.start = self.end = 0.0
        self.busy = self._union_inside(self.device)
        self._starts = [b[0] for b in self.busy]

    def _union_inside(self, device) -> list:
        return _union([(max(s, self.start), min(e, self.end)) for s, e, _ in device
                       if e > self.start and s < self.end])

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        import torch

        cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
        spans, device, host = [], [], []
        for e in prof.events():
            r = e.time_range
            if e.name == SPAN or getattr(e, "is_user_annotation", False):
                if e.name == SPAN and e.device_type == cpu:  # not its copy on the device
                    spans.append((r.start, r.end))
            elif e.device_type == cuda:
                device.append((r.start, r.end, e.name))
            elif e.device_type == cpu:
                host.append((r.start, r.end, e.name))
        return cls(spans, device, host)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def span_busy_s(self, skip: tuple = ()) -> list:
        """The device's busy seconds inside each span, leaving out the
        operations whose name starts with one of `skip`."""
        busy, starts = self.busy, self._starts
        if skip:
            busy = self._union_inside([d for d in self.device if not d[2].startswith(skip)])
            starts = [b[0] for b in busy]
        return [_covered(busy, starts, s, e) / 1e6 for s, e in self.spans]

    def span_host_s(self) -> list:
        """Each span's seconds in which the device was not busy."""
        return [(e - s) / 1e6 - b for (s, e), b in zip(self.spans, self.span_busy_s())]

    def top_ops(self, count: int = 10) -> list:
        """[[name, seconds]]: the device operations that took most time."""
        by = {}
        for s, e, name in self.device:
            if e > self.start and s < self.end:
                key = name[:NAME_CHARS]
                by[key] = by.get(key, 0.0) + (min(e, self.end) - max(s, self.start)) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:count]]

    def idle_gaps(self, count: int = 10) -> list:
        """[[what the host did, seconds]]: the longest stretches of the
        window with no device activity, each named by the host's operations
        (torch operations and CUDA runtime calls) that cover at least half
        of it, outermost first ("a > b"), or else as host code outside
        torch operations."""
        edges = [self.start] + [x for b in self.busy for x in b] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = [h[0] for h in self.host]
        out = []
        for s, e in gaps[:count]:
            cover = sorted((hs - he, hname) for hs, he, hname
                           in self.host[: bisect.bisect_left(starts, e)]
                           if min(e, he) - max(s, hs) >= (e - s) / 2)
            name = " > ".join(n for _, n in cover[:3]) or "host code outside torch operations"
            out.append([name[:NAME_CHARS], (e - s) / 1e6])
        return out
