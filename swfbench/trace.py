"""The traced run's timeline, read from ``torch.profiler``'s events.

``span(name)`` marks a benchmark span on the host (a profiler user
annotation ``swfbench.<name>``); ``Timeline`` holds, on the profiler's
clock in seconds, every span, every device activity (kernels, copies,
memsets), and the host's operations, and answers the questions the
per-layer readers ask: device time of a kind inside the calls, the part
of a span in which nothing runs on the card, the longest idle gaps.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

PREFIX = "swfbench."
CALL_SPANS = ("load_movie_timeline", "render_batch")


@contextlib.contextmanager
def span(name: str):
    import torch

    with torch.profiler.record_function(PREFIX + name):
        yield


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _overlap(merged, a: float, b: float) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged
               if x < b and y > a)


def kind_of(name: str) -> str:
    if name.startswith("Memcpy HtoD"):
        return "h2d"
    if name.startswith("Memcpy DtoH"):
        return "d2h"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "copy"
    return "kernel"


class Timeline:
    def __init__(self, prof):
        import torch

        self.spans: List[Tuple[str, float, float]] = []
        self.device: List[Tuple[str, str, float, float]] = []
        self.host_ops: List[Tuple[str, float, float]] = []
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            t0 = e.start_ns() * 1e-9
            t1 = t0 + e.duration_ns() * 1e-9
            name = e.name()
            if name.startswith(PREFIX):
                # A span shows twice: on the host, and as an annotation
                # over the device work it launched, which is no activity.
                if e.device_type() != cuda:
                    self.spans.append((name[len(PREFIX):], t0, t1))
            elif e.device_type() == cuda:
                self.device.append((kind_of(name), name, t0, t1))
            elif name.startswith("aten::"):
                self.host_ops.append((name, t0, t1))
        self.busy = _union([(a, b) for _, _, a, b in self.device])

    def calls(self) -> List[Tuple[float, float]]:
        return _union([(a, b) for n, a, b in self.spans if n in CALL_SPANS])

    def span_seconds(self, name: str) -> float:
        return sum(b - a for n, a, b in self.spans if n == name)

    def call_seconds(self) -> float:
        return sum(b - a for a, b in self.calls())

    def device_seconds(self, kind: str) -> float:
        """Summed device time of activities of ``kind`` inside the calls."""
        calls = self.calls()
        return sum(_overlap(calls, a, b) for k, _, a, b in self.device
                   if k == kind)

    def busy_seconds(self, name: str = None) -> float:
        """Time in which something runs on the card, inside the calls (or
        inside the spans called ``name``)."""
        if name is None:
            ranges = self.calls()
        else:
            ranges = _union([(a, b) for n, a, b in self.spans if n == name])
        return sum(_overlap(self.busy, a, b) for a, b in ranges)

    def busy_total(self) -> float:
        return sum(b - a for a, b in self.busy)

    def top_device_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for _, name, a, b in self.device:
            tot[name] = tot.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest stretches inside the calls with nothing on the card,
        each named by the benchmark span open on the host, and the
        outermost host operation running at its middle, if any."""
        gaps = []
        for a, b in self.calls():
            t = a
            for x, y in self.busy:
                if y <= a or x >= b:
                    continue
                if x > t:
                    gaps.append((t, x))
                t = max(t, y)
            if b > t:
                gaps.append((t, b))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            name = next((s for s, x, y in self.spans if x <= mid <= y),
                        "harness")
            ops = [(y - x, o) for o, x, y in self.host_ops if x <= mid <= y]
            if ops:
                name += "/" + max(ops)[1]
            out.append([name, b - a])
        return out
