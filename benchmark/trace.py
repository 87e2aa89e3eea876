"""A short stretch of callbacks after the window, under ``torch.profiler``, reduced to what
the per-layer readers and the breakdown take: the device's activities
(kernels, copies, fills) with their names and intervals, the traced window
on the profiler's clock, the union of the busy intervals, and the host
spans of the loop (``traffic``, ``submit``, ``readback``, ``wait``) that
name the idle gaps.

The raw kineto events are read, not the profiler's event tree: a stretch
of event blocks holds 10^5 activities and the tree takes long to build.
The host spans are the harness's own, on the wall clock in nanoseconds
(``time.time_ns``), the clock the profiler puts its events on, so that
the profiler records the device alone and costs the host little.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SPANS = ("traffic", "submit", "readback", "wait")


class HostSpans:
    """A recorder of named host spans: ``with spans("submit"): ...``."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int]] = []

    @contextmanager
    def __call__(self, name: str):
        t = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t, time.time_ns()))


@dataclass
class Trace:
    blocks: int                       # callbacks in the traced window
    t0: int                           # the window on the profiler clock, ns
    t1: int
    # device activities: (name, start ns, duration ns)
    device: List[Tuple[str, int, int]] = field(default_factory=list)
    # host spans: (name, start ns, end ns)
    spans: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device activities' intervals, clipped to the
        window, in time order."""
        iv = sorted((max(s, self.t0), min(s + d, self.t1))
                    for _, s, d in self.device)
        out: List[List[int]] = []
        for a, b in iv:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def device_ops(self, n: int = 10) -> List[list]:
        """The ``n`` device operations that took most time, by name (the
        first 120 characters of it)."""
        tot: Dict[str, int] = {}
        for name, _, d in self.device:
            k = short(name)
            tot[k] = tot.get(k, 0) + d
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-9] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest idle gaps of the device, each named by the
        host span in which it began."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        spans = sorted(self.spans, key=lambda s: s[1])
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            name = "other"
            for nm, s0, s1 in spans:
                if s0 <= a < s1:
                    name = nm
                if s0 > a:
                    break
            out.append([name, (b - a) * 1e-9])
        return out


def short(name: str, limit: int = 120) -> str:
    """A kernel's name without its anonymous namespace and its argument
    list, at most ``limit`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    cut = name.split("(")[0] if not name.startswith("Mem") else name
    return cut[:limit]


def reduce(prof, blocks: int, t0: int, t1: int, spans: HostSpans) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile`` over the
    window ``[t0, t1]`` (``time.time_ns``): the device activities that
    start in it, and the host spans."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device = [(e.name(), e.start_ns(), e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              # a host span's mirror on the device's timeline is no activity
              if e.device_type() == cuda and not e.is_user_annotation()
              and t0 <= e.start_ns() < t1]
    return Trace(blocks=blocks, t0=t0, t1=t1, device=device,
                 spans=list(spans.spans))
