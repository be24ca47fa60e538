"""Spans on the host, and the device's kernels from the profiler.

`Spans` records what the benchmark's own code is doing (copy-in, step,
sync, ...) on the wall clock in ns, the clock the profiler stamps its
device events with, so that an idle gap of the device can be named by
the span the host was in. `Trace` runs torch.profiler with CUDA activity
only (recording every CPU op as well would slow the host and so inflate
the idle share it is there to read) and reads the kernels back from the
profiler's raw events.

`summarize` is the union of kernel intervals of the port's
`cli/profile.py` `summarize`, copied here so that the yardstick stays
when the program changes.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

from . import registry


class Spans:
    """Host spans [(name, start_ns, end_ns)] on the wall clock."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))

    def at(self, t_ns: float) -> str:
        """The innermost (shortest) span around wall time t_ns."""
        best: Optional[Tuple[int, str]] = None
        for name, a, b in self.items:
            if a <= t_ns <= b and (best is None or b - a < best[0]):
                best = (b - a, name)
        return best[1] if best else "between spans"


class Kernel:
    __slots__ = ("name", "start", "end", "cls")

    def __init__(self, name: str, start: int, end: int, cls: str):
        self.name, self.start, self.end, self.cls = name, start, end, cls


def device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every event the profiler saw on the
    card: kernels, copies and sets."""
    import torch
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            start = e.start_ns()
            out.append((e.name(), start, start + e.duration_ns()))
    return out


def union_ns(kernels: List[Kernel]) -> int:
    busy, end = 0, None
    for k in sorted(kernels, key=lambda k: k.start):
        if end is None or k.end > end:
            busy += k.end - (k.start if end is None else max(k.start, end))
            end = k.end
    return busy


def idle_gaps(kernels: List[Kernel], spans: Spans, t0: int, t1: int,
              top: int = 10) -> List[list]:
    """The `top` longest stretches of [t0, t1] in which no kernel ran,
    each named by the host span it fell in and the kernel it ended
    with, in seconds."""
    gaps, end = [], t0
    for k in sorted(kernels, key=lambda k: k.start):
        if k.start > end:
            gaps.append((k.start - end, end, k.name))
        end = max(end, k.end)
    if t1 > end:
        gaps.append((t1 - end, end, "window end"))
    gaps.sort(key=lambda g: -g[0])
    return [[f"{spans.at(a + d / 2)}: before {name[:80]}", d * 1e-9]
            for d, a, name in gaps[:top]]


def summarize(events: List[Tuple[str, int, int]], spans: Spans, t0: int,
              t1: int, classes: List[dict]) -> Dict:
    """Busy seconds (the union of kernel intervals), the window, device
    seconds by kernel class and by name, launches, and the breakdown the
    result line carries. Events outside [t0, t1] are dropped."""
    kernels = [Kernel(n, max(a, t0), min(b, t1), registry.classify(n, classes))
               for n, a, b in events if b > t0 and a < t1]
    if not kernels:
        raise RuntimeError("the profiler recorded no operation on the card "
                           "in the traced window")
    by_class: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for k in kernels:
        d = (k.end - k.start) * 1e-9
        by_class[k.cls] = by_class.get(k.cls, 0.0) + d
        by_name[k.name] = by_name.get(k.name, 0.0) + d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    plain = sorted(((n, t) for n, t in by_name.items()
                    if registry.classify(n, classes) == registry.PLAIN),
                   key=lambda kv: -kv[1])
    return {
        "busy_s": union_ns(kernels) * 1e-9,
        "window_s": (t1 - t0) * 1e-9,
        "launches": len(kernels),
        "class_s": by_class,
        "breakdown": {"device_ops": [[n[:120], t] for n, t in top[:10]],
                      "idle_gaps": idle_gaps(kernels, spans, t0, t1)},
        "plain_top": [[n[:120], t] for n, t in plain[:15]],
    }


class Trace:
    """torch.profiler over the traced window, CUDA activity only."""

    def __enter__(self):
        import torch
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def events(self):
        return device_events(self.prof)
