"""Program spans: where the port's host was, on the clock the profiler
stamps the device's kernels with, so each kernel can be tied to the layer
that launched it.

    with span("gen.decode"):
        ...

With no recorder open, `span` returns one shared null context: no clock
read, no allocation, no lock. Whoever takes a trace opens a recorder for
the traced work and reads its spans when the block closes:

    with record() as rec:
        ...
    rec.spans        # [Span(name, start_ns, end_ns, parent)]

Spans are stamped with `time.time_ns()`, the clock of torch.profiler's
kineto events (a Chrome trace's `ts` is `(t_ns - baseTimeNanoseconds) /
1000` µs). `parent` is the index of the span around it on the same thread
(-1 at the top). One recorder is open at a time.

`device_ops(prof)` reads a CUDA profile's kernels, copies and sets, each
with the host start of the runtime or driver call that launched it (the
two share CUPTI's correlation id); `rollup(spans, ops)` ties each op to
the innermost span open at its launch (by time, so kernels that
autograd's thread launches during `.backward()` fall in the main thread's
span around it) and sums by span name.

The spans the port opens:

    gen.step, gen.prefill, gen.decode, gen.match   train/generation.py
    model.decode_attention                         model/attention.py
    train.step, train.forward, train.backward,     train/step.py
    train.update, eval.step
    eval.prefill, eval.extend                      train/objectives.py
"""
from __future__ import annotations

import bisect
import contextlib
import heapq
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

NONE = "(none)"
LAUNCH_CALLS = ("cuda_runtime", "cuda_driver")


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int


class DeviceOp(NamedTuple):
    """A kernel, copy or set on the card; `launch_ns` is the host start of
    the call that launched it, None where the profile has no such call."""
    name: str
    start_ns: int
    end_ns: int
    launch_ns: Optional[int]


class Recorder:
    """The spans opened while it is the open recorder. A span adds four
    list items and no object the garbage collector tracks."""

    def __init__(self):
        self._names: List[str] = []
        self._starts: List[int] = []
        self._ends: List[Optional[int]] = []
        self._parents: List[int] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._contexts: Dict[str, _Open] = {}
        self._closed_ns: Optional[int] = None

    def _open(self, name: str) -> None:
        try:
            stack = self._local.stack
        except AttributeError:
            stack = self._local.stack = []
        with self._lock:
            index = len(self._names)
            self._names.append(name)
            self._parents.append(stack[-1] if stack else -1)
            self._ends.append(None)
            self._starts.append(time.time_ns())
        stack.append(index)

    def _close(self) -> None:
        self._ends[self._local.stack.pop()] = time.time_ns()

    def context(self, name: str) -> "_Open":
        ctx = self._contexts.get(name)
        if ctx is None:
            ctx = self._contexts[name] = _Open(self, name)
        return ctx

    @property
    def spans(self) -> List[Span]:
        """Every span in the order opened; one still open ends when the
        recorder closed (or now)."""
        end = self._closed_ns or time.time_ns()
        return [Span(n, a, end if b is None else b, p) for n, a, b, p in
                zip(self._names, self._starts, self._ends, self._parents)]


class _Open:
    """The context of one span name under one recorder, shared by every
    span of that name: the recorder's per-thread stack holds which span
    each exit closes."""
    __slots__ = ("rec", "name")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.rec._open(self.name)

    def __exit__(self, exc_type, exc, tb):
        self.rec._close()


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_NULL = _Null()
_open_recorder: Optional[Recorder] = None


def span(name: str):
    """A context that records `name` over its block while a recorder is
    open; otherwise the shared null context."""
    rec = _open_recorder
    if rec is None:
        return _NULL
    return rec.context(name)


@contextlib.contextmanager
def record() -> Iterator[Recorder]:
    """Records every span opened in the block, on any thread."""
    global _open_recorder
    if _open_recorder is not None:
        raise RuntimeError("a span recorder is already open")
    rec = _open_recorder = Recorder()
    try:
        yield rec
    finally:
        _open_recorder = None
        rec._closed_ns = time.time_ns()


def _is_cuda_call(e) -> bool:
    """A host event that is a CUDA runtime or driver call. Older torch
    builds give a kineto event no `activity_type`; there such calls are
    the host events named for the CUDA API (cudaLaunchKernel,
    cuLaunchKernelEx, ...), as no op of torch's is."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in LAUNCH_CALLS
    return e.name().startswith("cu")


def device_ops(prof) -> List[DeviceOp]:
    """The kernels, copies and sets of a finished torch.profiler profile
    with CUDA activity, each with its launch's host start."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    launch: Dict[int, int] = {}
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            ops.append(e)
        elif _is_cuda_call(e):
            launch[e.correlation_id()] = e.start_ns()
    return [DeviceOp(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                     launch.get(e.correlation_id())) for e in ops]


def innermost(spans: List[Span], times: List[int]) -> List[int]:
    """For each time (ascending), the index of the shortest span that
    holds it, or -1: a sweep with a heap of the spans begun, ended ones
    dropped when they reach the top."""
    order = sorted(range(len(spans)), key=lambda i: spans[i].start_ns)
    heap: list = []
    out, j = [], 0
    for t in times:
        while j < len(order) and spans[order[j]].start_ns <= t:
            s = spans[order[j]]
            heapq.heappush(heap, (s.end_ns - s.start_ns, order[j]))
            j += 1
        while heap and spans[heap[0][1]].end_ns < t:
            heapq.heappop(heap)
        out.append(heap[0][1] if heap else -1)
    return out


class _Busy:
    """The union of device-op intervals, to read the busy time between
    two instants."""

    def __init__(self, ops: List[DeviceOp]):
        merged: List[list] = []
        for a, b in sorted((o.start_ns, o.end_ns) for o in ops):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]
        self.cum = [0]
        for a, b in merged:
            self.cum.append(self.cum[-1] + b - a)

    def between(self, a: int, b: int) -> int:
        i = bisect.bisect_right(self.ends, a)
        k = bisect.bisect_left(self.starts, b)
        if i >= k:
            return 0
        return (self.cum[k] - self.cum[i] - max(0, a - self.starts[i])
                - max(0, self.ends[k - 1] - b))


def rollup(spans: List[Span], ops: List[DeviceOp]) -> Dict[str, dict]:
    """By span name: `count`, `host_s` (summed durations), `device_s` and
    `launches` of the ops launched inside its spans (nested spans
    included; a span that nests in a span of its own name counts an op
    once), and `idle_s`: the time between the first op's start and the
    last op's end of each span that launched any, less the time in which
    any op ran on the card. Ops launched outside every span, or with no
    launch in the profile, count under NONE."""
    out: Dict[str, dict] = {}

    def entry(name: str) -> dict:
        return out.setdefault(name, {"count": 0, "host_s": 0.0,
                                     "device_s": 0.0, "launches": 0,
                                     "idle_s": 0.0})

    for s in spans:
        e = entry(s.name)
        e["count"] += 1
        e["host_s"] += (s.end_ns - s.start_ns) * 1e-9
    launched = sorted((o for o in ops if o.launch_ns is not None),
                      key=lambda o: o.launch_ns)
    owners = innermost(spans, [o.launch_ns for o in launched])
    owners += [-1] * (len(ops) - len(launched))
    window: Dict[int, list] = {}            # span index → [first, last]
    for o, i in zip(launched + [o for o in ops if o.launch_ns is None],
                    owners):
        d = (o.end_ns - o.start_ns) * 1e-9
        if i < 0:
            e = entry(NONE)
            e["device_s"] += d
            e["launches"] += 1
        seen = set()
        while i >= 0:
            s = spans[i]
            if s.name not in seen:
                seen.add(s.name)
                e = out[s.name]
                e["device_s"] += d
                e["launches"] += 1
            w = window.setdefault(i, [o.start_ns, o.end_ns])
            w[0], w[1] = min(w[0], o.start_ns), max(w[1], o.end_ns)
            i = s.parent
    busy = _Busy(ops)
    for i, (a, b) in window.items():
        out[spans[i].name]["idle_s"] += (b - a - busy.between(a, b)) * 1e-9
    return out


def attributed_share(rolled: Dict[str, dict], ops: List[DeviceOp]) -> float:
    """The share of the ops' device time that `rollup` put in some span."""
    total = sum(o.end_ns - o.start_ns for o in ops) * 1e-9
    none = rolled.get(NONE, {}).get("device_s", 0.0)
    return 1.0 - none / total if total else 0.0
