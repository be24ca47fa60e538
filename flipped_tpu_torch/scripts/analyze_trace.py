"""Summarize a torch.profiler trace into a device-time breakdown (JAX:
scripts/analyze_trace.py, which reads jax.profiler traces).

Reads the Chrome trace (`*.pt.trace.json`, or `.json.gz`) that
`cli.train --trace_dir DIR` writes (`DIR/train_epoch<N>.pt.trace.json`,
steps 1 to 3 of the first epoch) and `cli.profile --trace_dir DIR`
(`DIR/profile_<mode>.pt.trace.json`), and prints, per device: the busy
time (the union of its kernel intervals), the wall span of the profiled
steps (the `train step N` annotations, else `ProfilerStep#N`, else the
first kernel's start to the last one's end), the top kernels, and a rollup
by class. The classes are `cli.profile.kernel_class`'s, so both tools name
a kernel the same way (K8's decode route, int4_decode_kernel and
int4_decode_sum_kernel, under "int4 GEMM (K8)" with int4_fwd.cu's). Where
the trace holds the program's spans (events with a `span` in `args`, as
`cli.train --trace_dir` writes them), it also prints by span name the
device ms, launches, host ms, and idle ms (the time inside each span's
device interval, its first op's start to its last op's end, in which no
op ran): each kernel, copy and set belongs to the innermost span open when
the CUDA runtime or driver call that launched it began (`args.correlation`
ties the two; utils/spans.py `rollup`). A step's span ends when its host
returns, so a step's wall runs to its last kernel's end.

    python -m flipped_tpu_torch.scripts.analyze_trace DIR_OR_FILE [--top 25]

A trace with no device kernel (a CPU run, or a profiler that recorded only
host activity) is reported as such, and the command exits 1: host time is
never counted as device time.
"""
from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys
from typing import Dict, List, Optional

from ..cli.profile import kernel_class
from ..utils.spans import (LAUNCH_CALLS, DeviceOp, Span, attributed_share,
                           rollup)

KERNEL_CATS = ("kernel",)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STEP_NAME = re.compile(r"^(train step \d+|ProfilerStep#\d+)$")


def trace_path(path: str) -> str:
    """The trace file itself, or the newest `*.pt.trace.json[.gz]` under a
    directory."""
    if os.path.isfile(path):
        return path
    found = sorted(glob.glob(os.path.join(path, "**", "*.pt.trace.json*"),
                             recursive=True), key=os.path.getmtime)
    if not found:
        raise FileNotFoundError(f"no *.pt.trace.json under {path}")
    return found[-1]


def load_events(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def analyze(events: List[dict]) -> Dict[str, dict]:
    """→ {device: {'kernels', 'busy_ms', 'span_ms', 'span_from',
    'busy_share', 'steps', 'by_class' {class: ms}, 'by_name' {name: [ms,
    n]}}} for every device with kernel events."""
    steps = [e for e in events if e.get("ph") == "X"
             and STEP_NAME.match(str(e.get("name", "")))
             and not str(e.get("cat", "")).startswith("gpu")]
    by_dev: Dict[str, list] = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in KERNEL_CATS:
            dev = (e.get("args") or {}).get("device", e.get("pid"))
            by_dev[str(dev)].append(e)
    out = {}
    for dev, kernels in sorted(by_dev.items()):
        spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                 for e in kernels]
        busy = union_us(spans)
        if steps:
            # a step's span ends where its host returns; its last kernels
            # may end later
            span = (max(max(float(s["ts"]) + float(s.get("dur", 0.0))
                            for s in steps), max(b for _, b in spans))
                    - min(float(s["ts"]) for s in steps))
            span_from = f"{len(steps)} step annotations"
        else:
            span = max(b for _, b in spans) - min(a for a, _ in spans)
            span_from = "first kernel to last"
        by_name: Dict[str, list] = {}
        by_class: Dict[str, float] = collections.Counter()
        for e in kernels:
            d = float(e.get("dur", 0.0))
            rec = by_name.setdefault(e["name"], [0.0, 0])
            rec[0] += d / 1e3
            rec[1] += 1
            by_class[kernel_class(e["name"])] += d / 1e3
        out[dev] = {"kernels": len(kernels), "busy_ms": busy / 1e3,
                    "span_ms": span / 1e3, "span_from": span_from,
                    "busy_share": busy / span if span > 0 else float("nan"),
                    "steps": len(steps), "by_class": dict(by_class),
                    "by_name": by_name}
    return out


def to_ns(us) -> int:
    """A Chrome trace's µs as ns on the trace's own time base."""
    return int(round(float(us) * 1e3))


def device_ops(events: List[dict]) -> List[DeviceOp]:
    """The trace's kernels, copies and sets, each with the start of the
    CUDA runtime or driver call that launched it (the event of that
    category with the same `args.correlation`; None where there is none),
    in ns on the trace's time base."""
    launch = {e["args"]["correlation"]: to_ns(e["ts"]) for e in events
              if e.get("cat") in LAUNCH_CALLS
              and "correlation" in (e.get("args") or {})}
    return [DeviceOp(e["name"], to_ns(e["ts"]),
                     to_ns(float(e["ts"]) + float(e.get("dur", 0.0))),
                     launch.get((e.get("args") or {}).get("correlation")))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def span_rollup(events: List[dict]) -> Optional[dict]:
    """`rollup` over the trace's program spans and device ops, with the
    attributed share under "share"; None without program spans."""
    marked = sorted((e for e in events if e.get("ph") == "X"
                     and "span" in (e.get("args") or {})),
                    key=lambda e: e["args"]["index"])
    if not marked:
        return None
    recorded = [Span(e["args"]["span"], to_ns(e["ts"]),
                     to_ns(float(e["ts"]) + float(e.get("dur", 0.0))),
                     e["args"]["parent"]) for e in marked]
    ops = device_ops(events)
    rolled = rollup(recorded, ops)
    return {"by_span": rolled, "share": attributed_share(rolled, ops)}


def print_spans(rolled: dict) -> None:
    print(f"\n== by program span ({100 * rolled['share']:.1f}% of device "
          f"time launched in a span; nested spans count in their parents) ==")
    print(f"  {'span':24s} {'count':>6s} {'device ms':>10s} "
          f"{'launches':>9s} {'host ms':>10s} {'idle ms':>10s}")
    for name, e in sorted(rolled["by_span"].items(),
                          key=lambda kv: -kv[1]["device_s"]):
        print(f"  {name:24s} {e['count']:6d} {1e3 * e['device_s']:10.3f} "
              f"{e['launches']:9d} {1e3 * e['host_s']:10.3f} "
              f"{1e3 * e['idle_s']:10.3f}")


def print_report(summary: Dict[str, dict], top: int) -> None:
    for dev, s in summary.items():
        print(f"\n== device {dev}: {s['kernels']} kernels, busy "
              f"{s['busy_ms']:.3f} ms over a {s['span_ms']:.3f} ms span "
              f"({s['span_from']}) → {100 * s['busy_share']:.1f}% busy")
        if s["steps"]:
            print(f"per step: busy {s['busy_ms'] / s['steps']:.3f} ms, span "
                  f"{s['span_ms'] / s['steps']:.3f} ms")
        print("== class rollup ==")
        for c, d in sorted(s["by_class"].items(), key=lambda kv: -kv[1]):
            print(f"  {c:24s} {d:10.3f} ms  {100 * d / s['busy_ms']:5.1f}%")
        print(f"== top {top} kernels ==")
        for name, (d, n) in sorted(s["by_name"].items(),
                                   key=lambda kv: -kv[1][0])[:top]:
            print(f"  {d:10.3f} ms  {100 * d / s['busy_ms']:5.1f}%  "
                  f"n={n:6d}  {name[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("device-time breakdown of a torch trace")
    ap.add_argument("trace", help="a *.pt.trace.json file, or a directory "
                                  "holding one (the newest is read)")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    path = trace_path(args.trace)
    print(f"# {path}", file=sys.stderr)
    events = load_events(path)
    summary = analyze(events)
    if not summary:
        print("NO DEVICE KERNEL in this trace: only host events were "
              "recorded (a CPU run, or a profiler without CUDA activity). "
              "Host time is not device time; nothing to attribute.")
        return 1
    print_report(summary, args.top)
    rolled = span_rollup(events)
    if rolled is not None:
        print_spans(rolled)
    return 0


if __name__ == "__main__":
    sys.exit(main())
