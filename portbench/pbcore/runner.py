"""One run of one cell: set-up, the measured (or traced) window, the
reading of the peak, the program freed, the reference's comparison, and
the result line.

A mode (`modes/<mode>.py`) gives a `Session(ctx)` with `setup()`,
`unit()` (one unit of work, synchronized, or sent where the session
runs ahead of the card; → its examples), optionally `drain()` (waits
for every unit sent),
`end_to_end(units, seconds)`, `counters(units)`, `release()` and
`answers()` (what the timed path produced that is compared), and beside
it `reference(ctx, session)` (the plain reference's answers, computed
after the program is freed) and `compare(answers, reference)` (→ the
numbers compared, by name).
"""
from __future__ import annotations

import sys
import time
from typing import Dict, Optional

import torch

from . import checks, registry, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "flipped_tpu")


class Context:
    """What a mode is given: the cell's files, the seed, the device, the
    spans it records, and (for the fault tests and the controls) a fault
    to plant, a --quantize mode in place of the configuration's, or the
    reference's activation levels in place of the configuration's."""

    def __init__(self, cell: registry.Cell, seed: int, device,
                 peaks: Optional[dict], fault: Optional[str] = None,
                 quantize: Optional[str] = None,
                 ref_act_levels: Optional[int] = None):
        self.cell = cell
        self.config, self.traffic = cell.config, cell.traffic
        self.seed, self.device, self.peaks = seed, device, peaks
        self.fault, self.quantize = fault, quantize
        self.ref_act_levels = ref_act_levels
        self.spans = trace.Spans()

    def sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port may not load,
    compared whole (`flipped_tpu_torch` is not `flipped_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def measure(sess, seconds: float, limit_units: Optional[int] = None):
    """Units of work back to back until `seconds` have passed (or
    `limit_units` are sent); then nothing more is sent, the session waits
    for all it sent, and the clock is read after that wait → (units,
    examples, seconds to the end of the last unit)."""
    units = examples = 0
    t0 = time.perf_counter()
    while True:
        examples += sess.unit()
        units += 1
        if (time.perf_counter() - t0 >= seconds
                or (limit_units and units >= limit_units)):
            break
    if hasattr(sess, "drain"):
        sess.drain()
    return units, examples, time.perf_counter() - t0


def per_layer(cell: registry.Cell, mctx: Dict) -> Dict:
    out = {}
    for m in cell.per_layer:
        value = registry.load_metric(m["name"]).read(mctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(cell: registry.Cell, ctx: Context, seconds: float, traced: bool,
        t_start: float) -> Dict:
    """One run → the result line's object."""
    t_session = time.perf_counter()
    mode = registry.load_mode(cell.mode)
    sess = mode.Session(ctx)
    sess.setup()
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    parts = {"imports": t_session - t_start}
    for name, a, b in ctx.spans.items:
        parts[name] = parts.get(name, 0.0) + (b - a) * 1e-9
    summary = None
    if traced:
        classes = registry.kernel_classes()
        with trace.Trace() as tr:
            t0 = time.time_ns()
            units, examples, elapsed = measure(
                sess, seconds, cell.traffic.get("trace_units"))
            t1 = time.time_ns()
        summary = trace.summarize(tr.events(), ctx.spans, t0, t1, classes)
    else:
        units, examples, elapsed = measure(sess, seconds)
    on_card = torch.device(ctx.device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"the run loaded {bad}: the port may not load JAX "
                         f"or the JAX package")
    if traced:
        mctx = {"counters": sess.counters(units), "peaks": ctx.peaks,
                "classes": registry.kernel_classes(), **summary}
        metrics = per_layer(cell, mctx)
    else:
        values = dict(sess.end_to_end(units, elapsed),
                      peak_mem_gib=peak / 2 ** 30, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    sess.release()
    readings = mode.compare(sess.answers(), mode.reference(ctx, sess))
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": (torch.cuda.get_device_name(0) if on_card
                       else "cpu"),
              "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": checks.judge(readings, cell.limits),
           "attempted": examples, "failed": 0, "metrics": metrics,
           "device": device}
    if traced:
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        out["breakdown"] = summary["breakdown"]
        print(f"plain kernels (class {registry.PLAIN}): "
              f"{summary['plain_top']}", file=sys.stderr)
        print(f"device s by class: {summary['class_s']}", file=sys.stderr)
    print(f"units {units} in {elapsed:.4f} s, set-up {setup_s:.4f} s "
          f"{ {k: round(v, 3) for k, v in parts.items()} }", file=sys.stderr)
    out["checks"] = checks.report(readings, cell.limits)
    return out
