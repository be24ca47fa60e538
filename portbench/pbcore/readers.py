"""The arithmetic of the per-layer metrics, shared by their readers
(`metrics/<name>.py`). Each takes the traced run's context: the
counters its mode reports for the traced window (`units`, model `flops`
by precision, `linear_least_s`), the card's `peaks`, the kernel
`classes`, and the trace's `busy_s`, `window_s` and device seconds by
class (`class_s`). A reader with nothing to read returns None.
"""
from __future__ import annotations

from typing import Optional

from . import counts, registry


def mfu(ctx) -> Optional[float]:
    """% of the window that the card's peaks need for the model FLOPs
    of the units completed in it."""
    flops = ctx["counters"].get("flops")
    if not flops or not ctx["window_s"]:
        return None
    return 100.0 * counts.least_seconds(flops, ctx["peaks"]) / ctx["window_s"]


def idle_share(ctx) -> Optional[float]:
    """% of the traced window in which no operation ran on the card."""
    if not ctx["window_s"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def plain_ms_per_unit(ctx) -> Optional[float]:
    """Device ms a unit of work of kernels in no class: the plain
    layers."""
    units = ctx["counters"].get("units")
    if not units:
        return None
    return 1e3 * ctx["class_s"].get(registry.PLAIN, 0.0) / units


def linear_roofline(ctx) -> Optional[float]:
    """% of the linear classes' device time that the peaks need for the
    frozen linears' and the LM head's products."""
    least = ctx["counters"].get("linear_least_s")
    linear = {c["name"] for c in ctx["classes"] if c.get("linear")}
    spent = sum(t for c, t in ctx["class_s"].items() if c in linear)
    if not least or not spent:
        return None
    return 100.0 * least / spent
