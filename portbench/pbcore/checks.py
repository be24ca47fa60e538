"""The numbers that decide `correct`, each against its limit.

Training is compared by the worst leaf: for each trainable, the gap
between the program's norm and the reference's, over the reference's norm
of that leaf or of the median leaf, whichever is larger (some gradients
are all but zero). A leaf whose reference gradient is under a thousandth
of the median leaf's moves by round-off alone under Adam, and is left out
of the change.
"""
from __future__ import annotations

import statistics
import sys
from typing import Dict, Iterable, Optional

ROUND_OFF = 1e-3


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               leaves: Optional[Iterable[str]] = None) -> float:
    names = list(ref) if leaves is None else list(leaves)
    if set(names) - set(prog):
        return float("inf")                     # a leaf the program lost
    med = statistics.median(ref[k] for k in ref)
    worst = 0.0
    for k in names:
        den = max(ref[k], med)
        gap = abs(prog[k] - ref[k])
        worst = max(worst, gap / den if den > 0 else (0.0 if gap == 0
                                                      else float("inf")))
    return worst


def moved_leaves(grad1: Dict[str, float]):
    """The leaves whose first reference gradient is not nought to
    rounding: at least a thousandth of the median leaf's."""
    med = statistics.median(grad1.values())
    return [k for k, g in grad1.items() if g >= ROUND_OFF * med]


def train_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """loss_rel: the largest relative gap of an objective's loss over the
    followed steps; grad_rel and change_rel: the worst leaf of the first
    gradient and of the change after the followed steps."""
    loss = 0.0
    for p, r in zip(prog["losses"], ref["losses"]):
        for k, rv in r.items():
            if rv == 0.0 and p[k] == 0.0:
                continue
            loss = max(loss, abs(p[k] - rv) / abs(rv))
    if len(prog["losses"]) < len(ref["losses"]):
        loss = float("inf")
    return {"loss_rel": loss,
            "grad_rel": worst_leaf(prog["grad1"], ref["grad1"]),
            "change_rel": worst_leaf(prog["change"], ref["change"],
                                     moved_leaves(ref["grad1"]))}


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every reading at most its limit; a reading without a limit, or a
    limit without a reading, is not correct."""
    if not readings or set(readings) != set(limits):
        return False
    return all(readings[k] <= limits[k] for k in readings)


def report(readings: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {'value', 'limit'}} for the result line, and the same as the
    last lines of standard error."""
    out = {k: {"value": readings.get(k), "limit": limits.get(k)}
           for k in sorted(set(readings) | set(limits))}
    for k, v in out.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    return out
