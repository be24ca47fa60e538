"""A minimal metric logger for the eval loop (JAX: flipped_tpu/utils/metrics.py).

Count-weighted meters whose epoch average is exact, as in the JAX
MetricLogger; single-process, so there is no cross-process sync. The
per-question-type buckets reuse the JAX package's `log_qtype`, which is
plain Python and only calls `update` on the logger it is given.
"""
from __future__ import annotations

from typing import Dict

from flipped_tpu.utils.metrics import log_qtype  # noqa: F401  (re-exported)


class MetricLogger:
    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, float] = {}

    def update(self, n: float = 1, **kwargs):
        for k, v in kwargs.items():
            if v is None:
                continue
            self.totals[k] = self.totals.get(k, 0.0) + float(v) * n
            self.counts[k] = self.counts.get(k, 0.0) + n

    def averages(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1e-12)
                for k in self.totals}

    def __str__(self):
        return "  ".join(f"{k}: {v:.4f}" for k, v in self.averages().items())
