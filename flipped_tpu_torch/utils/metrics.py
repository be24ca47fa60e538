"""A minimal metric logger for the train and eval loops
(JAX: flipped_tpu/utils/metrics.py).

Count-weighted meters whose epoch average is exact, as in the JAX
MetricLogger; single-process, so there is no cross-process sync. The
per-question-type buckets (`log_qtype` and its tables) are the port's own
copy of the JAX package's plain-Python ones (metrics.py:199-253).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


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


# --- per-question-type accuracy buckets ---------------------------------------

def qtype_frequencies(qtypes: np.ndarray, correct: np.ndarray,
                      qtype_ids) -> Dict[int, list]:
    """bucket 0 = overall (reference: util/misc.py:416-426)."""
    freq = {i: [0.0, 0.0] for i in qtype_ids}
    freq[0] = [0.0, 0.0]
    for qt, c in zip(np.asarray(qtypes).tolist(),
                     np.asarray(correct, np.float64).tolist()):
        if qt in freq:
            freq[qt][0] += c
            freq[qt][1] += 1
        freq[0][0] += c
        freq[0][1] += 1
    return freq


def _grouped(freq, ids):
    num = sum(freq[i][0] for i in ids)
    den = sum(freq[i][1] for i in ids)
    return num / den if den else 0.0, den


# Per-dataset qtype grouping (reference: util/misc.py:428-532)
_GROUPS = {
    "nextqa": {"C": [1, 2], "T": [3, 4, 5], "D": [6, 7, 8], "Total": [0]},
    "star": {"In": [1], "Seq": [2], "Pre": [3], "Feas": [4], "Total": [0]},
    "valor32k": {
        "audio": [2, 5, 8, 11, 14, 17], "visual": [1, 4, 7, 10, 13, 16, 20],
        "both": [3, 6, 9, 12, 15, 18, 19], "count": [1, 2, 3],
        "temporal": [4, 5, 6], "desc": [7, 8, 9], "action": [10, 11, 12],
        "loc": [13, 14, 15], "rel_pos": [16, 17, 18],
        "audio_second": [19, 20], "Total": [0],
    },
    "musicavqa": {
        "audio": [1, 2, 3, 4, 5], "visual": [6, 7, 8, 9, 10],
        "audio_visual": [11, 12, 13, 14, 15], "temporal": [1, 6, 11],
        "existential": [2, 7, 12], "comparative": [3, 8, 13],
        "location": [4, 9, 14], "counting": [5, 10, 15], "Total": [0],
    },
}


def log_qtype(dataset_name: str, qtypes: np.ndarray, correct: np.ndarray,
              logger: MetricLogger, qtype_ids=None):
    """Update grouped accuracy meters (reference: util/misc.py:522-532).
    Meters are count-weighted so epoch-level averages are exact."""
    groups = _GROUPS.get(dataset_name)
    if not groups:
        return
    if qtype_ids is None:
        qtype_ids = sorted({i for ids in groups.values() for i in ids} - {0})
    freq = qtype_frequencies(qtypes, correct, qtype_ids)
    for name, ids in groups.items():
        acc, n = _grouped(freq, ids)
        if n:
            logger.update(n=n, **{name: acc})
