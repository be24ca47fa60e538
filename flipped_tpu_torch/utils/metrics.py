"""Windowed meters, the train and eval loops' progress lines, and the
per-question-type accuracy buckets (JAX: flipped_tpu/utils/metrics.py).

`SmoothedValue` and `MetricLogger` are the JAX package's (metrics.py:61-196,
the reference's util/misc.py:27-172): a windowed median and mean beside an
exact count-weighted global average, and `log_every`, which prints a
progress line every `print_freq` iterations and at the last, with the
meters, the iteration and data times and, on the card, the allocated and
peak device memory (`device_memory_gib`). Under torch.distributed the
meters are merged across ranks (`allgather_payload`, JAX metrics.py:20-41,
76-91, 134-152): every rank of a dp row logs the same values, so the merge
scales counts and totals alike and leaves the averages as they are. The
per-question-type buckets (`log_qtype` and its
tables) are the port's own copy of the JAX package's plain-Python ones
(metrics.py:199-253).
"""
from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..core.collectives import all_gather_object


def allgather_payload(obj):
    """Every rank's small picklable `obj`, in rank order ([obj] in one
    process)."""
    return all_gather_object(obj)


def device_memory_gib() -> Optional[Tuple[float, float]]:
    """(allocated GiB, peak allocated GiB) of the current CUDA device, as
    the reference's `torch.cuda.max_memory_allocated` print (util/misc.py:
    162-170), or None where no CUDA context has been made (a CPU run)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    gib = 1024 ** 3
    return (torch.cuda.memory_allocated() / gib,
            torch.cuda.max_memory_allocated() / gib)


class SmoothedValue:
    """Windowed median/avg + weighted global average
    (reference: util/misc.py:27-103)."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0.0
        self.fmt = fmt

    def update(self, value: float, n: float = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """Sum (count, total) over the ranks (the reference's
        dist.all_reduce, misc.py:58-70). Every rank must call it the same
        number of times."""
        parts = allgather_payload([self.count, self.total])
        self.count = float(sum(c for c, _ in parts))
        self.total = float(sum(t for _, t in parts))

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1e-12)

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """(reference: util/misc.py:106-172)"""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, n: float = 1, **kwargs):
        for k, v in kwargs.items():
            if v is None:
                continue
            self.meters[k].update(float(v), n=n)

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def synchronize_between_processes(self):
        """Merge (count, total) of every meter over the ranks, in one
        payload gather; a meter that only some ranks have (a question type
        only some shards hold) is installed on every rank."""
        merged: Dict[str, list] = {}
        for d in allgather_payload({k: [m.count, m.total]
                                    for k, m in self.meters.items()}):
            for k, (c, t) in d.items():
                mc, mt = merged.get(k, (0.0, 0.0))
                merged[k] = [mc + c, mt + t]
        for k, (c, t) in merged.items():
            meter = self.meters[k]
            meter.count, meter.total = c, t

    def averages(self) -> Dict[str, float]:
        """Each meter's count-weighted mean over everything it was given:
        exact, whatever the window."""
        return {k: m.global_avg for k, m in self.meters.items()}

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "") -> Iterable:
        """Iterate with iter/data-time meters and a progress line at every
        `print_freq`-th iteration and the last (reference: util/misc.py:
        124-172; JAX metrics.py:160-196)."""
        i = 0
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if print_freq and (i % max(print_freq, 1) == 0
                               or (total and i == total - 1)):
                eta = ""
                if total:
                    eta_s = iter_time.global_avg * (total - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(eta_s))}  "
                mem = device_memory_gib()
                mem_s = f"  hbm: {mem[0]:.2f}/{mem[1]:.2f}GiB" if mem else ""
                print(f"{header} [{i}{f'/{total}' if total else ''}]  {eta}"
                      f"{self}  time: {iter_time}  data: {data_time}{mem_s}",
                      flush=True)
            i += 1
            end = time.time()
        if total is not None:
            elapsed = time.time() - start
            print(f"{header} Total time: "
                  f"{datetime.timedelta(seconds=int(elapsed))} "
                  f"({elapsed / max(total, 1):.4f} s / it)", flush=True)


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
