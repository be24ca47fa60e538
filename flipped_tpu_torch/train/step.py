"""Classification eval step (JAX: flipped_tpu/train/step.py:115-210).

PyTorch runs eagerly, so the JAX jit wrappers and their compile-shape
bucketing become plain calls; `bucket_span` is kept so both packages score
the same answer window. Single-process only: the multi-process span
agreement comes with the parallelism port.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from flipped_tpu.data.batching import eval_span

from .objectives import option_scores, option_scores_cached


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def required_eval_span(batch) -> tuple:
    """(span_len, exact): the smallest L with every nonzero label in
    [prefix, prefix+L], and whether such an L exists."""
    need, exact = eval_span(_host(batch["vqa_labels"]), _host(batch["prefix"]))
    return max(need, 1), exact


def bucket_span(n: int, s: int) -> int:
    """Round up to a multiple of 8, capped at S-1."""
    return min(max(8, -(-n // 8) * 8), max(s - 1, 1))


def make_eval_step(model, cached: bool = True):
    """Returns eval_step(batch, span_info=None) → {'scores' (B, n_opt),
    'prediction' (B,)}.

    cached=True scores against a shared prompt cache, sizing the scored
    window from `span_info` (the loader's pack-time (span_need,
    span_exact)) or from the labels, and falls back to the dense scorer
    when a label precedes the prefix. cached=False always runs the dense
    per-option forward.
    """

    def finish(scores) -> Dict[str, torch.Tensor]:
        return {"scores": scores, "prediction": scores.argmin(-1)}

    @torch.inference_mode()
    def eval_step(batch, span_info: Optional[tuple] = None):
        if not cached:
            return finish(option_scores(model, batch))
        need, exact = (span_info if span_info is not None
                       else required_eval_span(batch))
        if not exact:
            return finish(option_scores(model, batch))
        s = batch["vqa_labels"].shape[-1]
        return finish(option_scores_cached(model, batch, bucket_span(need, s)))

    return eval_step
