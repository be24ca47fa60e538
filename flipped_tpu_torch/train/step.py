"""Train step with gradient accumulation, and the classification eval step
(JAX: flipped_tpu/train/step.py).

PyTorch runs eagerly, so the JAX jit wrappers and their compile-shape
bucketing become plain calls; `bucket_span` is kept so both packages score
the same answer window. Single-process only: the multi-process span
agreement and the dp all-reduce come with the parallelism port.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..data.batching import eval_span
from .objectives import (compute_objective_losses, option_scores,
                         option_scores_cached)
from .optim import Optimizer


class TrainMetrics(NamedTuple):
    loss: torch.Tensor
    vqa_loss: torch.Tensor
    vaq_loss: torch.Tensor
    qav_loss: torch.Tensor
    grad_norm: torch.Tensor
    lr: float


def make_train_step(model, optimizer: Optimizer, vaq: bool, qav: bool,
                    lm_chunk: int = 0):
    """Returns train_step(batch) → TrainMetrics, one optimizer update per
    call (JAX: step.py:35-87). lm_chunk > 0 computes the LM-head CE in
    sequence chunks (`objectives.lm_ce_rowwise_chunked`).

    `batch` leaves have a leading accumulation axis (accum, B, ...): the
    microbatches' gradients are summed and divided by accum, as the JAX
    scan does (the reference's loss/accum_iter, engine.py:37-41).
    grad_norm is the global norm of the averaged gradients, before
    clipping."""

    def train_step(batch: Dict[str, torch.Tensor]) -> TrainMetrics:
        accum = batch["vqa_tokens"].shape[0]
        optimizer.zero_grad()
        per_micro = []
        for i in range(accum):
            losses = compute_objective_losses(
                model, {k: v[i] for k, v in batch.items()}, vaq, qav,
                lm_chunk=lm_chunk)
            losses.total.backward()
            per_micro.append(torch.stack([losses.total.detach(),
                                          *(x.detach() for x in losses)]))
        grads = [p.grad for p in optimizer.params]
        if accum > 1:
            for g in grads:
                g.div_(accum)
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        lr = optimizer.step(grad_norm)
        loss, vqa_loss, vaq_loss, qav_loss = torch.stack(per_micro).mean(0)
        return TrainMetrics(loss=loss, vqa_loss=vqa_loss, vaq_loss=vaq_loss,
                            qav_loss=qav_loss, grad_norm=grad_norm, lr=lr)

    return train_step


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
