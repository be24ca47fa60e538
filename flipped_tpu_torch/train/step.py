"""Train step with gradient accumulation, and the classification eval step
(JAX: flipped_tpu/train/step.py).

PyTorch runs eagerly, so the JAX jit wrappers and their compile-shape
bucketing become plain calls; `bucket_span` is kept so both packages score
the same answer window.

Under a mesh (model/parallel.py) the step does what GSPMD's partitioned
program does: the trainables a tp rank uses in part (the gates of a
head-split attention, `tp_partial_parameters`) are summed over tp, while
those that reach the split layers through `copy_to` arrive whole; then
every trainable's gradient is summed over the ranks of one tp index
(dp×pp×sp) once, in one flat all-reduce. Under pp each trainable's
gradient lies on the stages that use it: a stage's gates and adapter rows
on that stage (the tp sum comes first, as only that stage's ranks know
that its heads split), the splice's leaves (visual_proj, temporal_emb,
the audio leaves) on stage 0, and the heads' on the last stage, whose
loss alone is backpropagated (model/pipeline.py `loss_weight`); a
trainable a rank does not use gets a zero gradient, so the one sum over
dp×pp×sp counts each use once. The trainables are replicated, so after
the sums every rank holds the same gradients, the same (global) norm and
takes the same update. The losses are each rank's share of the global
token mean (train/objectives.py), summed over dp×sp (not over pp: every
stage computes the same losses) for the metrics. A multi-process eval
pins one answer window for every rank (`span_len`, data/pipeline.py
`pinned_eval_span`).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..core import collectives as C
from ..core.mesh import DPSP, GRADS, TP_AXIS
from ..data.batching import eval_span
from ..model.parallel import tp_partial_parameters
from ..model.pipeline import loss_weight
from ..utils.spans import span
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
    mesh = getattr(model, "mesh", None)
    dpsp = mesh.group(DPSP) if mesh is not None else None
    across = mesh.group(GRADS) if mesh is not None else None
    tp = mesh.group(TP_AXIS) if mesh is not None else None
    partial = tp_partial_parameters(model) if tp is not None else []
    weight = loss_weight(model)

    def train_step(batch: Dict[str, torch.Tensor]) -> TrainMetrics:
        with span("train.step"):
            return _train_step(batch)

    def _train_step(batch):
        accum = batch["vqa_tokens"].shape[0]
        optimizer.zero_grad()
        per_micro = []
        for i in range(accum):
            with span("train.forward"):
                losses = compute_objective_losses(
                    model, {k: v[i] for k, v in batch.items()}, vaq, qav,
                    lm_chunk=lm_chunk)
            with span("train.backward"):
                (losses.total * weight).backward()
            per_micro.append(torch.stack([losses.total.detach(),
                                          *(x.detach() for x in losses)]))
        with span("train.update"):
            for p in optimizer.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in optimizer.params]
            # first over tp, within the stage whose blocks split their heads
            _sum_grads([p.grad for p in partial], tp)
            _sum_grads(grads, across)
            if accum > 1:
                for g in grads:
                    g.div_(accum)
            grad_norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            lr = optimizer.step(grad_norm)
        per_micro = C.all_reduce(torch.stack(per_micro), dpsp)
        loss, vqa_loss, vaq_loss, qav_loss = per_micro.mean(0)
        return TrainMetrics(loss=loss, vqa_loss=vqa_loss, vaq_loss=vaq_loss,
                            qav_loss=qav_loss, grad_norm=grad_norm, lr=lr)

    return train_step


@torch.no_grad()
def _sum_grads(grads, group) -> None:
    """Sum the gradients over `group` in one flat all-reduce."""
    if group is None or not grads:
        return
    flat = C.all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


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


def make_eval_step(model, cached: bool = True, span_len=None):
    """Returns eval_step(batch, span_info=None) → {'scores' (B, n_opt),
    'prediction' (B,)}.

    cached=True scores against a shared prompt cache, sizing the scored
    window from `span_info` (the loader's pack-time (span_need,
    span_exact)) or from the labels, and falls back to the dense scorer
    when a label precedes the prefix; an explicit `span_len` (the
    multi-process pin) scores that window for every batch (JAX:
    step.py:153-209). cached=False always runs the dense per-option
    forward.
    """

    def finish(scores) -> Dict[str, torch.Tensor]:
        return {"scores": scores, "prediction": scores.argmin(-1)}

    @torch.inference_mode()
    def eval_step(batch, span_info: Optional[tuple] = None):
        with span("eval.step"):
            return _eval_step(batch, span_info)

    def _eval_step(batch, span_info):
        if not cached:
            return finish(option_scores(model, batch))
        if span_len is not None:
            return finish(option_scores_cached(model, batch, span_len))
        need, exact = (span_info if span_info is not None
                       else required_eval_span(batch))
        if not exact:
            return finish(option_scores(model, batch))
        s = batch["vqa_labels"].shape[-1]
        return finish(option_scores_cached(model, batch, bucket_span(need, s)))

    return eval_step
