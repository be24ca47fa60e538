"""The three flipped objectives as one fused forward, and the
classification-eval scorers (JAX: flipped_tpu/train/objectives.py).

Training: the enabled objectives (VQA always, VAQ, QAV) are stacked on the
batch axis into one `encode`, with per-sequence `video_start` (-1 on QAV
rows) in place of a Python gate2 branch. The LM head runs only on the VQA
and VAQ rows; QAV is a CE over the F frames of h·vfᵀ/tau. VQA/VAQ use
ignore index 0, QAV ignore index -1 (reference: model.py:233-235).

Eval: per-token CE with ignore index 0, summed per option and divided by the
count of NONZERO token losses (not the label mask), prediction = argmin.

`--lm_head_chunk` (`lm_chunk` > 0) sweeps the LM head over the sequence in
chunks, each recomputed in the backward, so that one chunk's vocab-width
logits are live at a time (`lm_ce_rowwise_chunked`).

Under a mesh (model/parallel.py) the losses are global token means, as
GSPMD computes them: each rank divides its own sum by the valid count of
the whole dp×sp group, all-reduced without gradient, so the dp×sp sum of
the ranks' losses (and of their gradients, train/step.py) is the mean over
every token of the global batch. A mean of per-rank means (DDP's) would
differ where ranks hold different counts. Under sp the labels are shifted
on the full S before the cut (`shift_rows`): a shard's last row predicts
the next shard's first label.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core import collectives as C
from ..core.mesh import DPSP
from ..utils.spans import span


class Losses(NamedTuple):
    vqa: torch.Tensor
    vaq: torch.Tensor
    qav: torch.Tensor

    @property
    def total(self):
        return self.vqa + self.vaq + self.qav


def global_count(count: torch.Tensor, group) -> torch.Tensor:
    """`count` summed over `group` (None: this rank's), no gradient."""
    if group is None:
        return count
    return C.all_reduce(count.detach().clone(), group)


def ce_ignore_index(logits: torch.Tensor, labels: torch.Tensor,
                    ignore_index: int, group=None) -> torch.Tensor:
    """Mean CE over positions where labels != ignore_index
    (JAX: objectives.py:37-47); with a `group`, this rank's sum over the
    group's valid count."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    tok_ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    losses = torch.where(valid, -tok_ll, torch.zeros_like(tok_ll))
    return losses.sum() / global_count(valid.sum(), group).clamp_min(1)


def shift_rows(model, h: torch.Tensor, labels: torch.Tensor,
               ignore_index: int):
    """(rows of h, their targets): each row predicts the next position's
    label. Whole sequences: h[:, :-1] against labels[:, 1:]
    (objectives.py:145-166). Under the sp cut h holds this rank's rows of
    the sequence: labels are shifted on the full S, the last position
    ignored, then cut to the same rows."""
    seq = model.seq_cut(labels.shape[1], labels.shape[0])
    if seq is None or seq.reason is not None:
        return h[:, :-1], labels[:, 1:]
    nxt = torch.cat([labels[:, 1:],
                     torch.full_like(labels[:, :1], ignore_index)], dim=1)
    return h, nxt[:, seq.offset:seq.offset + seq.length]


def token_ce_unreduced(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Per-token CE, 0.0 where labels == 0 (JAX: objectives.py:50-57)."""
    logits = logits.float()
    valid = labels != 0
    logp = torch.log_softmax(logits, dim=-1)
    tok_ll = torch.gather(logp, -1, labels.long().clamp_min(0)[..., None])[..., 0]
    return torch.where(valid, -tok_ll, torch.zeros_like(tok_ll))


def _chunk_ce(model, h, labels):
    """(CE sum, valid count) per row of one chunk: ignore index 0, f32
    log-softmax (JAX: objectives.py:93-100)."""
    logits = model.lm_logits(h).float()
    valid = labels != 0
    logp = torch.log_softmax(logits, dim=-1)
    tok_ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return (torch.where(valid, -tok_ll, torch.zeros_like(tok_ll)).sum(-1),
            valid.sum(-1))


def lm_ce_rowwise_chunked(model, h: torch.Tensor, labels: torch.Tensor,
                          chunk_size: int):
    """Per-row CE sum and valid-token count without the (rows, S-1, vocab)
    logit tensor (JAX: objectives.py:60-106). The sequence axis is swept in
    `chunk_size` slices; each slice projects to vocab and reduces to a
    per-row (sum, count) under `torch.utils.checkpoint`, so the backward
    recomputes the slice's logits instead of keeping them: one chunk's
    vocab-width logits are live at a time. The last slice is shorter where
    chunk_size does not divide S-1 (JAX pads it with ignored labels: the
    same sums). Only the order of the sum over chunks differs from the
    dense head.

    h: (rows, S-1, D), already shifted; labels: (rows, S-1), ignore index 0.
    Returns (sum (rows,) f32, count (rows,) int64).
    """
    rows, sm1, _ = h.shape
    total = torch.zeros(rows, dtype=torch.float32, device=h.device)
    count = torch.zeros(rows, dtype=torch.int64, device=h.device)
    for start in range(0, sm1, chunk_size):
        stop = min(start + chunk_size, sm1)
        s, c = checkpoint(_chunk_ce, model, h[:, start:stop],
                          labels[:, start:stop], use_reentrant=False)
        total = total + s
        count = count + c
    return total, count


def fused_forward(model, batch: Dict[str, torch.Tensor], vaq: bool,
                  qav: bool):
    """fuse + one stacked encode → ({objective: h (B, S, D)}, vf (B, F, D))
    (JAX: objectives.py:109-131). Training batch keys: video (B, F, Dv)
    (absent under --audio_only) and audio (B, Fa, Da) (under --audio) and,
    per objective k, {k}_tokens/{k}_labels (B, S), {k}_video_start (B,),
    {k}_splice (B, F)."""
    vf = model.fuse(batch.get("video"), batch.get("audio"))
    b = batch["vqa_tokens"].shape[0]
    keys = ["vqa"] + (["vaq"] if vaq else []) + (["qav"] if qav else [])
    tokens = torch.cat([batch[f"{k}_tokens"] for k in keys])
    vstart = torch.cat([batch[f"{k}_video_start"] for k in keys])
    splice = torch.cat([batch[f"{k}_splice"] for k in keys])
    h = model.encode(tokens, vf.repeat(len(keys), 1, 1), vstart, splice)
    return {k: h[i * b:(i + 1) * b] for i, k in enumerate(keys)}, vf


def compute_objective_losses(model, batch: Dict[str, torch.Tensor],
                             vaq: bool, qav: bool,
                             lm_chunk: int = 0) -> Losses:
    """The three losses of one microbatch, the LM head over the VQA and VAQ
    rows only: dense, or with lm_chunk > 0 swept in sequence chunks of that
    size (`lm_ce_rowwise_chunked`), the same losses with bounded vocab-width
    memory (JAX: objectives.py:134-175). Under a mesh each loss is this
    rank's share of the global token mean (module note)."""
    mesh = getattr(model, "mesh", None)
    group = mesh.group(DPSP) if mesh is not None else None
    parts, vf = fused_forward(model, batch, vaq, qav)
    zero = torch.zeros((), device=vf.device)
    lm_keys = ["vqa"] + (["vaq"] if vaq else [])
    b = batch["vqa_tokens"].shape[0]
    rows = [shift_rows(model, parts[k], batch[f"{k}_labels"], 0)
            for k in lm_keys]
    lm_h = torch.cat([h for h, _ in rows])
    lm_labels = torch.cat([t for _, t in rows])

    if lm_chunk > 0:
        tot, cnt = lm_ce_rowwise_chunked(model, lm_h, lm_labels, lm_chunk)

        def lm_loss(idx):
            sel = slice(idx * b, (idx + 1) * b)
            return (tot[sel].sum()
                    / global_count(cnt[sel].sum(), group).clamp_min(1))
    else:
        logits = model.lm_logits(lm_h)

        def lm_loss(idx):
            sel = slice(idx * b, (idx + 1) * b)
            return ce_ignore_index(logits[sel], lm_labels[sel],
                                   ignore_index=0, group=group)

    vqa_loss = lm_loss(0)
    vaq_loss = lm_loss(1) if vaq else zero
    qav_loss = zero
    if qav:
        h_rows, q_labels = shift_rows(model, parts["qav"],
                                      batch["qav_labels"], -1)
        qav_loss = ce_ignore_index(model.qav_row_logits(h_rows, vf),
                                   q_labels, ignore_index=-1, group=group)
    return Losses(vqa=vqa_loss, vaq=vaq_loss, qav=qav_loss)


def option_scores(model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Dense scorer: every option's full sequence through the model →
    (B, n_options) mean token CE (JAX: objectives.py:178-204)."""
    tokens = batch["vqa_tokens"]          # (B, n_opt, S)
    labels = batch["vqa_labels"]
    b, n_opt, s = tokens.shape
    vf = model.fuse(batch.get("video"), batch.get("audio"))
    vf_rep = vf.repeat_interleave(n_opt, dim=0)
    vstart = batch["vqa_video_start"].repeat_interleave(n_opt, dim=0)
    splice = batch["vqa_splice"].repeat_interleave(n_opt, dim=0)
    h = model.encode_full(tokens.reshape(b * n_opt, s), vf_rep, vstart,
                          splice)
    logits = model.lm_logits(h[:, :-1])
    tok_losses = token_ce_unreduced(
        logits, labels.reshape(b * n_opt, s)[:, 1:]).view(b, n_opt, s - 1)
    count = (tok_losses != 0).sum(-1).clamp_min(1)
    return tok_losses.sum(-1) / count


def option_scores_cached(model, batch: Dict[str, torch.Tensor],
                         span_len: int = 32) -> torch.Tensor:
    """Prefix-shared scorer: one prefill of the shared prompt, then all
    options' answer spans (≤ span_len tokens) in one chunk-extend forward.
    Same scores as `option_scores` for spans of length ≤ span_len + 1
    (JAX: objectives.py:207-266)."""
    tokens = batch["vqa_tokens"]
    labels = batch["vqa_labels"]
    prefix = batch["prefix"].long()
    b, n_opt, s = tokens.shape
    dev = tokens.device

    with span("eval.prefill"):
        vf = model.fuse(batch.get("video"), batch.get("audio"))
        h, ck, cv = model.prefill(tokens[:, 0], vf, batch["vqa_video_start"],
                                  batch["vqa_splice"], s)
        # the shared last prompt position predicts each option's first token
        h_last = torch.gather(h, 1, (prefix - 1)[:, None, None].expand(
            b, 1, h.shape[-1]))
        first_logits = model.lm_logits(h_last)[:, 0]             # (B, V)

    with span("eval.extend"):
        j = torch.arange(span_len, device=dev)
        pos = prefix[:, None, None] + j[None, None]               # (B,1,L)
        tok_idx = pos.clamp(0, s - 1).expand(b, n_opt, span_len)
        span_tokens = torch.gather(tokens, 2, tok_idx)
        span_tokens = torch.where(pos < s, span_tokens,
                                  torch.zeros_like(span_tokens))

        chunk_logits = model.extend_logits(
            span_tokens, ck, cv, prefix, batch["vqa_video_start"])  # (B,n,L,V)

        first_tgt = torch.gather(labels, 2, prefix[:, None, None].expand(
            b, n_opt, 1))[..., 0]                                 # (B, n)
        tgt_pos = pos + 1
        span_tgts = torch.gather(labels, 2,
                                 tgt_pos.clamp(0, s - 1).expand(b, n_opt,
                                                                span_len))
        span_tgts = torch.where(tgt_pos < s, span_tgts,
                                torch.zeros_like(span_tgts))

        l_first = token_ce_unreduced(
            first_logits[:, None].expand(b, n_opt, first_logits.shape[-1]),
            first_tgt)                                            # (B, n)
        l_chunk = token_ce_unreduced(chunk_logits, span_tgts)    # (B, n, L)
        total = l_first + l_chunk.sum(-1)
        count = (l_first != 0).long() + (l_chunk != 0).sum(-1)
        return total / count.clamp_min(1)
