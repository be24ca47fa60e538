"""Classification-eval objectives (JAX: flipped_tpu/train/objectives.py).

Scores reproduce the reference: per-token CE with ignore index 0, summed
per option and divided by the count of NONZERO token losses (not the label
mask), prediction = argmin. The training losses come with the training
slice.
"""
from __future__ import annotations

from typing import Dict

import torch


def ce_ignore_index(logits: torch.Tensor, labels: torch.Tensor,
                    ignore_index: int) -> torch.Tensor:
    """Mean CE over positions where labels != ignore_index
    (JAX: objectives.py:37-47)."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    tok_ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    losses = torch.where(valid, -tok_ll, torch.zeros_like(tok_ll))
    return losses.sum() / valid.sum().clamp_min(1)


def token_ce_unreduced(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Per-token CE, 0.0 where labels == 0 (JAX: objectives.py:50-57)."""
    logits = logits.float()
    valid = labels != 0
    logp = torch.log_softmax(logits, dim=-1)
    tok_ll = torch.gather(logp, -1, labels.long().clamp_min(0)[..., None])[..., 0]
    return torch.where(valid, -tok_ll, torch.zeros_like(tok_ll))


def option_scores(model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Dense scorer: every option's full sequence through the model →
    (B, n_options) mean token CE (JAX: objectives.py:178-204)."""
    tokens = batch["vqa_tokens"]          # (B, n_opt, S)
    labels = batch["vqa_labels"]
    b, n_opt, s = tokens.shape
    vf = model.fuse(batch["video"])
    vf_rep = vf.repeat_interleave(n_opt, dim=0)
    vstart = batch["vqa_video_start"].repeat_interleave(n_opt, dim=0)
    splice = batch["vqa_splice"].repeat_interleave(n_opt, dim=0)
    h = model.encode(tokens.reshape(b * n_opt, s), vf_rep, vstart, splice)
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

    vf = model.fuse(batch["video"])
    h, ck, cv = model.prefill(tokens[:, 0], vf, batch["vqa_video_start"],
                              batch["vqa_splice"], s)

    # the shared last prompt position predicts each option's first token
    h_last = torch.gather(h, 1, (prefix - 1)[:, None, None].expand(
        b, 1, h.shape[-1]))
    first_logits = model.lm_logits(h_last)[:, 0]                 # (B, V)

    j = torch.arange(span_len, device=dev)
    pos = prefix[:, None, None] + j[None, None]                   # (B,1,L)
    tok_idx = pos.clamp(0, s - 1).expand(b, n_opt, span_len)
    span_tokens = torch.gather(tokens, 2, tok_idx)
    span_tokens = torch.where(pos < s, span_tokens,
                              torch.zeros_like(span_tokens))

    chunk_logits = model.extend_logits(span_tokens, ck, cv, prefix,
                                       batch["vqa_video_start"])  # (B,n,L,V)

    first_tgt = torch.gather(labels, 2, prefix[:, None, None].expand(
        b, n_opt, 1))[..., 0]                                     # (B, n)
    tgt_pos = pos + 1
    span_tgts = torch.gather(labels, 2,
                             tgt_pos.clamp(0, s - 1).expand(b, n_opt,
                                                            span_len))
    span_tgts = torch.where(tgt_pos < s, span_tgts,
                            torch.zeros_like(span_tgts))

    l_first = token_ce_unreduced(
        first_logits[:, None].expand(b, n_opt, first_logits.shape[-1]),
        first_tgt)                                                # (B, n)
    l_chunk = token_ce_unreduced(chunk_logits, span_tgts)        # (B, n, L)
    total = l_first + l_chunk.sum(-1)
    count = (l_first != 0).long() + (l_chunk != 0).sum(-1)
    return total / count.clamp_min(1)
