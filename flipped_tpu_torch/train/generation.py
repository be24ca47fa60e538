"""Generation eval: KV-cached greedy decode and option-embedding matching
(JAX: flipped_tpu/train/generation.py).

One batched prefill fills the KV cache, then `max_new_tokens - 1`
single-token decode steps (JAX's `lax.scan`, here a Python loop) give the
same greedy tokens as the reference's full re-forward per position. The
generated answer, cut to the option-0 answer-span length and at eos, is
mean-pooled over token embeddings and matched to each option's pooled
answer span by cosine similarity; the prediction is the first maximum.
MUSIC-AVQA's string-prefix match runs on the host, on the decoded strings
(`decode_generated`, cli/evaluate.py).
"""
from __future__ import annotations

from typing import Dict

import torch

MAX_NEW_TOKENS = 31  # positions prefix … prefix+30 (reference: model.py:439)


def _masked_mean(emb: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Mean over the kept positions; a zero vector where none is kept
    (JAX: generation.py:31-37)."""
    keep = keep.to(emb.dtype)[..., None]
    total = (emb * keep).sum(-2)
    count = torch.clamp_min(keep.sum(-2), 1.0)
    return total / count


def _embed(model, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings in the compute dtype, then f32, as JAX's
    `tok_embeddings` (dtype = the compute dtype) and its astype(f32)."""
    return model.tok_embeddings(tokens).to(model.dtype).float()


def pool_option_embeddings(model, all_tokens: torch.Tensor,
                           prefix: torch.Tensor, eos_id: int) -> torch.Tensor:
    """Each option's answer-span embedding as the reference pools it (JAX:
    generation.py:40-65): the span runs from `prefix` to the option's eos
    (exclusive; to the end without one), every item's options are padded
    to its longest span with token id 0, and the mean divides by that
    padded length. all_tokens (B, n_opt, S), prefix (B,) → (B, n_opt, D)
    f32."""
    s = all_tokens.shape[-1]
    cols = torch.arange(s, device=all_tokens.device)[None, None]
    opt_span = cols >= prefix.long()[:, None, None]
    opt_eos = torch.cumsum(((all_tokens == eos_id) & opt_span).int(),
                           dim=2) > 0
    keep_f = (opt_span & ~opt_eos).float()
    sums = torch.einsum("bns,bnsd->bnd", keep_f, _embed(model, all_tokens))
    lens = keep_f.sum(-1)                                   # (B, n)
    lmax = lens.amax(1, keepdim=True)                       # (B, 1)
    emb0 = _embed(model, torch.zeros(1, dtype=torch.long,
                                     device=all_tokens.device))[0]
    return ((sums + (lmax - lens)[..., None] * emb0[None, None])
            / torch.clamp_min(lmax, 1.0)[..., None])


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1,
                                                        keepdim=True), 1e-12)


def make_generation_step(model, eos_id: int,
                         max_new_tokens: int = MAX_NEW_TOKENS):
    """Returns gen_step(batch) → {'generated' (B, T) int, 'similarity'
    (B, n_opt) f32, 'prediction' (B,)} (JAX: generation.py:68-137).

    batch: the packed eval batch as tensors (data/batching.py) with
    'prefix' (B,), the answer-span start of option 0. The first token comes
    from the prefill's h at prefix - 1, decode step i reads position
    prefix + i; the cache holds S + max_new_tokens + 1 positions."""

    @torch.inference_mode()
    def gen_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        all_tokens = batch["vqa_tokens"]                 # (B, n_opt, S)
        prefix = batch["prefix"].long()                  # (B,)
        video_start = batch["vqa_video_start"]
        tokens = all_tokens[:, 0]                        # option 0 (model.py:385)
        b, s = tokens.shape
        vf = model.fuse(batch.get("video"), batch.get("audio"))
        h, cache_k, cache_v = model.prefill(tokens, vf, video_start,
                                            batch["vqa_splice"],
                                            s + max_new_tokens + 1)
        rows = torch.arange(b, device=tokens.device)
        h_last = h[rows, prefix - 1][:, None]            # (B, 1, D)
        tok = model.lm_logits(h_last)[:, 0].argmax(-1)
        generated = [tok]
        for i in range(max_new_tokens - 1):
            logits, cache_k, cache_v = model.decode_step(
                tok, cache_k, cache_v, prefix + i, video_start)
            tok = logits.argmax(-1)
            generated.append(tok)
        generated = torch.stack(generated, dim=1)        # (B, T)

        # the generated answer's embedding (reference: model.py:476-505)
        span_len = (batch["vqa_labels"][:, 0, 1:] != 0).sum(-1)   # (B,)
        idx = torch.arange(max_new_tokens, device=tokens.device)[None]
        after_eos = torch.cumsum((generated == eos_id).int(), dim=1) > 0
        keep = (idx < span_len[:, None]) & ~after_eos
        gen_emb = _masked_mean(_embed(model, generated), keep)    # (B, D)
        # each option's answer-span embedding (model.py:552-576)
        opt_emb = pool_option_embeddings(model, all_tokens, prefix, eos_id)
        # cosine similarity → the first best option (model.py:596-623)
        similarity = torch.einsum("bnd,bd->bn", _unit(opt_emb),
                                  _unit(gen_emb))
        return {"generated": generated, "similarity": similarity,
                "prediction": similarity.argmax(-1)}

    return gen_step


def decode_generated(tokenizer, generated_row, eos_id: int) -> str:
    """One generated row decoded, cut at eos or pad (JAX: generation.py:
    140-148; reference: model.py:527-538)."""
    toks = []
    for t in [int(x) for x in generated_row]:
        if t == eos_id or t == 0:
            break
        toks.append(t)
    return tokenizer.decode(toks)
