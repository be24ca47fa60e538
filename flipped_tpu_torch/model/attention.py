"""Adapter-gated two-segment attention, plain torch
(JAX: flipped_tpu/model/attention.py).

    out = softmax(q·k_adapterᵀ) · tanh(gate1) @ v_adapter          (segment A)
        + softmax(q·k_textᵀ + causal + gate2·video_block) @ v_text  (segment B)

Every function reproduces its JAX twin's dtype steps: score products are
taken in f32 from operands of the compute dtype (the JAX
`preferred_element_type=f32`), the softmax is f32, and probabilities are
cast to the compute dtype before the value product. The score scale is
`1 / sqrt(dh)` rounded to the compute dtype, as the JAX code computes it.
Masked scores are -1e30, never -inf.

Segment B of the dense forward runs through the K1 kernel wrapper
(model/kernels/flash_attention.py); `adapter_gated_attention` here is its
all-plain formulation, kept as the oracle the CPU tests hold the port to.
The single-token `decode_attention` of generation is plain torch, as in
JAX (einsums there, no Pallas kernel).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _scale(dh: int, dtype: torch.dtype) -> torch.Tensor:
    # JAX: 1.0 / jnp.sqrt(jnp.asarray(dh, f32)).astype(q.dtype)
    return 1.0 / torch.sqrt(torch.tensor(float(dh))).to(dtype)


def video_block_bias(video_start: torch.Tensor, seq_len: int, max_feats: int,
                     gate2: torch.Tensor) -> torch.Tensor:
    """Additive bias (B, H, S, S): gate2 on the text-rows × video-cols block;
    video_start -1 → no bias (JAX: attention.py:30-43)."""
    dev = video_start.device
    rows = torch.arange(seq_len, device=dev)[:, None]
    cols = torch.arange(seq_len, device=dev)[None, :]
    vs = video_start.long()[:, None, None]
    block = ((rows >= vs + max_feats) & (cols >= vs)
             & (cols < vs + max_feats) & (vs >= 0))          # (B, S, S)
    return block[:, None].to(gate2.dtype) * gate2[None, :, None, None]


def adapter_prefix_attention(q: torch.Tensor, adapter_k: torch.Tensor,
                             adapter_v: torch.Tensor,
                             gate1: torch.Tensor) -> torch.Tensor:
    """Segment A: tiny attention over the un-roped adapter keys, softmaxed
    on its own and scaled by tanh(gate1) (JAX: attention.py:46-65).

    q: (B, Q, H, Dh); adapter_k/v: (L, H, Dh). Returns (B, Q, H, Dh), q.dtype.
    """
    cd = q.dtype
    scores = torch.einsum("bqhd,lhd->bhql", q.float(),
                          adapter_k.to(cd).float()) * _scale(q.shape[-1], cd)
    probs = (torch.softmax(scores.float(), dim=-1)
             * torch.tanh(gate1.float())[None, :, None, None])
    return torch.einsum("bhql,lhd->bqhd", probs.to(cd).float(),
                        adapter_v.to(cd).float()).to(cd)


def adapter_gated_attention(q, k, v, adapter_k, adapter_v, gate1, gate2,
                            video_start, max_feats: int) -> torch.Tensor:
    """Exact two-segment attention (JAX: attention.py:68-103).

    q, k, v: (B, S, H, Dh) with rope applied to q, k; adapter_k/v: (L, H, Dh);
    gate1, gate2: (H,); video_start: (B,) int, -1 → no gate2 block.
    Returns (B, S, H*Dh).
    """
    b, s, h, dh = q.shape
    cd = q.dtype
    scores = torch.einsum("bshd,bthd->bhst", q.float(),
                          k.float()) * _scale(dh, cd)
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = torch.where(causal[None, None], scores,
                         torch.full_like(scores, NEG_INF))
    scores = scores + video_block_bias(video_start, s, max_feats,
                                       gate2.float())
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs.to(cd).float(), v.float())
    out = out + adapter_prefix_attention(q, adapter_k, adapter_v,
                                         gate1).float()
    return out.to(cd).reshape(b, s, h * dh)


def chunk_extend_attention(q, k_chunk, v_chunk, cache_k, cache_v, adapter_k,
                           adapter_v, gate1, gate2, video_start, prefix,
                           n_opt: int, max_feats: int) -> torch.Tensor:
    """Prefix-shared option scoring (JAX: attention.py:106-159): n_opt
    chunks per example attend the shared prompt cache (columns < prefix,
    gate2 on the video columns for every chunk row) and themselves
    (option-local causal), under ONE softmax over the concatenated keys.

    q/k_chunk/v_chunk: (B, n_opt*L, H, Dh); cache_k/v: (B, Smax, H, Dh);
    prefix: (B,) int. Returns (B, n_opt*L, H*Dh).
    """
    b, nl, h, dh = q.shape
    cd = q.dtype
    chunk_len = nl // n_opt
    s_max = cache_k.shape[1]
    scale = _scale(dh, cd)
    dev = q.device

    cache_scores = torch.einsum("bqhd,bthd->bhqt", q.float(),
                                cache_k.float()) * scale
    cols = torch.arange(s_max, device=dev)[None, None, None, :]
    pfx = prefix.long()[:, None, None, None]
    vs = video_start.long()[:, None, None, None]
    block = (cols >= vs) & (cols < vs + max_feats) & (vs >= 0)
    cache_scores = cache_scores + block.float() * gate2.float()[None, :, None,
                                                                None]
    cache_scores = torch.where(cols < pfx, cache_scores,
                               torch.full_like(cache_scores, NEG_INF))

    intra_scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                k_chunk.float()) * scale
    qi = torch.arange(nl, device=dev)
    same_opt = (qi[:, None] // chunk_len) == (qi[None, :] // chunk_len)
    intra_mask = same_opt & (qi[None, :] <= qi[:, None])
    intra_scores = torch.where(intra_mask[None, None], intra_scores,
                               torch.full_like(intra_scores, NEG_INF))

    scores = torch.cat([cache_scores, intra_scores], dim=-1)
    probs = torch.softmax(scores, dim=-1).to(cd).float()
    out = (torch.einsum("bhqt,bthd->bqhd", probs[..., :s_max],
                        cache_v.float())
           + torch.einsum("bhqk,bkhd->bqhd", probs[..., s_max:],
                          v_chunk.float()))
    out = out + adapter_prefix_attention(q, adapter_k, adapter_v,
                                         gate1).float()
    return out.to(cd).reshape(b, nl, h * dh)


def decode_attention(q, cache_k, cache_v, adapter_k, adapter_v, gate1, gate2,
                     video_start, pos, max_feats: int) -> torch.Tensor:
    """One query token against a KV cache (JAX: attention.py:162-196).

    q: (B, 1, H, Dh), roped at `pos`; cache_k/v: (B, Smax, H, Dh), live at
    columns <= pos; video_start: (B,) int, -1 → no gate2 block; pos: (B,)
    int, the query's absolute position. Returns (B, 1, H*Dh).
    """
    b, _, h, dh = q.shape
    cd = q.dtype
    s_max = cache_k.shape[1]
    scores = torch.einsum("bohd,bthd->bhot", q.float(),
                          cache_k.float()) * _scale(dh, cd)
    cols = torch.arange(s_max, device=q.device)[None, None, None, :]
    p = pos.long()[:, None, None, None]
    vs = video_start.long()[:, None, None, None]
    # the gate2 video block: a decoded row sits past vs + max_feats, so this
    # is the whole block once the prompt holds video (JAX guards it too)
    block = ((p >= vs + max_feats) & (cols >= vs) & (cols < vs + max_feats)
             & (vs >= 0))
    scores = scores + block.float() * gate2.float()[None, :, None, None]
    scores = torch.where(cols <= p, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhot,bthd->bohd", probs.to(cd).float(),
                       cache_v.float())
    out = out + adapter_prefix_attention(q, adapter_k, adapter_v,
                                         gate1).float()
    return out.to(cd).reshape(b, 1, h * dh)
