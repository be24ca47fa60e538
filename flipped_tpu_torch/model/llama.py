"""The adapter-gated LLaMA as nn.Modules (JAX: flipped_tpu/model/llama.py).

Parameter names are the reference state_dict names (`tok_embeddings.weight`,
`layers.N.attention.wq.weight` stored (out, in), `layers.N.attention.gate1`,
`adapter_query.weight`, ...), so `ckpt.convert.params_from_flax` is a rename
plus a transpose and `load_state_dict` takes its output.

Dtypes follow the JAX model: `dtype` is the compute dtype (bf16 on the card),
frozen weights are stored in `frozen_dtype` and trainables in
`trainable_dtype` (f32); each Linear casts its weight to the compute dtype.
Parameters are allocated uninitialised on `device`; `train.builder.
init_params` fills them.

Only the last `adapter_layer` blocks exist and run, as in the reference
(`layers[-adapter_layer:]`, JAX: llama.py:610-619); `layers` is a ModuleDict
keyed by the absolute layer index, so names stay `layers.N.*`.
Audio merges are not ported: `audio_merge` other than None raises.

Every parameter is created with requires_grad=False; `train.optim.
trainable_parameters` turns it on for the trainables, so a backward takes
only dx through the frozen backbone. `remat=True` recomputes each block in
the backward (`torch.utils.checkpoint`, the JAX "full" remat policy,
llama.py:637-660).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import ModelConfig
from .attention import chunk_extend_attention
from .kernels.flash_attention import flash_adapter_attention
from .layers import apply_rope, apply_rope_at, precompute_rope, rms_norm


def _empty(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Linear(nn.Module):
    """Bias-free linear, weight (out, in), computed in `dtype`. Unquantized
    only: the --quantize modes are not ported yet."""

    def __init__(self, in_features: int, out_features: int, dtype,
                 param_dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = _empty((out_features, in_features), param_dtype, device)

    def forward(self, x):
        return F.linear(x, self.weight.to(self.dtype))


class Embedding(nn.Module):
    """A lookup table named like nn.Embedding (`<name>.weight`)."""

    def __init__(self, num: int, dim: int, param_dtype, device=None):
        super().__init__()
        self.weight = _empty((num, dim), param_dtype, device)

    def forward(self, idx):
        return F.embedding(idx.long(), self.weight)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, param_dtype, device=None):
        super().__init__()
        self.eps = eps
        self.weight = _empty((dim,), param_dtype, device)

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class Attention(nn.Module):
    """Adapter-gated attention (JAX: llama.py:180-326). The dense forward and
    `prefill` send segment B through K1 (and its backward through K2);
    `extend` runs the plain chunk attention."""

    def __init__(self, cfg: ModelConfig, dtype, frozen_dtype, trainable_dtype,
                 device=None):
        super().__init__()
        self.cfg = cfg
        mk = lambda: Linear(cfg.dim, cfg.dim, dtype, frozen_dtype, device)
        self.wq, self.wk, self.wv, self.wo = mk(), mk(), mk(), mk()
        self.gate1 = _empty((cfg.n_heads,), trainable_dtype, device)
        self.gate2 = _empty((cfg.n_heads,), trainable_dtype, device)

    def _qkv(self, x, rope_cos, rope_sin):
        b, s, _ = x.shape
        h, dh = self.cfg.n_heads, self.cfg.head_dim
        q = self.wq(x).view(b, s, h, dh)
        k = self.wk(x).view(b, s, h, dh)
        v = self.wv(x).view(b, s, h, dh)
        cos, sin = rope_cos[:s], rope_sin[:s]
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def _adapter_kv(self, adapter):
        h, dh = self.cfg.n_heads, self.cfg.head_dim
        al = adapter.shape[0]
        a = adapter.to(self.wk.dtype)
        return (self.wk(a).view(al, h, dh), self.wv(a).view(al, h, dh))

    def _attend(self, x, rope_cos, rope_sin, adapter, video_start):
        q, k, v = self._qkv(x, rope_cos, rope_sin)
        ak, av = self._adapter_kv(adapter)
        out = flash_adapter_attention(q, k, v, ak, av, self.gate1, self.gate2,
                                      video_start, self.cfg.max_feats)
        return self.wo(out), k, v

    def forward(self, x, rope_cos, rope_sin, adapter, video_start):
        return self._attend(x, rope_cos, rope_sin, adapter, video_start)[0]

    def prefill(self, x, rope_cos, rope_sin, adapter, video_start):
        """Dense forward that also returns the rope'd K / V for the cache."""
        return self._attend(x, rope_cos, rope_sin, adapter, video_start)

    def extend(self, x, rope_cos, rope_sin, adapter, video_start, cache_k,
               cache_v, prefix, n_opt: int):
        """x (B, n_opt*L, D); chunk row j sits at position prefix + j % L."""
        b, nl, _ = x.shape
        h, dh = self.cfg.n_heads, self.cfg.head_dim
        chunk_len = nl // n_opt
        q = self.wq(x).view(b, nl, h, dh)
        k = self.wk(x).view(b, nl, h, dh)
        v = self.wv(x).view(b, nl, h, dh)
        pos = (prefix.long()[:, None]
               + (torch.arange(nl, device=x.device) % chunk_len)[None])
        cos, sin = rope_cos[pos], rope_sin[pos]
        q = apply_rope_at(q, cos, sin)
        k = apply_rope_at(k, cos, sin)
        ak, av = self._adapter_kv(adapter)
        out = chunk_extend_attention(q, k, v, cache_k, cache_v, ak, av,
                                     self.gate1, self.gate2, video_start,
                                     prefix, n_opt, self.cfg.max_feats)
        return self.wo(out)


class FeedForward(nn.Module):
    """SwiGLU FFN (JAX: llama.py:330-359)."""

    def __init__(self, cfg: ModelConfig, dtype, frozen_dtype, device=None):
        super().__init__()
        hid = cfg.ffn_hidden
        self.w1 = Linear(cfg.dim, hid, dtype, frozen_dtype, device)
        self.w2 = Linear(hid, cfg.dim, dtype, frozen_dtype, device)
        self.w3 = Linear(cfg.dim, hid, dtype, frozen_dtype, device)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class TransformerBlock(nn.Module):
    """Pre-norm residual block (JAX: llama.py:362-423)."""

    def __init__(self, cfg: ModelConfig, dtype, frozen_dtype, trainable_dtype,
                 device=None):
        super().__init__()
        self.attention = Attention(cfg, dtype, frozen_dtype, trainable_dtype,
                                   device)
        self.feed_forward = FeedForward(cfg, dtype, frozen_dtype, device)
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps, frozen_dtype,
                                      device)
        self.ffn_norm = RMSNorm(cfg.dim, cfg.norm_eps, frozen_dtype, device)

    def forward(self, x, rope_cos, rope_sin, adapter, video_start):
        h = x + self.attention(self.attention_norm(x), rope_cos, rope_sin,
                               adapter, video_start)
        return h + self.feed_forward(self.ffn_norm(h))

    def prefill(self, x, rope_cos, rope_sin, adapter, video_start):
        attn, k, v = self.attention.prefill(self.attention_norm(x), rope_cos,
                                            rope_sin, adapter, video_start)
        h = x + attn
        return h + self.feed_forward(self.ffn_norm(h)), k, v

    def extend(self, x, rope_cos, rope_sin, adapter, video_start, cache_k,
               cache_v, prefix, n_opt: int):
        h = x + self.attention.extend(self.attention_norm(x), rope_cos,
                                      rope_sin, adapter, video_start,
                                      cache_k, cache_v, prefix, n_opt)
        return h + self.feed_forward(self.ffn_norm(h))


class FlippedVQAModel(nn.Module):
    """The adapter-gated LLaMA, video-only merge (JAX: llama.py:447-769)."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16,
                 frozen_dtype=torch.bfloat16, trainable_dtype=torch.float32,
                 device=None, remat: bool = False):
        super().__init__()
        if cfg.audio_merge is not None:
            raise NotImplementedError(
                f"audio_merge={cfg.audio_merge!r}: audio merges are not "
                f"ported yet")
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.tok_embeddings = Embedding(cfg.vocab_size, cfg.dim, frozen_dtype,
                                        device)
        first = cfg.n_layers - cfg.adapter_layer
        self.layers = nn.ModuleDict({
            str(i): TransformerBlock(cfg, dtype, frozen_dtype,
                                     trainable_dtype, device)
            for i in range(first, cfg.n_layers)})
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps, frozen_dtype, device)
        self.output = Linear(cfg.dim, cfg.vocab_size, dtype, frozen_dtype,
                             device)
        self.adapter_query = Embedding(cfg.adapter_len * cfg.adapter_layer,
                                       cfg.dim, trainable_dtype, device)
        self.temporal_emb = Embedding(cfg.max_feats, cfg.dim, trainable_dtype,
                                      device)
        self.visual_proj = Linear(cfg.visual_dim, cfg.dim, dtype,
                                  trainable_dtype, device)

    @property
    def device(self):
        return self.norm.weight.device

    def _active_blocks(self):
        """(block, adapter rows) for the last adapter_layer blocks."""
        cfg = self.cfg
        adapters = self.adapter_query.weight.view(cfg.adapter_layer,
                                                  cfg.adapter_len, cfg.dim)
        return list(zip(self.layers.values(), adapters))

    def _rope(self, end: int):
        return precompute_rope(self.cfg.head_dim, end, self.cfg.rope_theta,
                               device=self.device)

    def fuse(self, video: torch.Tensor) -> torch.Tensor:
        """Project video features into model space → (B, F, dim); stored f32,
        computed in the compute dtype (JAX: llama.py:567-585)."""
        return self.visual_proj(video.to(self.dtype))

    def add_temporal(self, video_feature: torch.Tensor) -> torch.Tensor:
        temporal = self.temporal_emb.weight[None].to(self.dtype)
        return (video_feature.float() + temporal.float()).to(self.dtype)

    def _embed_and_splice(self, tokens, video_feature, splice_index):
        """Overwrite the splice positions with the video features through a
        one-hot product; indices ≥ S drop (JAX: llama.py:592-601)."""
        s = tokens.shape[1]
        h = self.tok_embeddings(tokens).to(self.dtype)
        vf = self.add_temporal(video_feature)
        onehot = (splice_index.long()[..., None]
                  == torch.arange(s, device=tokens.device)).to(self.dtype)
        is_video = onehot.sum(1)                                 # (B, S)
        return (h * (1.0 - is_video[..., None])
                + torch.einsum("bfs,bfd->bsd", onehot, vf))

    def encode(self, tokens, video_feature, video_start, splice_index):
        """Embed, splice video, run the active blocks + final norm →
        (B, S, dim) (JAX: llama.py:622-661)."""
        h = self._embed_and_splice(tokens, video_feature, splice_index)
        rope_cos, rope_sin = self._rope(tokens.shape[1])
        remat = self.remat and torch.is_grad_enabled()
        for block, adapter in self._active_blocks():
            if remat:
                h = checkpoint(block, h, rope_cos, rope_sin, adapter,
                               video_start, use_reentrant=False)
            else:
                h = block(h, rope_cos, rope_sin, adapter, video_start)
        return self.norm(h)

    def lm_logits(self, h):
        return self.output(h)

    def qav_logits(self, h, video_feature):
        """h · video_featureᵀ / tau over the F frames, f32."""
        return (torch.einsum("bsd,bfd->bsf", h[:, :-1].float(),
                             video_feature.float()) / self.cfg.tau)

    def prefill(self, tokens, video_feature, video_start, splice_index,
                cache_len: int):
        """Run the prompt once, filling a KV cache of length cache_len →
        (h_normed (B,S,D), cache_k (L,B,cache_len,H,Dh), cache_v)
        (JAX: llama.py:699-716)."""
        s = tokens.shape[1]
        h = self._embed_and_splice(tokens, video_feature, splice_index)
        rope_cos, rope_sin = self._rope(cache_len)
        pad = cache_len - s
        ck_all, cv_all = [], []
        for block, adapter in self._active_blocks():
            h, k, v = block.prefill(h, rope_cos, rope_sin, adapter,
                                    video_start)
            ck_all.append(F.pad(k, (0, 0, 0, 0, 0, pad)))
            cv_all.append(F.pad(v, (0, 0, 0, 0, 0, pad)))
        return self.norm(h), torch.stack(ck_all), torch.stack(cv_all)

    def extend_logits(self, tokens, cache_k, cache_v, prefix, video_start):
        """Score n_opt continuations against the shared prompt cache.
        tokens (B, n_opt, L) → logits (B, n_opt, L, V)
        (JAX: llama.py:718-740)."""
        b, n_opt, chunk_len = tokens.shape
        h = self.tok_embeddings(tokens.reshape(b, n_opt * chunk_len)).to(
            self.dtype)
        rope_cos, rope_sin = self._rope(cache_k.shape[2])
        for i, (block, adapter) in enumerate(self._active_blocks()):
            h = block.extend(h, rope_cos, rope_sin, adapter, video_start,
                             cache_k[i], cache_v[i], prefix, n_opt)
        logits = self.output(self.norm(h))
        return logits.view(b, n_opt, chunk_len, self.cfg.vocab_size)

    def forward(self, tokens, video, video_start, splice_index):
        """fuse → encode → (lm logits, qav logits)."""
        vf = self.fuse(video)
        h = self.encode(tokens, vf, video_start, splice_index)
        return self.lm_logits(h), self.qav_logits(h, vf)
