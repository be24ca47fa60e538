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

The quantization flags are those of `core.config.model_quant_kwargs` (int8
weight-only, w8a8 through K3, grouped/outlier w8a8 through K7 and K4,
packed int4/w4a8 through K8 and K9, w8a8d through K3 and K10, and the
rotated modes' `qav_rot`; see `Linear` and `FlippedVQAModel`).

Only the last `adapter_layer` blocks exist and run, as in the reference
(`layers[-adapter_layer:]`, JAX: llama.py:610-619); `layers` is a ModuleDict
keyed by the absolute layer index, so names stay `layers.N.*`.

`audio_merge` (None, 'audio_only', 'sum', 'concat', 'attention') picks the
audio fusion of `fuse` and its trainables (JAX: llama.py:426-444, 545-587):
`audio_proj`, `visual_proj` on the joint features, and the attention
merge's `video_audio_cross_attn` (query, key, value with biases). The
fusion is a few small products in plain torch, as JAX leaves it to XLA.

Every parameter is created with requires_grad=False; `train.optim.
trainable_parameters` turns it on for the trainables, so a backward takes
only dx through the frozen backbone. `remat=True` recomputes each block in
the backward (`torch.utils.checkpoint`, llama.py:637-660); with
`remat_group` > 1 one checkpoint covers that many consecutive blocks, so
only the group boundaries' h is saved (llama.py:461-468, 641-675).
`remat_policy` is JAX's (llama.py:451-456, 634-639):

- 'full': a unit saves only its input h; its backward recomputes every
  block of it, attention forward included (K1 twice per block per update:
  64 at 7B; K5 above MAX_SEQ_BWD).
- 'qkv': a unit also keeps each block's attention forward outputs, the
  text segment's output and its row lse (`kernels.flash_attention.
  keep_attention`), which are what K2 (or K6a/K6b) reads; the recompute
  takes them back and launches no attention forward (K1 once per block
  per update: 32 at 7B). It still recomputes the norms, the q/k/v, wo and
  FFN products, rope and the adapter rows' k/v. JAX saves the rope'd q,
  k, v and the attention output instead (`checkpoint_name`, :234-236,
  273) and lets XLA drop the q/k/v products from the recompute; its
  backward kernel recomputes the lse from q and k. The port saves one
  (B, S, dim) tensor and a (B, H, S) f32 lse a block where JAX saves
  four (B, S, dim) tensors. Under --no_flash the einsum attention is
  recomputed as under 'full'.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import ModelConfig
from .attention import (adapter_gated_attention, chunk_extend_attention,
                        decode_attention)
from .int4 import int4_matmul, int4_matmul_grouped
from .int8 import (int8_matmul, int8_matmul_dgrad, int8_matmul_grouped,
                   outlier_count)
from .kernels.flash_attention import flash_adapter_attention, keep_attention
from .kernels.quant_matmul import dequant
from .layers import apply_rope, apply_rope_at, precompute_rope, rms_norm


def _empty(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Linear(nn.Module):
    """Bias-free linear computed in `dtype` (JAX: llama.py:52-165).

    Unquantized: `weight` (out, in). Quantized (int8 frozen weights, leaves
    in ckpt/quantize.py's layout): `kernel_q` (out, in) int8 and `scale`,
    grouped (in/quant_group, out) when quant_group > 0 divides `in`, else
    per-channel (out,) — the grouped modes fall back there (llama.py:138).
    quant_outliers adds `out_idx` (n_out,) int32 and `out_w` (n_out, out):
    x[..., out_idx] @ out_w is added exactly, from the unmasked x, and under
    act_quant those columns of x are zeroed before the quantized product.

    act_quant (w8a8*) runs `int8_matmul` (K3; with dgrad_quant
    `int8_matmul_dgrad`, K3 and K10) or `int8_matmul_grouped` (K7 forward,
    K4 backward); without it (int8*, and the LM head in every mode)
    x @ dequant(W) in `dtype`, W = dtype(kq)·dtype(scale).

    weight_bits=4 (int4*, w4a8*) holds `kernel_q4` (out/2, in) packed int4
    (model/int4.py) and grouped `scale` (in/group, out), one group when
    `group` (quant_group, else 128) does not divide `in` (llama.py:104-110),
    and runs `int4_matmul` (weight-only) or `int4_matmul_grouped` (w4a8):
    K8 forward, K9 backward."""

    def __init__(self, in_features: int, out_features: int, dtype,
                 param_dtype, device=None, quantized: bool = False,
                 act_quant: bool = False, quant_group: int = 0,
                 quant_outliers: bool = False, weight_bits: int = 8,
                 dgrad_quant: bool = False):
        super().__init__()
        self.dtype = dtype
        self.quantized = quantized
        self.act_quant = act_quant
        self.quant_outliers = quant_outliers
        self.weight_bits = weight_bits
        self.dgrad_quant = dgrad_quant
        if not quantized:
            self.weight = _empty((out_features, in_features), param_dtype,
                                 device)
            return
        if weight_bits == 4:
            if quant_outliers:
                raise ValueError("int4 + outlier passthrough is unsupported "
                                 "(use --quantize int4r|w4a8r)")
            group = quant_group or 128
            self.kernel_q4 = _empty((out_features // 2, in_features),
                                    torch.int8, device)
            self.scale = _empty((in_features // group
                                 if in_features % group == 0 else 1,
                                 out_features), torch.float32, device)
            return
        self.grouped = quant_group > 0 and in_features % quant_group == 0
        self.kernel_q = _empty((out_features, in_features), torch.int8,
                               device)
        self.scale = _empty((in_features // quant_group, out_features)
                            if self.grouped else (out_features,),
                            torch.float32, device)
        if quant_outliers:
            n_out = outlier_count(in_features)
            self.out_idx = _empty((n_out,), torch.int32, device)
            self.out_w = _empty((n_out, out_features), param_dtype, device)

    def forward(self, x):
        if not self.quantized:
            return F.linear(x, self.weight.to(self.dtype))
        if self.weight_bits == 4:
            mm = int4_matmul_grouped if self.act_quant else int4_matmul
            return mm(x, self.kernel_q4, self.scale)
        passthrough = None
        if self.quant_outliers:
            idx = self.out_idx.long()
            passthrough = (x.index_select(-1, idx).to(self.dtype)
                           @ self.out_w.to(self.dtype))
            if self.act_quant:
                mask = torch.ones(x.shape[-1], dtype=x.dtype,
                                  device=x.device)
                x = x * mask.index_fill(0, idx, 0)
        if self.act_quant:
            if self.grouped:
                mm = int8_matmul_grouped
            else:
                mm = int8_matmul_dgrad if self.dgrad_quant else int8_matmul
            out = mm(x, self.kernel_q, self.scale)
        else:
            out = F.linear(x, dequant(self.kernel_q, self.scale, self.dtype))
        return out if passthrough is None else out + passthrough


class Dense(nn.Module):
    """Linear with bias in f32, named as nn.Linear (`weight` (out, in),
    `bias`): Flax's `nn.Dense` at dtype f32 (JAX: llama.py:435-437)."""

    def __init__(self, in_features: int, out_features: int, param_dtype,
                 device=None):
        super().__init__()
        self.weight = _empty((out_features, in_features), param_dtype, device)
        self.bias = _empty((out_features,), param_dtype, device)

    def forward(self, x):
        return F.linear(x.float(), self.weight.float(), self.bias.float())


class CrossAttentionModule(nn.Module):
    """Video queries over audio keys and values, one head, in f32, for the
    'attention' merge (JAX: llama.py:426-444; reference: model.py:145-169):
    softmax(q kᵀ / √feature_dim) v over the audio axis."""

    def __init__(self, feature_dim: int, param_dtype, device=None):
        super().__init__()
        self.feature_dim = feature_dim
        self.query = Dense(feature_dim, feature_dim, param_dtype, device)
        self.key = Dense(feature_dim, feature_dim, param_dtype, device)
        self.value = Dense(feature_dim, feature_dim, param_dtype, device)

    def forward(self, video, audio):
        q, k, v = self.query(video), self.key(audio), self.value(audio)
        # by an f32 tensor, as JAX divides: CUDA may turn a division by a
        # Python scalar into a product with its reciprocal
        scores = (torch.einsum("bfd,bad->bfa", q, k)
                  / torch.sqrt(torch.tensor(float(self.feature_dim))))
        return torch.einsum("bfa,bad->bfd", torch.softmax(scores, dim=-1), v)


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
    `prefill` send segment B through K1 (and its backward through K2), or,
    with use_flash False (--no_flash), through the einsum
    `adapter_gated_attention` (JAX: llama.py:262-263); `extend` and
    `decode` run the plain chunk and single-token attention."""

    def __init__(self, cfg: ModelConfig, dtype, frozen_dtype, trainable_dtype,
                 device=None, quant=None, use_flash: bool = True):
        super().__init__()
        self.cfg = cfg
        self.use_flash = use_flash
        mk = lambda: Linear(cfg.dim, cfg.dim, dtype, frozen_dtype, device,
                            **(quant or {}))
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
        attend = (flash_adapter_attention if self.use_flash
                  else adapter_gated_attention)
        out = attend(q, k, v, ak, av, self.gate1, self.gate2, video_start,
                     self.cfg.max_feats)
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

    def decode(self, x, rope_cos, rope_sin, adapter, video_start, cache_k,
               cache_v, pos):
        """One token a row (JAX: llama.py:306-327): x (B, 1, D) at the
        absolute positions pos (B,). The new K/V go into cache_k/v (B, Smax,
        H, Dh) at pos in place: JAX's functional `.at[].set` would copy the
        whole cache every token."""
        b = x.shape[0]
        h, dh = self.cfg.n_heads, self.cfg.head_dim
        q = self.wq(x).view(b, 1, h, dh)
        k = self.wk(x).view(b, 1, h, dh)
        v = self.wv(x).view(b, 1, h, dh)
        pos = pos.long()
        cos, sin = rope_cos[pos][:, None], rope_sin[pos][:, None]
        q = apply_rope_at(q, cos, sin)
        k = apply_rope_at(k, cos, sin)
        rows = torch.arange(b, device=x.device)
        cache_k[rows, pos] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, pos] = v[:, 0].to(cache_v.dtype)
        ak, av = self._adapter_kv(adapter)
        out = decode_attention(q, cache_k, cache_v, ak, av, self.gate1,
                               self.gate2, video_start, pos,
                               self.cfg.max_feats)
        return self.wo(out)


class FeedForward(nn.Module):
    """SwiGLU FFN (JAX: llama.py:330-359)."""

    def __init__(self, cfg: ModelConfig, dtype, frozen_dtype, device=None,
                 quant=None):
        super().__init__()
        hid = cfg.ffn_hidden
        q = quant or {}
        self.w1 = Linear(cfg.dim, hid, dtype, frozen_dtype, device, **q)
        self.w2 = Linear(hid, cfg.dim, dtype, frozen_dtype, device, **q)
        self.w3 = Linear(cfg.dim, hid, dtype, frozen_dtype, device, **q)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class TransformerBlock(nn.Module):
    """Pre-norm residual block (JAX: llama.py:362-423)."""

    def __init__(self, cfg: ModelConfig, dtype, frozen_dtype, trainable_dtype,
                 device=None, quant=None, use_flash: bool = True):
        super().__init__()
        self.attention = Attention(cfg, dtype, frozen_dtype, trainable_dtype,
                                   device, quant, use_flash)
        self.feed_forward = FeedForward(cfg, dtype, frozen_dtype, device,
                                        quant)
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

    def decode(self, x, rope_cos, rope_sin, adapter, video_start, cache_k,
               cache_v, pos):
        h = x + self.attention.decode(self.attention_norm(x), rope_cos,
                                      rope_sin, adapter, video_start,
                                      cache_k, cache_v, pos)
        return h + self.feed_forward(self.ffn_norm(h))

    def extend(self, x, rope_cos, rope_sin, adapter, video_start, cache_k,
               cache_v, prefix, n_opt: int):
        h = x + self.attention.extend(self.attention_norm(x), rope_cos,
                                      rope_sin, adapter, video_start,
                                      cache_k, cache_v, prefix, n_opt)
        return h + self.feed_forward(self.ffn_norm(h))


AUDIO_MERGES = (None, "audio_only", "sum", "concat", "attention")


class FlippedVQAModel(nn.Module):
    """The adapter-gated LLaMA with its audio merges (JAX: llama.py:
    447-769)."""

    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16,
                 frozen_dtype=torch.bfloat16, trainable_dtype=torch.float32,
                 device=None, remat: bool = False, remat_group: int = 1,
                 remat_policy: str = "full", quantized: bool = False,
                 act_quant: bool = False, quant_group: int = 0,
                 quant_outliers: bool = False, weight_bits: int = 8,
                 rotated: bool = False, dgrad_quant: bool = False,
                 use_flash: bool = True):
        super().__init__()
        if cfg.audio_merge not in AUDIO_MERGES:
            raise ValueError(f"unknown audio_merge {cfg.audio_merge!r}")
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.remat_group = remat_group
        self.remat_policy = remat_policy
        quant = dict(quantized=quantized, act_quant=act_quant,
                     quant_group=quant_group, quant_outliers=quant_outliers,
                     weight_bits=weight_bits, dgrad_quant=dgrad_quant)
        self.tok_embeddings = Embedding(cfg.vocab_size, cfg.dim, frozen_dtype,
                                        device)
        first = cfg.n_layers - cfg.adapter_layer
        self.layers = nn.ModuleDict({
            str(i): TransformerBlock(cfg, dtype, frozen_dtype,
                                     trainable_dtype, device, quant,
                                     use_flash)
            for i in range(first, cfg.n_layers)})
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps, frozen_dtype, device)
        # the LM head is int8 weight-only in every mode: its logits feed the
        # eval argmin directly (JAX: llama.py:523-528); under the int4 modes
        # grouped 128, as quant_group says
        self.output = Linear(cfg.dim, cfg.vocab_size, dtype, frozen_dtype,
                             device, **{**quant, "act_quant": False,
                                        "weight_bits": 8,
                                        "dgrad_quant": False})
        # the rotated modes: the frozen f32 Rᵀdiag(γ)R that restores the
        # final norm's γ inside the QAV head, the identity until a rotated
        # checkpoint is loaded (JAX: llama.py:529-535)
        self.rotated = rotated
        if rotated:
            self.qav_rot = _empty((cfg.dim, cfg.dim), torch.float32, device)
        self.adapter_query = Embedding(cfg.adapter_len * cfg.adapter_layer,
                                       cfg.dim, trainable_dtype, device)
        self.temporal_emb = Embedding(cfg.max_feats, cfg.dim, trainable_dtype,
                                      device)
        # the merge's projections (JAX: llama.py:545-563)
        merge = cfg.audio_merge
        proj = lambda n_in: Linear(n_in, cfg.dim, dtype, trainable_dtype,
                                   device)
        if merge in ("audio_only", "sum"):
            self.audio_proj = proj(cfg.audio_dim)
        if merge == "attention":
            self.audio_proj = Linear(cfg.audio_dim, cfg.visual_dim, dtype,
                                     trainable_dtype, device)
            self.video_audio_cross_attn = CrossAttentionModule(
                cfg.visual_dim, trainable_dtype, device)
        if merge != "audio_only":
            self.visual_proj = proj(cfg.visual_dim + cfg.audio_dim
                                    if merge == "concat" else cfg.visual_dim)

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

    def fuse(self, video: Optional[torch.Tensor],
             audio: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Project video and audio features into model space → (B, F, dim)
        (JAX: llama.py:567-587): the projections in the compute dtype, the
        attention merge's cross-attention in f32. `video` is None under
        'audio_only' (the batch has no video), `audio` None without a
        merge."""
        merge = self.cfg.audio_merge
        if merge == "audio_only":
            return self.audio_proj(audio.to(self.dtype))
        if merge == "concat":
            return self.visual_proj(
                torch.cat([video, audio], dim=-1).to(self.dtype))
        if merge == "sum":
            return (self.audio_proj(audio.to(self.dtype))
                    + self.visual_proj(video.to(self.dtype)))
        if merge == "attention":
            a = self.audio_proj(audio.to(self.dtype))
            fused = self.video_audio_cross_attn(video, a)
            return self.visual_proj(fused.to(self.dtype))
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
        # the remat unit: under 'qkv' it keeps its attention outputs
        unit = keep_attention if self.remat_policy == "qkv" else (lambda f: f)
        if remat and self.remat_group > 1:
            # one checkpoint over `remat_group` blocks: only group-boundary
            # h is saved; each block still recomputes exactly once
            n = len(self.layers)
            for start in range(0, n, self.remat_group):
                h = checkpoint(unit(self._run_block_range), h, rope_cos,
                               rope_sin, video_start, start,
                               min(start + self.remat_group, n),
                               use_reentrant=False)
            return self.norm(h)
        for block, adapter in self._active_blocks():
            if remat:
                h = checkpoint(unit(block), h, rope_cos, rope_sin, adapter,
                               video_start, use_reentrant=False)
            else:
                h = block(h, rope_cos, rope_sin, adapter, video_start)
        return self.norm(h)

    def _run_block_range(self, h, rope_cos, rope_sin, video_start,
                         start: int, stop: int):
        """Active blocks [start, stop): the remat_group checkpoint unit
        (JAX: llama.py:664-672)."""
        for block, adapter in self._active_blocks()[start:stop]:
            h = block(h, rope_cos, rope_sin, adapter, video_start)
        return h

    def lm_logits(self, h):
        return self.output(h)

    def qav_logits(self, h, video_feature):
        """h · video_featureᵀ / tau over the F frames, f32; the rotated
        modes take vf @ qav_rot (JAX: llama.py:684-696)."""
        vf = video_feature.float()
        if self.rotated:
            vf = vf @ self.qav_rot.float()
        return (torch.einsum("bsd,bfd->bsf", h[:, :-1].float(), vf)
                / self.cfg.tau)

    def prefill(self, tokens, video_feature, video_start, splice_index,
                cache_len: int):
        """Run the prompt once, filling a KV cache of length cache_len →
        (h_normed (B,S,D), cache_k (L,B,cache_len,H,Dh), cache_v), zero
        past S (JAX: llama.py:699-716). Each layer's K/V is written into
        the one cache tensor, never held twice."""
        b, s = tokens.shape
        cfg = self.cfg
        h = self._embed_and_splice(tokens, video_feature, splice_index)
        rope_cos, rope_sin = self._rope(cache_len)
        shape = (len(self.layers), b, cache_len, cfg.n_heads, cfg.head_dim)
        cache_k = torch.zeros(shape, dtype=self.dtype, device=tokens.device)
        cache_v = torch.zeros_like(cache_k)
        for i, (block, adapter) in enumerate(self._active_blocks()):
            h, k, v = block.prefill(h, rope_cos, rope_sin, adapter,
                                    video_start)
            cache_k[i, :, :s] = k
            cache_v[i, :, :s] = v
        return self.norm(h), cache_k, cache_v

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

    def decode_step(self, token, cache_k, cache_v, pos, video_start):
        """One greedy-decode step (JAX: llama.py:742-763): token (B,) is the
        token AT positions pos (B,) → logits (B, V) predicting pos + 1. Each
        layer writes its K/V into cache_k/v (L, B, cache_len, H, Dh) in
        place; the same tensors are returned."""
        h = self.tok_embeddings(token[:, None]).to(self.dtype)
        rope_cos, rope_sin = self._rope(cache_k.shape[2])
        for i, (block, adapter) in enumerate(self._active_blocks()):
            h = block.decode(h, rope_cos, rope_sin, adapter, video_start,
                             cache_k[i], cache_v[i], pos)
        return self.output(self.norm(h))[:, 0], cache_k, cache_v

    def forward(self, tokens, video, audio, video_start, splice_index):
        """fuse → encode → (lm logits, qav logits) (JAX: llama.py:765-769)."""
        vf = self.fuse(video, audio)
        h = self.encode(tokens, vf, video_start, splice_index)
        return self.lm_logits(h), self.qav_logits(h, vf)
