"""K1 and K2: causal text attention with the gate2 video-block bias,
forward and backward, and the autograd.Function around them.

- K1 `flash_text_attention` replaces the TPU kernel `flash_text_attention`
  → `_flash_kernel` (flipped_tpu/model/pallas/flash_attention.py:59-171);
  CUDA source csrc/flash_text_fwd.cu. It returns `(out, lse)`: out
  (B, S, H, Dh) in q.dtype and the row log-sum-exp (B, H, S) f32.
- K2 `flash_text_attention_bwd` replaces `flash_text_attention_bwd` →
  `_flash_bwd_kernel` (:174-300); CUDA source csrc/flash_text_bwd.cu. It
  returns `(dq, dk, dv, dgate2)` and reads K1's out and lse instead of
  recomputing the forward.
- `FlashAdapterAttention` is the custom VJP `_flash_adapter_attention`
  (:749-796): K1 forward, K2 backward for the text segment; the adapter
  segment stays plain torch under autograd, as in JAX (:789-790).

The header note of each CUDA source says what bounds it on the card and how
its design answers that. For both wrappers:

- A CUDA tensor launches the kernel, or the wrapper raises. There is no
  fallback and no flag that routes CUDA to the plain version.
- A CPU tensor takes the plain version (`flash_text_attention_ref`,
  `flash_text_attention_bwd_ref`).
- `<wrapper>.launches` counts kernel launches; only the CUDA branch adds
  to it.
"""
from __future__ import annotations

import math

import torch

from ..attention import NEG_INF, adapter_prefix_attention

# head dims the kernels are instantiated for (csrc/flash_text_*.cu): every
# LLaMA preset the repo names (7B, 13B, 33B) has 128
KERNEL_HEAD_DIMS = (128,)
# keys per dk/dv block of K2 (csrc/flash_text_bwd.cu BK_DKV): one dgate2
# partial per (b, h, key tile)
K2_KEY_TILE = 64


def _video_block(s: int, video_start, max_feats: int, device):
    """(B, 1, S, S) bool: text rows ≥ vs+F × video columns [vs, vs+F),
    off where video_start < 0 (JAX: flash_attention.py:84-85)."""
    row = torch.arange(s, device=device)[:, None]
    col = torch.arange(s, device=device)[None, :]
    vs = video_start.long()[:, None, None, None]
    return ((row >= vs + max_feats) & (col >= vs)
            & (col < vs + max_feats) & (vs >= 0))


def _masked_scores(q, k, gate2, video_start, max_feats: int):
    """f32 scores q·kᵀ/√dh + gate2·block, causal positions set to -1e30
    (B, H, S, S), from operands in q.dtype, as both TPU kernels take them."""
    s, dh = q.shape[1], q.shape[3]
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
        * (1.0 / math.sqrt(dh))
    block = _video_block(s, video_start, max_feats, q.device)
    scores = scores + torch.where(block, gate2.float()[None, :, None, None],
                                  torch.zeros((), device=q.device))
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    return torch.where(causal, scores, torch.full_like(scores, NEG_INF))


def flash_text_attention_ref(q, k, v, gate2, video_start, max_feats: int):
    """Plain PyTorch K1. It follows the input dtype: for bf16 inputs it
    does what the TPU kernel does (bf16 operands, f32 score and value
    products, P cast to bf16); for f32 inputs it stays f32 throughout, like
    `adapter_gated_attention`. Returns (out (B,S,H,Dh) q.dtype, lse (B,H,S) f32).
    """
    cd = q.dtype
    scores = _masked_scores(q, k, gate2, video_start, max_feats)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs.to(cd).float(), v.float())
    return out.to(cd), lse


def _check_cuda_inputs(q, k, v, gate2, video_start):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, S, H, Dh) shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, s, h, dh = q.shape
    for name, t in (("q", q), ("k", k), ("v", v), ("gate2", gate2),
                    ("video_start", video_start)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_text_fwd takes bf16 {name}, got {t.dtype}")
        if t.stride() != q.stride() or t.stride(-1) != 1:
            raise ValueError(f"q, k, v need one layout with a unit Dh stride, "
                             f"got {name} strides {t.stride()} vs "
                             f"{q.stride()}")
        if any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be 16-byte aligned")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_text_fwd is built for head dims "
                         f"{KERNEL_HEAD_DIMS}, got {dh}")
    if gate2.shape != (h,) or gate2.dtype != torch.float32:
        raise ValueError(f"gate2 must be ({h},) f32, got {tuple(gate2.shape)} "
                         f"{gate2.dtype}")
    if not gate2.is_contiguous():
        raise ValueError("gate2 must be contiguous")
    if (video_start.shape != (b,) or video_start.dtype != torch.int32
            or not video_start.is_contiguous()):
        raise ValueError(f"video_start must be contiguous ({b},) int32, got "
                         f"{tuple(video_start.shape)} {video_start.dtype}")


def flash_text_attention(q, k, v, gate2, video_start, max_feats: int):
    """Causal text attention + gate2 video-block bias.

    q, k, v: (B, S, H, Dh); gate2: (H,) f32; video_start: (B,) int32
    (-1 → no bias). Returns (out (B,S,H,Dh), lse (B,H,S) f32).
    """
    if q.device.type == "cpu":
        return flash_text_attention_ref(q, k, v, gate2, video_start, max_feats)
    if q.device.type != "cuda":
        raise ValueError(f"flash_text_attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    _check_cuda_inputs(q, k, v, gate2, video_start)
    from .build import build

    lib = build()
    b, s, h, dh = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.lib.flash_text_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gate2.data_ptr(),
            video_start.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, s, h, dh, int(max_feats),
            *q.stride()[:3], *out.stride()[:3],
            1.0 / math.sqrt(dh), stream)
    if err != 0:
        raise RuntimeError(f"flash_text_fwd launch failed: "
                           f"{lib.error_string(err)} (cudaError {err})")
    flash_text_attention.launches += 1
    return out, lse


flash_text_attention.launches = 0


def flash_text_attention_bwd_ref(q, k, v, gate2, video_start, max_feats: int,
                                 do):
    """Plain PyTorch K2: what `_flash_bwd_kernel` computes (JAX
    flash_attention.py:186-231), recomputing P by softmax and O = P·V in f32
    as the TPU kernel does. It follows the input dtype: bf16 inputs round P
    and dS to bf16 before their products, as the TPU kernel does; f32 inputs
    stay f32. Returns (dq, dk, dv in q.dtype, dgate2 (H,) f32 summed over B).
    """
    cd = q.dtype
    dh = q.shape[3]
    scale = 1.0 / math.sqrt(dh)
    scores = _masked_scores(q, k, gate2, video_start, max_feats)
    p = torch.softmax(scores, dim=-1)                        # (B,H,S,S) f32
    p_c = p.to(cd).float()
    v32, do32 = v.float(), do.float()
    o = torch.einsum("bhst,bthd->bshd", p_c, v32)
    d = (o * do32).sum(-1).transpose(1, 2)[..., None]         # (B,H,S,1)
    dp = torch.einsum("bshd,bthd->bhst", do32, v32)
    causal = torch.ones_like(scores, dtype=torch.bool).tril()
    ds = torch.where(causal, p * (dp - d), torch.zeros((), device=q.device))
    ds_c = ds.to(cd).float()
    dq = torch.einsum("bhst,bthd->bshd", ds_c, k.float()) * scale
    dk = torch.einsum("bhst,bshd->bthd", ds_c, q.float()) * scale
    dv = torch.einsum("bhst,bshd->bthd", p_c, do32)
    block = _video_block(q.shape[1], video_start, max_feats, q.device)
    dgate2 = torch.where(block, ds, torch.zeros((), device=q.device)).sum(
        dim=(0, 2, 3))
    return dq.to(cd), dk.to(cd), dv.to(cd), dgate2


def flash_text_attention_bwd(q, k, v, gate2, video_start, max_feats: int, do,
                             out, lse):
    """Backward of the text segment: (dq, dk, dv (B,S,H,Dh), dgate2 (H,)).

    do is the gradient of K1's out; `out` and `lse` are K1's outputs, which
    the kernel reads (D = rowsum(dO∘O), P = exp(s − lse)) instead of
    recomputing the forward. The plain version recomputes both, as the TPU
    kernel does, and ignores them.
    """
    if q.device.type == "cpu":
        return flash_text_attention_bwd_ref(q, k, v, gate2, video_start,
                                            max_feats, do)
    if q.device.type != "cuda":
        raise ValueError(f"flash_text_attention_bwd runs on cuda or cpu "
                         f"tensors, got {q.device}")
    q, k, v, do, out = (t.contiguous() for t in (q, k, v, do, out))
    _check_cuda_inputs(q, k, v, gate2, video_start)
    b, s, h, dh = q.shape
    for name, t in (("do", do), ("out", out)):
        if t.shape != q.shape or t.dtype != torch.bfloat16 \
                or t.device != q.device:
            raise ValueError(f"{name} must be bf16 {tuple(q.shape)} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if (lse.shape != (b, h, s) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous f32 ({b}, {h}, {s}) on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)}")
    from .build import build

    lib = build()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    n_kt = -(-s // K2_KEY_TILE)
    dg2_part = torch.empty((b, h, n_kt), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.lib.flash_text_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), gate2.data_ptr(),
            video_start.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), dg2_part.data_ptr(),
            b, s, h, dh, int(max_feats), 1.0 / math.sqrt(dh), stream)
    if err != 0:
        raise RuntimeError(f"flash_text_bwd launch failed: "
                           f"{lib.error_string(err)} (cudaError {err})")
    flash_text_attention_bwd.launches += 1
    # per-(b, h, key tile) partials, summed here: no atomics in the kernel,
    # so dgate2 is the same from run to run (JAX sums over B outside, :300)
    return dq, dk, dv, dg2_part.sum(dim=(0, 2))


flash_text_attention_bwd.launches = 0


class FlashAdapterAttention(torch.autograd.Function):
    """Two-segment attention, segment B through K1 forward and K2 backward,
    the adapter segment in plain torch (JAX `_flash_adapter_attention`,
    flash_attention.py:749-796)."""

    @staticmethod
    def forward(ctx, q, k, v, adapter_k, adapter_v, gate1, gate2,
                video_start, max_feats):
        b, s, h, dh = q.shape
        g2 = gate2.float()
        vs = video_start.to(torch.int32)
        text, lse = flash_text_attention(q, k, v, g2, vs, max_feats)
        out = text + adapter_prefix_attention(q, adapter_k, adapter_v, gate1)
        ctx.save_for_backward(q, k, v, adapter_k, adapter_v, gate1, g2, vs,
                              text, lse)
        ctx.max_feats = max_feats
        ctx.gate2_dtype = gate2.dtype
        return out.reshape(b, s, h * dh)

    @staticmethod
    def backward(ctx, g):
        q, k, v, adapter_k, adapter_v, gate1, g2, vs, text, lse = \
            ctx.saved_tensors
        g4 = g.reshape(q.shape).to(q.dtype)
        dq_t, dk, dv, dg2 = flash_text_attention_bwd(
            q, k, v, g2, vs, ctx.max_feats, g4, text, lse)
        # adapter segment: exact tiny attention, differentiated by autograd
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in
                      (q, adapter_k, adapter_v, gate1)]
            seg = adapter_prefix_attention(*leaves)
        dq_a, dak, dav, dg1 = torch.autograd.grad(seg, leaves, g4)
        return (dq_t + dq_a, dk, dv, dak, dav, dg1,
                dg2.to(ctx.gate2_dtype), None, None)


def flash_adapter_attention(q, k, v, adapter_k, adapter_v, gate1, gate2,
                            video_start, max_feats: int) -> torch.Tensor:
    """Two-segment attention with segment B through K1 (forward) and K2
    (backward). Returns (B, S, H*Dh)."""
    return FlashAdapterAttention.apply(q, k, v, adapter_k, adapter_v, gate1,
                                       gate2, video_start, max_feats)
