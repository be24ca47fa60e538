"""K1: causal text attention with the gate2 video-block bias, forward.

Replaces the TPU kernel `flash_text_attention` → `_flash_kernel`
(flipped_tpu/model/pallas/flash_attention.py:59-171). The CUDA source is
flipped_tpu_torch/csrc/flash_text_fwd.cu; its header note says what bounds
it on the card and how the design answers that.

`flash_text_attention(q, k, v, gate2, video_start, max_feats)` returns
`(out, lse)`: out (B, S, H, Dh) in q.dtype and the row log-sum-exp
(B, H, S) f32, which the backward (K2, a later port) reads.

- A CUDA tensor launches the kernel, or the wrapper raises. There is no
  fallback and no flag that routes CUDA to the plain version.
- A CPU tensor takes `flash_text_attention_ref`, the plain version.
- `flash_text_attention.launches` counts kernel launches; only the CUDA
  branch adds to it.

Forward only: the autograd.Function comes with the backward kernel (K2).
The adapter segment stays plain torch outside the kernel, as in JAX
(`flash_adapter_attention` below; JAX: flash_attention.py:749-755).
"""
from __future__ import annotations

import math

import torch

from ..attention import NEG_INF, adapter_prefix_attention

# head dims the kernel is instantiated for (csrc/flash_text_fwd.cu): every
# LLaMA preset the repo names (7B, 13B, 33B) has 128
KERNEL_HEAD_DIMS = (128,)


def flash_text_attention_ref(q, k, v, gate2, video_start, max_feats: int):
    """Plain PyTorch K1. It follows the input dtype: for bf16 inputs it
    does what the TPU kernel does (bf16 operands, f32 score and value
    products, P cast to bf16); for f32 inputs it stays f32 throughout, like
    `adapter_gated_attention`. Returns (out (B,S,H,Dh) q.dtype, lse (B,H,S) f32).
    """
    b, s, h, dh = q.shape
    cd = q.dtype
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
        * (1.0 / math.sqrt(dh))
    row = torch.arange(s, device=q.device)[:, None]
    col = torch.arange(s, device=q.device)[None, :]
    vs = video_start.long()[:, None, None, None]
    block = ((row >= vs + max_feats) & (col >= vs)
             & (col < vs + max_feats) & (vs >= 0))          # (B,1,S,S)
    scores = scores + torch.where(block, gate2.float()[None, :, None, None],
                                  torch.zeros((), device=q.device))
    scores = torch.where(col <= row, scores, torch.full_like(scores, NEG_INF))
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


def flash_adapter_attention(q, k, v, adapter_k, adapter_v, gate1, gate2,
                            video_start, max_feats: int) -> torch.Tensor:
    """Two-segment attention with segment B through K1 and the adapter
    segment in plain torch (JAX: flash_attention.py:749-755).
    Returns (B, S, H*Dh)."""
    b, s, h, dh = q.shape
    text, _ = flash_text_attention(q, k, v, gate2.float(),
                                   video_start.to(torch.int32), max_feats)
    out = text + adapter_prefix_attention(q, adapter_k, adapter_v, gate1)
    return out.reshape(b, s, h * dh)
