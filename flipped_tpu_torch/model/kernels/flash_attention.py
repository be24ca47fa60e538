"""K1, K2, K5, K6a and K6b: causal text attention with the gate2 video-block
bias, forward and backward, in two regimes, and the autograd.Function
around them.

- K1 `flash_text_attention` replaces the TPU kernel `flash_text_attention`
  → `_flash_kernel` (flipped_tpu/model/pallas/flash_attention.py:59-171);
  CUDA source csrc/flash_text_fwd.cu. It returns `(out, lse)`: out
  (B, S, H, Dh) in q.dtype and the row log-sum-exp (B, H, S) f32. Above
  `MAX_SEQ_FWD` it hands the call to K5, as the JAX wrapper does (:121-126).
- K2 `flash_text_attention_bwd` replaces `flash_text_attention_bwd` →
  `_flash_bwd_kernel` (:174-300); CUDA source csrc/flash_text_bwd.cu. It
  returns `(dq, dk, dv, dgate2)` and reads K1's out and lse instead of
  recomputing the forward. Above `MAX_SEQ_BWD` it hands the call to K6
  (:241-245).
- K5 `flash_streaming_fwd` replaces `flash_streaming_fwd` →
  `_stream_fwd_kernel` (:314-441); CUDA source csrc/flash_stream_fwd.cu.
  q (B, S_q, H, Dh) is a shard whose row i sits at global position
  q_offset + i, against K/V (B, S_k, H, Dh). Returns `(out, lse)`, the lse
  (B, H, S_q) f32 (the TPU kernel's 8-lane padded lse is Mosaic layout and
  is not ported).
- K6a `flash_streaming_dq` and K6b `flash_streaming_dkv` replace the two
  passes of `flash_streaming_bwd` → `_stream_dq_kernel` (:484-533, :665)
  and `_stream_dkv_kernel` (:535-578, :719); CUDA source
  csrc/flash_stream_bwd.cu. They read the saved lse and the row statistic
  D = rowsum(dO∘O_text), which `flash_streaming_bwd` computes in plain
  torch, as JAX computes it in XLA (:608-613). K6a returns (dq, dgate2), K6b
  the full-length (dk, dv), partial sums over this shard's rows.
- `FlashAdapterAttention` is the custom VJP `_flash_adapter_attention`
  (:749-796): a differentiated call with S > `MAX_SEQ_BWD` runs K5 forward,
  saves (text, lse) and runs K6a + K6b backward (JAX `_fwd` / `_bwd`,
  :757-796); otherwise K1 (or K5, above `MAX_SEQ_FWD`) forward and K2
  backward. The adapter segment stays plain torch under autograd, as in JAX
  (:789-790).

`MAX_SEQ_FWD` and `MAX_SEQ_BWD` are read at each call, so tests may
monkeypatch them as the JAX tests do. The header note of each CUDA source
says what bounds it on the card and how its design answers that. For every
wrapper:

- A CUDA tensor launches the kernel, or the wrapper raises. There is no
  fallback and no flag that routes CUDA to the plain version.
- A CPU tensor takes the plain version (`<wrapper>_ref`).
- `<wrapper>.launches` counts kernel launches; only the CUDA branch adds
  to it.

Under sequence parallelism (`sp_flash_or_einsum`, JAX :811-1017) each sp
rank runs K5, K6a and K6b on its own S/sp q rows at `q_offset` = its sp
index · S/sp, against K/V all-gathered over the sp group
(`SpFlashAdapterAttention`); the full-length dk/dv partials go back to
their shards by a reduce-scatter. A sequence that sp does not divide is
held whole by every sp rank and goes through the single-rank kernels.

The kernels' persistent grids take their work items from a counter in
device memory that the launch's last block resets. Each launch gets the
counter of the stream it runs on (`_item_counter`): launches on one
stream run in order, and two in flight on two streams each take all of
their own items.
"""
from __future__ import annotations

import math
import warnings
from typing import Optional

import torch

from ...core import collectives as C
from ..attention import (NEG_INF, adapter_gated_attention,
                         adapter_prefix_attention)

# head dims the kernels are instantiated for (csrc/flash_*.cu): every LLaMA
# preset the repo names (7B, 13B, 33B) has 128
KERNEL_HEAD_DIMS = (128,)
# q rows per dgate2 partial of K2 and K6a (a consumer warpgroup of their dq
# loop, csrc/flash_bwd_wgmma.cuh WG_ROWS): one partial per (b, h, 64-row q
# tile)
DQ_TILE = 64
# The JAX package's switch to the streaming kernels (flash_attention.py:
# 47-48): a forward above MAX_SEQ_FWD takes K5, a backward above MAX_SEQ_BWD
# takes K6, and a differentiated call above MAX_SEQ_BWD saves K5's lse.
MAX_SEQ_FWD = 4096
MAX_SEQ_BWD = 2048


def _video_block(s_q: int, s_k: int, video_start, max_feats: int, device,
                 q_offset: int = 0):
    """(B, 1, S_q, S_k) bool: text rows ≥ vs+F × video columns [vs, vs+F),
    off where video_start < 0 (JAX: flash_attention.py:84-85, :476-477);
    row i of q sits at global position q_offset + i."""
    row = torch.arange(s_q, device=device)[:, None] + q_offset
    col = torch.arange(s_k, device=device)[None, :]
    vs = video_start.long()[:, None, None, None]
    return ((row >= vs + max_feats) & (col >= vs)
            & (col < vs + max_feats) & (vs >= 0))


def _masked_scores(q, k, gate2, video_start, max_feats: int,
                   q_offset: int = 0):
    """f32 scores q·kᵀ/√dh + gate2·block, causal positions set to -1e30
    (B, H, S_q, S_k), from operands in q.dtype, as the TPU kernels take
    them. Row i of q is global row q_offset + i; the mask keeps column c
    where c <= q_offset + i (the streaming kernels' `(col <= row) & (col <
    S_k) & (row < q_offset + S_q)`, :463-481, whose other two terms hold for
    every row and column here: q and k have no padded rows)."""
    s_q, s_k, dh = q.shape[1], k.shape[1], q.shape[3]
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
        * (1.0 / math.sqrt(dh))
    block = _video_block(s_q, s_k, video_start, max_feats, q.device,
                         q_offset)
    scores = scores + torch.where(block, gate2.float()[None, :, None, None],
                                  torch.zeros((), device=q.device))
    causal = (torch.arange(s_k, device=q.device)[None, :]
              <= torch.arange(s_q, device=q.device)[:, None] + q_offset)
    return torch.where(causal, scores, torch.full_like(scores, NEG_INF))


def flash_text_attention_ref(q, k, v, gate2, video_start, max_feats: int,
                             q_offset: int = 0):
    """Plain PyTorch K1. It follows the input dtype: for bf16 inputs it
    does what the TPU kernel does (bf16 operands, f32 score and value
    products, P cast to bf16); for f32 inputs it stays f32 throughout, like
    `adapter_gated_attention`. Returns (out (B,S,H,Dh) q.dtype, lse (B,H,S) f32).
    K5's plain version runs it with q's rows at global positions
    q_offset + i against K/V of their own length.
    """
    cd = q.dtype
    scores = _masked_scores(q, k, gate2, video_start, max_feats, q_offset)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs.to(cd).float(), v.float())
    return out.to(cd), lse


def _check_cuda_inputs(q, k, v, gate2, video_start, streaming=False):
    """The layout the kernels take. K1 reads k and v through q's strides,
    so they share q's shape and strides; K5 (`streaming`) takes K/V of
    their own length S_k, with strides shared by k and v."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q, k, v must be 4-D with one K/V shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if streaming:
        if (k.shape[0], k.shape[2], k.shape[3]) != (q.shape[0], q.shape[2],
                                                    q.shape[3]):
            raise ValueError(f"k, v (B, S_k, H, Dh) must match q (B, S_q, "
                             f"H, Dh) but in S, got {tuple(k.shape)} vs "
                             f"{tuple(q.shape)}")
    elif k.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, S, H, Dh) shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, s, h, dh = q.shape
    for name, t in (("q", q), ("k", k), ("v", v), ("gate2", gate2),
                    ("video_start", video_start)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    layout = k if streaming else q
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the flash kernels take bf16 {name}, got "
                            f"{t.dtype}")
        want = q if name == "q" else layout
        if t.stride() != want.stride() or t.stride(-1) != 1:
            raise ValueError(f"q, k, v need the layout the kernel reads them "
                             f"by, with a unit Dh stride, got {name} strides "
                             f"{t.stride()} vs {want.stride()}")
        if any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be 16-byte aligned")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernels are built for head dims "
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


# (device index, stream handle) -> the stream's item counter: two uint32
# (the next shared item, the blocks done), zero between launches
_COUNTERS: dict = {}
# device index -> counters zeroed outside any CUDA-graph capture, kept for
# streams that are first seen while being captured
_SPARE: dict = {}
SPARE_COUNTERS = 16


def _item_counter(device, stream) -> int:
    """The address of `stream`'s item counter on `device`. A stream first
    seen outside a CUDA-graph capture gets a counter zeroed on it; the
    device's first such counter comes with SPARE_COUNTERS more, zeroed
    before the call returns. A stream first seen while it is captured (its
    launches become a graph's) takes a spare: a counter made inside the
    capture would be zeroed by a fill captured into the graph, one more
    node before every launch. Graphs captured on one stream share its
    counter, so they replay one at a time, as launches on one stream do.
    With no spare left, each captured launch takes a counter of its own
    from the graph's memory, zeroed by a captured fill."""
    key = (device.index, stream.cuda_stream)
    counter = _COUNTERS.get(key)
    if counter is not None:
        return counter.data_ptr()
    if not torch.cuda.is_current_stream_capturing():
        counter = torch.zeros(2, dtype=torch.int32, device=device)
        if device.index not in _SPARE:
            _SPARE[device.index] = list(torch.zeros(
                SPARE_COUNTERS, 2, dtype=torch.int32, device=device))
            stream.synchronize()
    elif _SPARE.get(device.index):
        counter = _SPARE[device.index].pop()
    else:
        return torch.zeros(2, dtype=torch.int32, device=device).data_ptr()
    _COUNTERS[key] = counter
    return counter.data_ptr()


def _raise_on(err: int, lib, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.error_string(err)} "
                           f"(cudaError {err})")


def _device_check(t, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{t.device}")


def flash_text_attention(q, k, v, gate2, video_start, max_feats: int):
    """Causal text attention + gate2 video-block bias.

    q, k, v: (B, S, H, Dh); gate2: (H,) f32; video_start: (B,) int32
    (-1 → no bias). Returns (out (B,S,H,Dh), lse (B,H,S) f32). Above
    MAX_SEQ_FWD this is K5's call (`flash_streaming_fwd`).
    """
    if q.shape[1] > MAX_SEQ_FWD:
        return flash_streaming_fwd(q, k, v, gate2, video_start, max_feats)
    if q.device.type == "cpu":
        return flash_text_attention_ref(q, k, v, gate2, video_start, max_feats)
    _device_check(q, "flash_text_attention")
    _check_cuda_inputs(q, k, v, gate2, video_start)
    from .build import build

    lib = build()
    b, s, h, dh = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device)
    with torch.cuda.device(q.device):
        err = lib.lib.flash_text_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gate2.data_ptr(),
            video_start.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, s, h, dh, int(max_feats),
            *q.stride()[:3], *out.stride()[:3],
            1.0 / math.sqrt(dh), _item_counter(q.device, stream),
            stream.cuda_stream)
    _raise_on(err, lib, "flash_text_fwd")
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
    block = _video_block(q.shape[1], q.shape[1], video_start, max_feats,
                         q.device)
    dgate2 = torch.where(block, ds, torch.zeros((), device=q.device)).sum(
        dim=(0, 2, 3))
    return dq.to(cd), dk.to(cd), dv.to(cd), dgate2


def flash_text_attention_bwd(q, k, v, gate2, video_start, max_feats: int, do,
                             out, lse):
    """Backward of the text segment: (dq, dk, dv (B,S,H,Dh), dgate2 (H,)).

    do is the gradient of K1's out; `out` and `lse` are K1's outputs, which
    the kernel reads (D = rowsum(dO∘O), P = exp(s − lse)) instead of
    recomputing the forward. The plain version recomputes both, as the TPU
    kernel does, and ignores them. Above MAX_SEQ_BWD this is K6's call
    (`flash_streaming_bwd`), which reads them too.
    """
    if q.shape[1] > MAX_SEQ_BWD:
        return flash_streaming_bwd(q, k, v, gate2, video_start, max_feats, do,
                                   out, lse)
    if q.device.type == "cpu":
        return flash_text_attention_bwd_ref(q, k, v, gate2, video_start,
                                            max_feats, do)
    _device_check(q, "flash_text_attention_bwd")
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
    dg2_part = torch.empty((b, h, -(-s // DQ_TILE)), dtype=torch.float32,
                           device=q.device)
    stream = torch.cuda.current_stream(q.device)
    with torch.cuda.device(q.device):
        err = lib.lib.flash_text_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), gate2.data_ptr(),
            video_start.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), dg2_part.data_ptr(),
            b, s, h, dh, int(max_feats), 1.0 / math.sqrt(dh),
            _item_counter(q.device, stream), stream.cuda_stream)
    _raise_on(err, lib, "flash_text_bwd")
    flash_text_attention_bwd.launches += 1
    # per-(b, h, q tile) partials, summed here: no atomics in the kernel,
    # so dgate2 is the same from run to run (JAX sums over B outside, :300)
    return dq, dk, dv, dg2_part.sum(dim=(0, 2))


flash_text_attention_bwd.launches = 0


# --- K5, K6a, K6b: the streaming kernels ------------------------------------

def _per_head(fn, q, k, v, gate2, *per_head):
    """fn(q, k, v, gate2, *per_head) one head at a time, its outputs
    concatenated along the head axis (dim 2 of a (B, S, H, Dh) output, 1 of
    (B, H, S), 0 of (H,)), so that the streaming plain versions hold one
    head's S_q x S_k scores at a time and run on the card at S 4096-8192
    beside the kernels they check. `per_head` holds (B, S, H, Dh) tensors,
    cut on dim 2, and (B, H, S) tensors, cut on dim 1."""
    parts = []
    for j in range(q.shape[2]):
        sl = slice(j, j + 1)
        parts.append(fn(q[:, :, sl], k[:, :, sl], v[:, :, sl], gate2[sl],
                        *(x[:, :, sl] if x.dim() == 4 else x[:, sl]
                          for x in per_head)))
    dims = {4: 2, 3: 1, 1: 0}
    return tuple(torch.cat(xs, dim=dims[xs[0].dim()]) for xs in zip(*parts))


def flash_streaming_fwd_ref(q, k, v, gate2, video_start, max_feats: int,
                            q_offset: int = 0):
    """Plain PyTorch K5: K1's plain version with global rows q_offset + i
    against S_k columns, one head at a time. Returns (out (B, S_q,
    H, Dh) q.dtype, lse (B, H, S_q) f32)."""
    return _per_head(
        lambda q_, k_, v_, g2_: flash_text_attention_ref(
            q_, k_, v_, g2_, video_start, max_feats, q_offset),
        q, k, v, gate2)


def flash_streaming_fwd(q, k, v, gate2, video_start, max_feats: int,
                        q_offset: int = 0):
    """Streaming causal attention + gate2 video-block bias: q (B, S_q, H,
    Dh) whose row i is global row q_offset + i, k, v (B, S_k, H, Dh);
    gate2 (H,) f32; video_start (B,) int32. Returns (out (B, S_q, H, Dh),
    lse (B, H, S_q) f32)."""
    if q.device.type == "cpu":
        return flash_streaming_fwd_ref(q, k, v, gate2, video_start, max_feats,
                                       q_offset)
    _device_check(q, "flash_streaming_fwd")
    _check_cuda_inputs(q, k, v, gate2, video_start, streaming=True)
    from .build import build

    lib = build()
    b, s_q, h, dh = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device)
    with torch.cuda.device(q.device):
        err = lib.lib.flash_stream_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gate2.data_ptr(),
            video_start.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, s_q, k.shape[1], h, dh, int(q_offset), int(max_feats),
            *q.stride()[:3], *k.stride()[:3], *out.stride()[:3],
            1.0 / math.sqrt(dh), _item_counter(q.device, stream),
            stream.cuda_stream)
    _raise_on(err, lib, "flash_stream_fwd")
    flash_streaming_fwd.launches += 1
    return out, lse


flash_streaming_fwd.launches = 0


def stream_delta(g, o_text):
    """D = Σ_dh dO∘O_text per row, (B, H, S_q) f32, as the JAX package
    computes it in XLA outside the streaming kernels (:608-613)."""
    return (g.float() * o_text.float()).sum(-1).transpose(1, 2).contiguous()


def _stream_bwd_plain(q, k, v, gate2, video_start, g, lse, delta,
                      max_feats: int, q_offset: int, part: str):
    """What `_stream_dq_kernel` (part "dq") or `_stream_dkv_kernel` ("dkv")
    computes (:484-578): P = exp(s − lse) from the saved lse, dS = P (dP −
    D) in f32, P and dS rounded to q.dtype before their products."""
    cd = q.dtype
    scale = 1.0 / math.sqrt(q.shape[3])
    scores = _masked_scores(q, k, gate2, video_start, max_feats, q_offset)
    p = torch.exp(scores - lse[..., None])           # 0 where masked (-1e30)
    g32 = g.float()
    dp = torch.einsum("bshd,bthd->bhst", g32, v.float())
    ds = p * (dp - delta[..., None])
    ds_c = ds.to(cd).float()
    if part == "dq":
        dq = torch.einsum("bhst,bthd->bshd", ds_c, k.float()) * scale
        block = _video_block(q.shape[1], k.shape[1], video_start, max_feats,
                             q.device, q_offset)
        dgate2 = torch.where(block, ds, torch.zeros((), device=q.device)).sum(
            dim=(0, 2, 3))
        return dq.to(cd), dgate2
    dk = torch.einsum("bhst,bshd->bthd", ds_c, q.float()) * scale
    dv = torch.einsum("bhst,bshd->bthd", p.to(cd).float(), g32)
    return dk.to(cd), dv.to(cd)


def flash_streaming_dq_ref(q, k, v, gate2, video_start, max_feats: int, g,
                           lse, delta, q_offset: int = 0):
    """Plain PyTorch K6a: (dq (B, S_q, H, Dh) q.dtype, dgate2 (H,) f32
    summed over B), one head at a time."""
    return _per_head(
        lambda q_, k_, v_, g2_, g_, lse_, d_: _stream_bwd_plain(
            q_, k_, v_, g2_, video_start, g_, lse_, d_, max_feats, q_offset,
            "dq"),
        q, k, v, gate2, g, lse, delta)


def flash_streaming_dkv_ref(q, k, v, gate2, video_start, max_feats: int, g,
                            lse, delta, q_offset: int = 0):
    """Plain PyTorch K6b: (dk, dv (B, S_k, H, Dh) q.dtype), the partial sums
    over q's rows, one head at a time."""
    return _per_head(
        lambda q_, k_, v_, g2_, g_, lse_, d_: _stream_bwd_plain(
            q_, k_, v_, g2_, video_start, g_, lse_, d_, max_feats, q_offset,
            "dkv"),
        q, k, v, gate2, g, lse, delta)


def _check_stream_bwd(q, k, v, gate2, video_start, g, lse, delta):
    _check_cuda_inputs(q, k, v, gate2, video_start, streaming=True)
    b, s_q, h, _ = q.shape
    if g.shape != q.shape or g.dtype != torch.bfloat16 or g.device != q.device:
        raise ValueError(f"g must be bf16 {tuple(q.shape)} on {q.device}, "
                         f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b, h, s_q) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 ({b}, {h}, "
                             f"{s_q}) on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def _stream_bwd_launch(fn_name: str, q, k, v, gate2, video_start,
                       max_feats: int, g, lse, delta, q_offset: int, outs):
    from .build import build

    lib = build()
    b, s_q, h, dh = q.shape
    stream = torch.cuda.current_stream(q.device)
    with torch.cuda.device(q.device):
        err = getattr(lib.lib, fn_name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), gate2.data_ptr(),
            video_start.data_ptr(), *(o.data_ptr() for o in outs),
            b, s_q, k.shape[1], h, dh, int(q_offset), int(max_feats),
            1.0 / math.sqrt(dh), _item_counter(q.device, stream),
            stream.cuda_stream)
    _raise_on(err, lib, fn_name)


def flash_streaming_dq(q, k, v, gate2, video_start, max_feats: int, g, lse,
                       delta, q_offset: int = 0):
    """K6a: (dq (B, S_q, H, Dh), dgate2 (H,) f32) from the saved lse and the
    row statistic delta = `stream_delta(g, o_text)`, both (B, H, S_q) f32.
    dgate2 sums this shard's rows only."""
    if q.device.type == "cpu":
        return flash_streaming_dq_ref(q, k, v, gate2, video_start, max_feats,
                                      g, lse, delta, q_offset)
    _device_check(q, "flash_streaming_dq")
    q, k, v, g = (t.contiguous() for t in (q, k, v, g))
    _check_stream_bwd(q, k, v, gate2, video_start, g, lse, delta)
    b, s_q, h, _ = q.shape
    dq = torch.empty_like(q)
    dg2_part = torch.empty((b, h, -(-s_q // DQ_TILE)), dtype=torch.float32,
                           device=q.device)
    _stream_bwd_launch("flash_stream_dq", q, k, v, gate2, video_start,
                       max_feats, g, lse, delta, q_offset, (dq, dg2_part))
    flash_streaming_dq.launches += 1
    # per-(b, h, q tile) partials, summed here: no atomics in the kernel
    return dq, dg2_part.sum(dim=(0, 2))


flash_streaming_dq.launches = 0


def flash_streaming_dkv(q, k, v, gate2, video_start, max_feats: int, g, lse,
                        delta, q_offset: int = 0):
    """K6b: (dk, dv (B, S_k, H, Dh)), partial sums over this shard's rows;
    inputs as `flash_streaming_dq`."""
    if q.device.type == "cpu":
        return flash_streaming_dkv_ref(q, k, v, gate2, video_start,
                                       max_feats, g, lse, delta, q_offset)
    _device_check(q, "flash_streaming_dkv")
    q, k, v, g = (t.contiguous() for t in (q, k, v, g))
    _check_stream_bwd(q, k, v, gate2, video_start, g, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _stream_bwd_launch("flash_stream_dkv", q, k, v, gate2, video_start,
                       max_feats, g, lse, delta, q_offset, (dk, dv))
    flash_streaming_dkv.launches += 1
    return dk, dv


flash_streaming_dkv.launches = 0


def flash_streaming_bwd(q, k, v, gate2, video_start, max_feats: int, g,
                        o_text, lse, q_offset: int = 0):
    """The streaming backward (JAX `flash_streaming_bwd`, :581-746): D in
    plain torch, then K6a (dq, dgate2) and K6b (dk, dv), or on CPU tensors
    their plain versions. `o_text` and `lse` are K5's outputs for this q.
    Returns (dq (B, S_q, H, Dh), dk, dv (B, S_k, H, Dh), dgate2 (H,)); a q
    shard's dk, dv and dgate2 are partial sums over its rows, which a
    sequence-parallel caller sums."""
    delta = stream_delta(g, o_text)
    dq, dgate2 = flash_streaming_dq(q, k, v, gate2, video_start, max_feats, g,
                                    lse, delta, q_offset)
    dk, dv = flash_streaming_dkv(q, k, v, gate2, video_start, max_feats, g,
                                 lse, delta, q_offset)
    return dq, dk, dv, dgate2


# --- the two-segment attention under autograd -------------------------------

class _KeptAttention:
    """The (text, lse) of each attention call in one checkpointed unit's
    forward, in call order; the unit's recompute takes them back instead
    of launching the forward kernel again."""

    def __init__(self):
        self.kept = []
        self.replaying = False


# the unit whose forward or recompute is running (`keep_attention`); a
# module global, not a thread-local: autograd runs a CUDA recompute on its
# own thread, and a unit's forward and its recompute never overlap
_KEPT = None


def keep_attention(fn):
    """`fn` (one block, or a --remat_group of blocks) as a checkpoint unit
    under the qkv remat policy: its first call (the forward) keeps each
    attention call's text output and lse, its second (the recompute in
    the backward, `torch.utils.checkpoint`) hands them back, so K1 (K5 in
    the streaming regime) runs once per block per update instead of
    twice. The recompute's values are the forward's bit for bit, so the
    gradients are the 'full' policy's. The forward kernel launches through
    ctypes, which a dispatch-level selective-checkpoint policy cannot see:
    hence this stash in `FlashAdapterAttention.forward`."""
    unit = _KeptAttention()

    def run(*args):
        global _KEPT
        prev, _KEPT = _KEPT, unit
        try:
            return fn(*args)
        finally:
            _KEPT = prev
            unit.replaying = True
    return run


class FlashAdapterAttention(torch.autograd.Function):
    """Two-segment attention, segment B through the flash kernels, the
    adapter segment in plain torch (JAX `_flash_adapter_attention`,
    flash_attention.py:749-796). `streaming` is the JAX `_fwd` regime
    (:757-773): K5 forward, its (text, lse) saved, K6a + K6b backward;
    otherwise K1 (K5 above MAX_SEQ_FWD) forward and K2 backward."""

    @staticmethod
    def forward(ctx, q, k, v, adapter_k, adapter_v, gate1, gate2,
                video_start, max_feats, streaming):
        b, s, h, dh = q.shape
        g2 = gate2.float()
        vs = video_start.to(torch.int32)
        unit = _KEPT
        if unit is not None and unit.replaying:
            text, lse = unit.kept.pop(0)
        else:
            fwd = flash_streaming_fwd if streaming else flash_text_attention
            text, lse = fwd(q, k, v, g2, vs, max_feats)
            if unit is not None:
                unit.kept.append((text, lse))
        out = text + adapter_prefix_attention(q, adapter_k, adapter_v, gate1)
        ctx.save_for_backward(q, k, v, adapter_k, adapter_v, gate1, g2, vs,
                              text, lse)
        ctx.max_feats = max_feats
        ctx.streaming = streaming
        ctx.gate2_dtype = gate2.dtype
        return out.reshape(b, s, h * dh)

    @staticmethod
    def backward(ctx, g):
        q, k, v, adapter_k, adapter_v, gate1, g2, vs, text, lse = \
            ctx.saved_tensors
        g4 = g.reshape(q.shape).to(q.dtype)
        bwd = (flash_streaming_bwd if ctx.streaming
               else flash_text_attention_bwd)
        dq_t, dk, dv, dg2 = bwd(q, k, v, g2, vs, ctx.max_feats, g4, text, lse)
        # adapter segment: exact tiny attention, differentiated by autograd
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in
                      (q, adapter_k, adapter_v, gate1)]
            seg = adapter_prefix_attention(*leaves)
        dq_a, dak, dav, dg1 = torch.autograd.grad(seg, leaves, g4)
        return (dq_t + dq_a, dk, dv, dak, dav, dg1,
                dg2.to(ctx.gate2_dtype), None, None, None)


def flash_adapter_attention(q, k, v, adapter_k, adapter_v, gate1, gate2,
                            video_start, max_feats: int) -> torch.Tensor:
    """Two-segment attention with segment B through the flash kernels.
    Returns (B, S, H*Dh).

    A call that autograd will differentiate (grad mode on and an input that
    requires grad: the counterpart of JAX choosing the custom VJP's forward
    rule, also inside `torch.utils.checkpoint`'s recompute) with S >
    MAX_SEQ_BWD takes the streaming regime: K5 forward, K6a + K6b backward.
    Any other call runs `flash_text_attention` (K1, or K5 above
    MAX_SEQ_FWD) and, if differentiated, K2 backward."""
    differentiated = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, adapter_k, adapter_v, gate1,
                                  gate2))
    streaming = differentiated and q.shape[1] > MAX_SEQ_BWD
    return FlashAdapterAttention.apply(q, k, v, adapter_k, adapter_v, gate1,
                                       gate2, video_start, max_feats,
                                       streaming)


# --- sequence parallelism (JAX flash_attention.py:811-1017) ------------------

def sp_indivisible_reason(s: int, b: int, sp: int, dp: int) -> Optional[str]:
    """Why a length-s sequence of a global batch of b cannot be cut into
    sp equal shards over dp rows, or None (JAX `_indivisible_reason`,
    :992-1001)."""
    if s % sp:
        return f"S={s} % sp={sp} != 0"
    if b % dp:
        return f"B={b} % dp={dp} != 0"
    return None


class SpFlashAdapterAttention(torch.autograd.Function):
    """Sequence-parallel two-segment attention (JAX
    `sp_flash_adapter_attention`, :945-989). q, k, v are this rank's S/sp
    rows, at global rows q_offset.. of the sequence.

    Forward: K/V all-gathered over the sp group, K5 on the local q rows at
    q_offset; the adapter segment outside, exact small attention on the
    local rows (JAX :945-980). Backward: K/V gathered again, D in plain
    torch, K6a for dq and dgate2 and K6b for the full-length dk/dv
    partials, which a reduce-scatter (in f32) sums and hands back to their
    shards. dgate2 is this rank's rows' part: the train step's one sum
    over dp×sp completes it (JAX sums it here, :931, and the step's
    reduction would count it twice). Under the qkv remat policy the
    recompute takes (text, lse) from the forward's stash, as
    `FlashAdapterAttention` does."""

    @staticmethod
    def forward(ctx, q, k, v, adapter_k, adapter_v, gate1, gate2,
                video_start, max_feats, group, q_offset):
        b, s, h, dh = q.shape
        g2 = gate2.float()
        vs = video_start.to(torch.int32)
        unit = _KEPT
        if unit is not None and unit.replaying:
            text, lse = unit.kept.pop(0)
        else:
            kf, vf = _gather_kv(k, v, group)
            text, lse = flash_streaming_fwd(q, kf, vf, g2, vs, max_feats,
                                            q_offset)
            if unit is not None:
                unit.kept.append((text, lse))
        out = text + adapter_prefix_attention(q, adapter_k, adapter_v, gate1)
        ctx.save_for_backward(q, k, v, adapter_k, adapter_v, gate1, g2, vs,
                              text, lse)
        ctx.max_feats, ctx.group, ctx.q_offset = max_feats, group, q_offset
        ctx.gate2_dtype = gate2.dtype
        return out.reshape(b, s, h * dh)

    @staticmethod
    def backward(ctx, g):
        q, k, v, adapter_k, adapter_v, gate1, g2, vs, text, lse = \
            ctx.saved_tensors
        g4 = g.reshape(q.shape).to(q.dtype)
        kf, vf = _gather_kv(k, v, ctx.group)
        dq_t, dk_full, dv_full, dg2 = flash_streaming_bwd(
            q, kf, vf, g2, vs, ctx.max_feats, g4, text, lse, ctx.q_offset)
        dk = C.reduce_scatter(dk_full.float(), ctx.group, 1).to(k.dtype)
        dv = C.reduce_scatter(dv_full.float(), ctx.group, 1).to(v.dtype)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in
                      (q, adapter_k, adapter_v, gate1)]
            seg = adapter_prefix_attention(*leaves)
        dq_a, dak, dav, dg1 = torch.autograd.grad(seg, leaves, g4)
        return (dq_t + dq_a, dk, dv, dak, dav, dg1,
                dg2.to(ctx.gate2_dtype), None, None, None, None)


def _gather_kv(k, v, group):
    """The whole sequence's K and V, (B, S, H, Dh) contiguous."""
    return (C.all_gather(k, group, 1).contiguous(),
            C.all_gather(v, group, 1).contiguous())


def sp_flash_adapter_attention(q, k, v, adapter_k, adapter_v, gate1, gate2,
                               video_start, max_feats: int, group,
                               q_offset: int) -> torch.Tensor:
    """Sequence-parallel drop-in for `adapter_gated_attention` on this
    rank's rows: K5/K6 per shard against K/V gathered over `group`, at any
    S (JAX routes every multi-device mesh here, llama.py:252-266).
    Returns (B, S/sp, H*Dh)."""
    return SpFlashAdapterAttention.apply(q, k, v, adapter_k, adapter_v,
                                         gate1, gate2, video_start,
                                         max_feats, group, q_offset)


def sp_flash_or_einsum(q, k, v, adapter_k, adapter_v, gate1, gate2,
                       video_start, max_feats: int, seq,
                       use_flash: bool = True) -> torch.Tensor:
    """Sequence-parallel dispatch (JAX `sp_flash_or_einsum`, :984-1017).
    `seq` is the rank's `model.llama.SeqShard`. Where the sequence could
    not be cut (`seq.reason`: S % sp or B % dp), every sp rank holds the
    whole sequence, the input of the single-rank path: this warns with
    JAX's text and runs `flash_adapter_attention` on it (JAX takes its
    einsum attention there); divisible shapes take the streaming kernels
    on the shard (`sp_flash_adapter_attention`). Under --no_flash: the
    einsum attention, on q, k, v gathered over the group for a shard, this
    rank's rows kept."""
    if seq.reason is not None:
        if not use_flash:
            return adapter_gated_attention(q, k, v, adapter_k, adapter_v,
                                           gate1, gate2, video_start,
                                           max_feats)
        warnings.warn(
            "sequence-parallel flash kernels skipped (" + seq.reason +
            "); every sp rank attends over the whole sequence with the "
            "single-rank flash kernels. Pick sp/dp that divide S and B "
            "evenly.", stacklevel=2)
        return flash_adapter_attention(q, k, v, adapter_k, adapter_v, gate1,
                                       gate2, video_start, max_feats)
    if use_flash:
        return sp_flash_adapter_attention(q, k, v, adapter_k, adapter_v,
                                          gate1, gate2, video_start,
                                          max_feats, seq.group, seq.offset)
    from ..parallel import seq_gather

    gather = lambda t: seq_gather(t, seq.group)
    out = adapter_gated_attention(gather(q), gather(k), gather(v), adapter_k,
                                  adapter_v, gate1, gate2, video_start,
                                  max_feats)
    return out[:, seq.offset:seq.offset + q.shape[1]]
