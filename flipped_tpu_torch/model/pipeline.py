"""Pipeline parallelism: the blocks split into stages over the pp ranks, with
a GPipe microbatch schedule (JAX: flipped_tpu/model/pipeline.py).

Stage s is a rank that holds blocks [s·L/pp, (s+1)·L/pp) (core/mesh.py
`stage_layers`; the frozen leaves of the other blocks are freed,
model/parallel.py). `FlippedVQAModel.encode` sends its block sweep here
when the mesh has pp > 1, and `prefill`, `extend_logits` and `decode_step`
send theirs here always (without pp: one stage, one microbatch, one tick,
no exchange, the plain loop over the blocks): the embedding, the video
splice, the sp cut and the final norm run on every rank, outside the
schedule, as in JAX.

The schedule is JAX's tick structure, one Python loop:

  * the rank's rows are split into M microbatches, striped: microbatch t is
    rows {t, M+t, 2M+t, ...} (`stripe`), M the largest count ≤
    --pp_microbatches (default pp) that divides the rows
    (`pick_microbatches`);
  * there are M + pp - 1 ticks; at tick t stage 0 feeds microbatch
    min(t, M-1), every other stage takes what the previous stage sent at
    tick t-1, and each stage runs its blocks on microbatch t - s (clamped:
    the bubble ticks compute on stale inputs, and their outputs are
    discarded);
  * every tick but the last ends in one ring exchange
    (model/parallel.py `ring_shift`): stage s sends to s+1 mod pp;
  * the last stage emitted microbatch m at tick m + pp - 1; `from_last`
    hands those outputs to every stage (JAX's masked psum in f32).

Every stage runs every tick, the bubble ticks included, and every rank
issues the same exchanges in the same order. Autograd's backward then runs
the reverse ring in the reverse order on every rank too: tick t's exchange
takes the gradient of what tick t+1 received, so the exchanges form one
chain on each rank (stage 0 takes the value it receives into its graph at
a zero gradient, `tie`, so its chain is whole), and ranks of one stage run
the same graph. That is what keeps an eager pipeline from hanging.
Skipping the bubble ticks, or a 1F1B schedule, is speed work (ROADMAP
[11]).

The KV-cache paths run the same schedule without gradients: `prefill`
keeps each stage's layers' K/V (the cache holds this stage's layers only,
written on the tick that runs the real microbatch), `extend` sweeps the
option chunks through the stages against that cache, and `decode` rings
one token through the stages (pp ticks; a stage's cache writes on a tick
that is not its own are undone).

Under remat each block is its own checkpoint unit, under the 'full' or
'qkv' policy; --remat_group is not taken, as JAX's pipeline does not take
it (pipeline.py:137-163).
"""
from __future__ import annotations

from typing import List

import torch
from torch.utils.checkpoint import checkpoint

from ..core.mesh import PP_AXIS
from .kernels.flash_attention import keep_attention
from .parallel import from_last, ring_shift, tie


def pick_microbatches(requested: int, pp: int, rows: int) -> int:
    """Largest M ≤ requested (default pp) that divides `rows`, this rank's
    rows (JAX `_pick_microbatches`, :166-174): shrinking keeps odd eval
    tails runnable (M 1 is a degenerate but correct pipeline)."""
    m = max(1, requested or pp)
    while rows % m:
        m -= 1
    return m


def stripe(x: torch.Tensor, m: int) -> List[torch.Tensor]:
    """(b, ...) → M microbatches, microbatch t = rows {t, M+t, ...} (JAX
    `_stripe`, :312-316), each contiguous."""
    return [x[t::m].contiguous() for t in range(m)]


def unstripe(parts: torch.Tensor) -> torch.Tensor:
    """(M, mb, ...) → (b, ...): the inverse of `stripe` (JAX `_unstripe`)."""
    if parts.shape[0] == 1:
        return parts[0]
    return parts.transpose(0, 1).reshape((-1,) + parts.shape[2:])


def is_pipelined(model) -> bool:
    mesh = getattr(model, "mesh", None)
    return mesh is not None and mesh.size(PP_AXIS) > 1


def loss_weight(model) -> float:
    """What the train step scales this rank's loss by before its backward:
    1 on the last stage, 0 on the others. Every pp rank computes the heads
    and the losses on the same broadcast h; the last stage's backward alone
    carries the cotangent, which `from_last`'s backward hands back to the
    last stage's blocks (zeros on the others), so the trainables of the
    heads (and of the splice, on stage 0) are counted once when the step
    sums the gradients over dp×pp×sp."""
    if not is_pipelined(model):
        return 1.0
    return float(model.mesh.index(PP_AXIS) == model.mesh.size(PP_AXIS) - 1)


def _stage(model):
    """(pp, stage, pp group) of this rank; (1, 0, None) without pp: one
    stage, whose schedule is one tick over one microbatch."""
    if not is_pipelined(model):
        return 1, 0, None
    mesh = model.mesh
    return mesh.size(PP_AXIS), mesh.index(PP_AXIS), mesh.group(PP_AXIS)


def _schedule(model, feeds: List[torch.Tensor], run_stage, n_ticks: int):
    """The tick loop: `run_stage(x, tick)` → this stage's output of tick t;
    → the outputs of ticks pp-1 .. n_ticks-1 on the last stage, on every
    stage, stacked (n_ticks - pp + 1, ...) (one stage: its one output, as
    a view)."""
    pp, stage, group = _stage(model)
    recv, outs = None, []
    for t in range(n_ticks):
        if stage == 0:
            x = feeds[min(t, len(feeds) - 1)]
            if recv is not None:
                x = tie(x, recv)
        else:
            x = recv if recv is not None else torch.zeros_like(feeds[0])
        out = run_stage(x, t)
        if t < n_ticks - 1:
            recv = ring_shift(out, group)
        if t >= pp - 1:
            outs.append(out)
    if pp == 1:
        return outs[0][None]
    return from_last(torch.stack(outs), group)


def _sweep(model, h, run_stage):
    """h's rows through the stages in M microbatches: `run_stage(x, rows,
    real)` runs this stage's blocks on x, the microbatch of rows `rows`
    (a slice: {t - s, t - s + M, ...} at tick t, clamped in the bubble),
    `real` False on a bubble tick; → the blocks' output on every stage."""
    pp, stage, _ = _stage(model)
    m = pick_microbatches(model.pp_microbatches, pp, h.shape[0]) \
        if pp > 1 else 1

    def tick(x, t):
        mi = min(max(t - stage, 0), m - 1)
        return run_stage(x, slice(mi, None, m), t - stage == mi)

    return unstripe(_schedule(model, stripe(h, m), tick, m + pp - 1))


def encode_blocks(model, h, rope_cos, rope_sin, video_start, seq=None):
    """The stage sweep of `FlippedVQAModel.encode` (JAX `pipeline_encode`,
    :177-296): h (B, S or S/sp, dim) after the splice and the sp cut → the
    blocks' output on every stage, before the final norm."""
    remat = model.remat and torch.is_grad_enabled()
    unit = keep_attention if model.remat_policy == "qkv" else (lambda f: f)
    blocks = model.stage_blocks()

    def run_stage(x, rows, real):
        vs = video_start[rows].contiguous()
        for block, adapter in blocks:
            if remat:
                x = checkpoint(unit(block), x, rope_cos, rope_sin, adapter,
                               vs, seq, use_reentrant=False)
            else:
                x = block(x, rope_cos, rope_sin, adapter, vs, seq)
        return x

    return _sweep(model, h, run_stage)


def prefill_blocks(model, h, rope_cos, rope_sin, video_start, cache_k,
                   cache_v):
    """The stage sweep of `FlippedVQAModel.prefill` (JAX
    `pipeline_prefill`, :324-417): each stage writes its layers' K/V of
    a microbatch into its rows of cache_k/v (L/pp, B, cache_len, H, Dh)
    on the tick that runs it; → the blocks' output on every stage."""
    s = h.shape[1]
    blocks = model.stage_blocks()

    def run_stage(x, rows, real):
        vs = video_start[rows].contiguous()
        for i, (block, adapter) in enumerate(blocks):
            x, k, v = block.prefill(x, rope_cos, rope_sin, adapter, vs)
            if real:
                cache_k[i, rows, :s] = k
                cache_v[i, rows, :s] = v
        return x

    return _sweep(model, h, run_stage)


def extend_blocks(model, h, rope_cos, rope_sin, video_start, cache_k,
                  cache_v, prefix, n_opt: int):
    """The stage sweep of `FlippedVQAModel.extend_logits` (JAX
    `pipeline_extend_logits`, :511-607): a microbatch's option chunks
    against its rows of this stage's cache."""
    blocks = model.stage_blocks()

    def run_stage(x, rows, real):
        vs, pr = video_start[rows].contiguous(), prefix[rows].contiguous()
        for i, (block, adapter) in enumerate(blocks):
            x = block.extend(x, rope_cos, rope_sin, adapter, vs,
                             cache_k[i, rows], cache_v[i, rows], pr, n_opt)
        return x

    return _sweep(model, h, run_stage)


def decode_blocks(model, h, rope_cos, rope_sin, video_start, cache_k,
                  cache_v, pos):
    """The stage sweep of `FlippedVQAModel.decode_step` (JAX
    `pipeline_decode_step`, :420-508): the batch's one token crosses the
    ring in pp ticks, stage s running its layers at tick s. On its other
    ticks a stage computes on a stale input, and the K/V that its blocks
    write into the cache at `pos` are put back as they were."""
    pp, stage, _ = _stage(model)
    blocks = model.stage_blocks()

    def run_stage(x, t):
        if t != stage:
            at = (slice(None), torch.arange(x.shape[0], device=x.device),
                  pos.long())
            kept = cache_k[at], cache_v[at]          # copies
        for i, (block, adapter) in enumerate(blocks):
            x = block.decode(x, rope_cos, rope_sin, adapter, video_start,
                             cache_k[i], cache_v[i], pos)
        if t != stage:
            cache_k[at], cache_v[at] = kept
        return x

    return _schedule(model, [h], run_stage, pp)[0]
