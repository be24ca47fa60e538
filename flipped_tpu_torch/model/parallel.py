"""Tensor and sequence parallelism in torch: what GSPMD inserts around the
JAX model's sharded leaves (flipped_tpu/core/mesh.py `_TP_RULES`), spelled
out as autograd Functions over core/collectives.py.

- `copy_to` / `reduce_from` are Megatron's f and g: identity forward and
  all-reduce backward, and the reverse. A column-split Linear's input
  passes through `copy_to` once (so a replicated input's gradient arrives
  whole on every tp rank), a row-split Linear's output through
  `reduce_from`.
- `gather_from` all-gathers along a dim and hands each rank its slice of
  the gradient back: the embedding lookup (split on the feature dim,
  P(None, 'tp')) and the LM head (split by vocabulary) gather their
  outputs. The head gathers the logits, so `ce_ignore_index` and the
  chunked head (`lm_ce_rowwise_chunked`) take the full vocabulary rows and
  give the single-rank sums; each tp rank then holds the full logits of
  its rows, as one card does.
- `seq_gather` all-gathers the sequence rows of an sp group, its backward a
  reduce-scatter (the --no_flash attention and the dense scorer under sp).
- `ring_shift`, `from_last` and `tie` carry the pipeline's activations
  between stages (model/pipeline.py): the ring shift over the pp group,
  its backward the reverse ring (the transpose of JAX's `ppermute`); the
  last stage's output on every stage, its backward the last stage's own
  cotangent, handed to the last stage, and zeros elsewhere (the train
  step backprops the loss of the last stage alone, model/pipeline.py
  `loss_weight`, so the other stages' cotangents are zero and the
  transpose of JAX's masked psum needs no collective); and `tie(x, y)`,
  x with y joined to the graph at a zero gradient, so that stage 0, which
  feeds from the batch, still takes the reverse ring of the value it
  receives and every rank issues the same exchanges in the same order,
  forward and backward.

`parallelize(model, mesh)` cuts a full model to this rank's pieces, leaf by
leaf (`core.mesh.shard_leaf`), frees the frozen leaves of other pipeline
stages' blocks (`core.mesh.keeps_leaf`; `model.dropped` keeps their full
shapes), and marks the modules that run split: the bf16 `Linear`s of the
split table (wq/wk/wv/w1/w3 by output, wo/w2 by input, the head by
vocabulary), the embedding, and the attention heads (an Attention runs
H/tp heads when its four projections split). Quantized leaves replicate
under tp, as in JAX (int8.py:272-300): a quantized block runs K3/K7/K8
forward and K4/K9/K10 backward on the full weights with no collective,
redundantly within its tp group. `materialize` allocates a model built on
the meta device with the stage's leaves only (train/builder.py).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core import collectives as C
from ..core.mesh import TP_AXIS, Mesh, keeps_leaf, shard_leaf, split_dim


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return C.all_reduce(g.clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return C.all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return C.all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        rank = torch.distributed.get_rank(ctx.group)
        return g.narrow(ctx.dim, rank * ctx.n, ctx.n), None, None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return C.all_gather(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return (C.reduce_scatter(g.float(), ctx.group, 1).to(g.dtype),
                None)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return C.ring_shift(x, group)

    @staticmethod
    def backward(ctx, g):
        return C.ring_shift(g, ctx.group, -1), None


class _FromLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return C.from_last(x, group)

    @staticmethod
    def backward(ctx, g):
        last = C.group_size(ctx.group) - 1
        if torch.distributed.get_rank(ctx.group) != last:
            return torch.zeros_like(g), None
        return g, None


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        ctx.like = (y.shape, y.dtype, y.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        return g, torch.zeros(shape, dtype=dtype, device=device)


def ring_shift(x, group):
    """x to the next stage of the pp ring; → the previous stage's x."""
    return x if group is None else _RingShift.apply(x, group)


def from_last(x, group):
    """The last pp stage's x on every stage."""
    return x if group is None else _FromLast.apply(x, group)


def tie(x, y):
    """x, with y in the graph at a zero gradient."""
    return _Tie.apply(x, y)


def copy_to(x, group):
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x, group):
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x, group, dim: int = -1):
    return x if group is None else _GatherFrom.apply(x, group,
                                                     dim % x.dim())


def seq_gather(x, group):
    """(B, S/sp, ...) local rows → (B, S, ...) over the sp group."""
    return x if group is None else _SeqGather.apply(x, group)


class TensorSplit:
    """How a bf16 Linear runs split over a tp group: 'col' (output
    features), 'row' (input features: the partial products are summed by
    `reduce_from`), 'vocab' (the head: a column split whose logits are
    gathered)."""

    def __init__(self, mode: str, group):
        self.mode, self.group = mode, group

    def linear(self, x, w):
        out = F.linear(x, w)
        if self.mode == "row":
            return reduce_from(out, self.group)
        if self.mode == "vocab":
            return gather_from(out, self.group, -1)
        return out


# Linear name suffix -> its split mode (core/mesh.py `_TP_RULES`)
_MODES = {"wq": "col", "wk": "col", "wv": "col", "wo": "row", "w1": "col",
          "w3": "col", "w2": "row", "output": "vocab"}


@torch.no_grad()
def parallelize(model, mesh: Mesh):
    """Keep this rank's piece of every leaf of the full `model`, free the
    frozen leaves of other pipeline stages, and mark what runs split;
    → model. Leaf by leaf: each full tensor is replaced by its piece before
    the next is cut, so no rank holds two full copies. An attention splits
    when its heads divide by tp; an FFN when its hidden dim does; the head
    and the embedding when theirs do. Sets `model.mesh`, which the
    pipeline, the sequence cut (sp), the losses and the train step read."""
    from .llama import Attention, Embedding, FeedForward, Linear

    model.mesh = mesh
    full = {}
    for name, p in list(model.named_parameters()):
        full[name] = model.dropped.get(name, tuple(p.shape))
        if name in model.dropped:
            continue
        if not keeps_leaf(name, mesh, model.cfg.n_layers):
            model.dropped[name] = tuple(p.shape)
            p.data = p.data.new_empty(0)
            continue
        piece = shard_leaf(name, p.data, mesh)
        if piece is not p.data:
            p.data = piece
    tp = mesh.size(TP_AXIS)
    group = mesh.group(TP_AXIS)
    if tp == 1:
        return model
    split = lambda w: (w not in model.dropped
                       and split_dim(w, full[w], mesh) is not None)
    modules = dict(model.named_modules())
    for name, mod in modules.items():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(mod, Linear) and not mod.quantized \
                and leaf in _MODES and split(f"{name}.weight"):
            mod.tp = TensorSplit(_MODES[leaf], group)
        elif isinstance(mod, Embedding) and leaf == "tok_embeddings" \
                and split(f"{name}.weight"):
            mod.tp_group = group
    for mod in modules.values():
        if isinstance(mod, Attention) and mod.wq.tp is not None:
            if model.cfg.n_heads % tp:
                raise ValueError(f"{model.cfg.n_heads} heads do not divide "
                                 f"over tp {tp}")
            mod.split_heads(tp, mesh.index(TP_AXIS), group)
        elif isinstance(mod, FeedForward) and mod.w1.tp is not None:
            mod.tp_group = group
    return model


def materialize(model, device, mesh=None):
    """Allocate, uninitialised on `device`, the parameters of a `model`
    built on the meta device: every leaf this rank keeps under `mesh`
    (`core.mesh.keeps_leaf`) at its full shape, the others empty, their
    full shapes in `model.dropped`; → model."""
    for mod_name, mod in list(model.named_modules()):
        for leaf, p in list(mod.named_parameters(recurse=False)):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            held = mesh is None or keeps_leaf(name, mesh, model.cfg.n_layers)
            if not held:
                model.dropped[name] = tuple(p.shape)
            setattr(mod, leaf, nn.Parameter(
                torch.empty(p.shape if held else (0,), dtype=p.dtype,
                            device=device), requires_grad=p.requires_grad))
    return model


def tp_partial_parameters(model):
    """The trainables each tp rank uses in part, whose gradients the step
    sums over tp: the gates of a head-split attention (every other
    trainable reaches the split layers through `copy_to` and arrives
    whole)."""
    from .llama import Attention

    out = []
    for mod in model.modules():
        if isinstance(mod, Attention) and mod.tp_group is not None:
            out += [mod.gate1, mod.gate2]
    return out
