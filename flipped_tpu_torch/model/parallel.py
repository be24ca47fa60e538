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

`parallelize(model, mesh)` cuts a full model to this rank's pieces, leaf by
leaf (`core.mesh.shard_leaf`), and marks the modules that run split: the
bf16 `Linear`s of the split table (wq/wk/wv/w1/w3 by output, wo/w2 by
input, the head by vocabulary), the embedding, and the attention heads
(an Attention runs H/tp heads when its four projections split). Quantized
leaves replicate under tp, as in JAX (int8.py:272-300): a quantized block
runs K3/K7/K8 forward and K4/K9/K10 backward on the full weights with no
collective, redundantly within its tp group.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import collectives as C
from ..core.mesh import TP_AXIS, Mesh, shard_leaf


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
    """Keep this rank's piece of every leaf of the full `model` and mark
    what runs split; → model. Leaf by leaf: each full tensor is replaced
    by its piece before the next is cut, so no rank holds two full copies.
    An attention splits when its heads divide by tp; an FFN when its
    hidden dim does; the head and the embedding when theirs do. Sets
    `model.mesh`, which the sequence cut (sp), the losses and the train
    step read."""
    from .llama import Attention, Embedding, FeedForward, Linear

    model.mesh = mesh
    tp = mesh.size(TP_AXIS)
    group = mesh.group(TP_AXIS)
    if tp == 1:
        return model
    for name, p in list(model.named_parameters()):
        piece = shard_leaf(name, p.data, mesh)
        if piece is not p.data:
            p.data = piece
    modules = dict(model.named_modules())
    for name, mod in modules.items():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(mod, Linear) and not mod.quantized \
                and leaf in _MODES and _is_split(mod, leaf, model.cfg):
            mod.tp = TensorSplit(_MODES[leaf], group)
        elif isinstance(mod, Embedding) and leaf == "tok_embeddings" \
                and mod.weight.shape[1] != model.cfg.dim:
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


def _is_split(mod, leaf: str, cfg) -> bool:
    """Whether the Linear `leaf` holds a piece of its full weight."""
    full_out = {"wq": cfg.dim, "wk": cfg.dim, "wv": cfg.dim,
                "w1": cfg.ffn_hidden, "w3": cfg.ffn_hidden,
                "output": cfg.vocab_size}
    full_in = {"wo": cfg.dim, "w2": cfg.ffn_hidden}
    if leaf in full_out:
        return mod.weight.shape[0] != full_out[leaf]
    return mod.weight.shape[1] != full_in[leaf]


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
