"""The rank grid and the tensor-parallel split table (JAX:
flipped_tpu/core/mesh.py).

JAX builds one `jax.sharding.Mesh` over its devices and lets GSPMD insert
the collectives. The port runs one process a rank and spells the same
layout out: `make_mesh` lays the ranks on a (dp, pp, sp, tp) grid, row-major
with tp innermost, exactly as JAX reshapes `devices[:dp*pp*sp*tp]`, and
makes one torch.distributed process group per axis line, plus the dp×sp
group over which the loss counts are summed and the dp×pp×sp group over
which the trainables' gradients are (train/step.py).

Axes:
  dp — data parallel: each dp row reads its own loader shard
       (`loader_shards`) and the gradients are summed over it.
  pp — pipeline stages: stage s runs blocks [s·L/pp, (s+1)·L/pp)
       (`stage_layers`, where JAX's P('pp') on the stacked layer axis puts
       them) in a GPipe schedule (model/pipeline.py). A rank keeps the
       frozen leaves of its own stage's blocks only, and every trainable
       (`keeps_leaf`), so a checkpoint is the same at any pp.
  sp — sequence parallel: the residual stream keeps S/sp rows a rank
       (model/llama.py); attention all-gathers K/V over the axis
       (model/kernels/flash_attention.py `sp_flash_adapter_attention`).
  tp — tensor parallel: Megatron's split of the attention heads and the
       SwiGLU hidden dim by the reference checkpoint's column/row table
       (`param_pspec`, model/parallel.py).

`mesh_is_multi_device` and `manual_axes` are TPU-only machinery (shard_map
nesting) and have no counterpart here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .config import MeshConfig, is_trainable

DP_AXIS = "dp"
PP_AXIS = "pp"
SP_AXIS = "sp"
TP_AXIS = "tp"
AXES = (DP_AXIS, PP_AXIS, SP_AXIS, TP_AXIS)
# the slices of the grid that have groups besides the axis lines: dp×sp,
# that of the loss counts and metrics (train/objectives.py, train/step.py),
# and the ranks of one tp index, that of the trainables' gradient sum
DPSP = "dpsp"
GRADS = "grads"
_SLICES = {DPSP: (DP_AXIS, SP_AXIS), GRADS: (DP_AXIS, PP_AXIS, SP_AXIS)}


class Mesh:
    """This rank's place on the grid and its process groups.

    `ranks` is the (dp, pp, sp, tp) array of global ranks; `shape` maps
    each axis to its size, `coords` to this rank's index on it;
    `group(axis)` is the process group of this rank's line along `axis`
    (None where the axis has one rank or no group was made), and
    `group(DPSP)` and `group(GRADS)` those of its dp×sp and dp×pp×sp
    slices."""

    def __init__(self, ranks: np.ndarray, rank: int,
                 groups: Optional[Dict[str, object]] = None):
        self.ranks = ranks
        self.rank = rank
        self.shape = dict(zip(AXES, ranks.shape))
        where = np.argwhere(ranks == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not on the mesh")
        self.coords = dict(zip(AXES, (int(c) for c in where[0])))
        self._groups = groups or {}

    def size(self, axis: str) -> int:
        if axis in _SLICES:
            return int(np.prod([self.shape[a] for a in _SLICES[axis]]))
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self._groups.get(axis) if self.size(axis) > 1 else None

    @property
    def is_parallel(self) -> bool:
        return self.ranks.size > 1


def mesh_shape(cfg: MeshConfig, n: int) -> Tuple[int, int, int, int]:
    """(dp, pp, sp, tp) for `n` ranks: dp -1 takes every rank the model
    axes leave (JAX: mesh.py:37-52). Raises ValueError when the grid needs
    more ranks than there are, or leaves some without a place (one process
    is one rank here, so a rank off the grid would have nothing to do)."""
    tp, sp, pp = max(1, cfg.tp), max(1, cfg.sp), max(1, cfg.pp)
    dp = cfg.dp if cfg.dp > 0 else n // (pp * tp * sp)
    if dp < 1 or dp * pp * sp * tp > n:
        raise ValueError(f"mesh {max(dp, 1)}x{pp}x{sp}x{tp} > {n} ranks")
    if dp * pp * sp * tp < n:
        raise ValueError(f"mesh {dp}x{pp}x{sp}x{tp} < {n} ranks: every "
                         f"rank must have a place on the grid")
    return dp, pp, sp, tp


def rank_grid(cfg: MeshConfig, n: int) -> np.ndarray:
    """The (dp, pp, sp, tp) array of ranks, row-major, tp innermost."""
    return np.arange(n).reshape(mesh_shape(cfg, n))


def _lines(ranks: np.ndarray, axis: int):
    """Every line of `ranks` along `axis`, in row-major order of the
    other axes."""
    moved = np.moveaxis(ranks, axis, -1)
    return [list(map(int, line)) for line in moved.reshape(-1,
                                                           moved.shape[-1])]


def make_mesh(cfg: Optional[MeshConfig] = None, world_size: Optional[int] =
              None, rank: Optional[int] = None) -> Mesh:
    """The grid over this run's ranks (torch.distributed's world, else one
    rank) and, in a process group, its groups. Every rank makes every
    group in the same order, as torch.distributed requires: each axis's
    lines in row-major order, then the dp×sp slices, then the dp×pp×sp
    ones (the dp×sp group again when pp is 1)."""
    cfg = cfg or MeshConfig()
    joined = dist.is_initialized()
    n = world_size if world_size is not None else (
        dist.get_world_size() if joined else 1)
    rank = rank if rank is not None else (dist.get_rank() if joined else 0)
    ranks = rank_grid(cfg, n)
    groups = {}
    if joined and n > 1:
        for a, axis in enumerate(AXES):
            if ranks.shape[a] == 1:
                continue
            for line in _lines(ranks, a):
                g = dist.new_group(line)
                if rank in line:
                    groups[axis] = g
        for name, axes in _SLICES.items():
            axes = [AXES.index(a) for a in axes]
            if name == GRADS and ranks.shape[1] == 1:
                if DPSP in groups:
                    groups[GRADS] = groups[DPSP]
                continue
            rest = [a for a in range(len(AXES)) if a not in axes]
            moved = np.moveaxis(ranks, rest + axes, range(len(AXES)))
            width = int(np.prod([ranks.shape[a] for a in axes]))
            if width == 1:
                continue
            for line in moved.reshape(-1, width):
                line = sorted(map(int, line))
                g = dist.new_group(line)
                if rank in line:
                    groups[name] = g
    return Mesh(ranks, rank, groups)


def stage_layers(mesh: Mesh, n_layers: int) -> range:
    """The blocks of this rank's pipeline stage: [s·L/pp, (s+1)·L/pp), the
    layers JAX's P('pp') on the stacked (n_layers, ...) axis puts on
    stage s (flipped_tpu/core/mesh.py:157-164)."""
    per = n_layers // mesh.size(PP_AXIS)
    s = mesh.index(PP_AXIS)
    return range(s * per, (s + 1) * per)


def keeps_leaf(name: str, mesh: Mesh, n_layers: int) -> bool:
    """Whether this rank holds state-dict leaf `name`: every trainable
    (the adapter rows and gates of all stages included, ~4.6M parameters
    at 7B, so that the optimizer and the checkpoints are those of one
    rank), and of the frozen leaves all but those of another stage's
    blocks (`layers.N.*`). JAX stores the stages' leaves stacked instead,
    its trainables too (a divergence, ROADMAP Queue 3)."""
    if is_trainable(name) or mesh.size(PP_AXIS) == 1 or not name.startswith(
            "layers."):
        return True
    return int(name.split(".")[1]) in stage_layers(mesh, n_layers)


def loader_shards(mesh: Mesh) -> tuple:
    """(shard_index, shard_count) of the data loader for this rank (JAX:
    mesh.py:55-89, one device a process): the pp·sp·tp ranks of one dp
    row read the same rows."""
    group = mesh.size(PP_AXIS) * mesh.size(SP_AXIS) * mesh.size(TP_AXIS)
    return mesh.rank // group, mesh.ranks.size // group


# --- the tensor-parallel split table -----------------------------------------
# Keyed on state-dict name suffixes, in the port's torch layout (a Linear's
# weight is (out, in)): column-parallel weights (wq/wk/wv/w1/w3, output) split
# their output features, dim 0; row-parallel ones (wo/w2) their input
# features, dim 1; tok_embeddings (vocab, dim) its embedding dim. JAX's rules
# (mesh.py:142-155) name the same splits on Flax's transposed (in, out)
# kernels. Everything else replicates, the quantized leaves (kernel_q,
# kernel_q4, scale, ...) among them, as in JAX (int8.py:272-300).
_TP_RULES = (
    ("attention.wq.weight", (TP_AXIS, None)),
    ("attention.wk.weight", (TP_AXIS, None)),
    ("attention.wv.weight", (TP_AXIS, None)),
    ("attention.wo.weight", (None, TP_AXIS)),
    ("feed_forward.w1.weight", (TP_AXIS, None)),
    ("feed_forward.w3.weight", (TP_AXIS, None)),
    ("feed_forward.w2.weight", (None, TP_AXIS)),
    ("output.weight", (TP_AXIS, None)),
    ("tok_embeddings.weight", (None, TP_AXIS)),
)


def param_pspec(name: str) -> tuple:
    """The split of state-dict leaf `name`: one mesh axis or None per dim,
    () for a replicated leaf."""
    for suffix, spec in _TP_RULES:
        if name == suffix or name.endswith("." + suffix):
            return spec
    return ()


def split_dim(name: str, shape, mesh: Mesh) -> Optional[int]:
    """The dim of `name` that this mesh splits, or None: a split whose
    axis has one rank, or that does not divide its dim, is dropped (JAX
    `param_shardings`, mesh.py:183-200)."""
    for dim, axis in enumerate(param_pspec(name)):
        if axis is not None and mesh.size(axis) > 1 \
                and shape[dim] % mesh.size(axis) == 0:
            return dim
    return None


def shard_leaf(name: str, t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's piece of the full leaf `name`, a copy of its own (so
    that the full tensor can be freed), or `t` itself where it
    replicates."""
    dim = split_dim(name, t.shape, mesh)
    if dim is None:
        return t
    n = mesh.size(TP_AXIS)
    return t.chunk(n, dim=dim)[mesh.index(TP_AXIS)].clone()

