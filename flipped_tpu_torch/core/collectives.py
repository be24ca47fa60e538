"""The one module through which the port's collectives go: all-reduce,
all-gather and reduce-scatter over a process group of core/mesh.py, the
ring shift of the pipeline's stages, and the small object gathers of the
meters and the result merge.

Each call on a group of one rank (or `group` None) returns its input: a
single-rank axis costs nothing. On the nccl backend every call runs on the
card; gloo takes CPU tensors, and the installed torch's gloo also takes
all three tensor collectives on CUDA tensors (the card's ranks of
chip_smoke.py's phase 16 share one card over it).

`ring_shift` is JAX's ring `lax.ppermute` over the pp axis
(flipped_tpu/model/pipeline.py:270-271): rank i of the group sends to
(i + 1) mod n and receives from (i - 1) mod n, as one
`dist.batch_isend_irecv` (both sides posted at once, so the ring cannot
deadlock). On gloo a CUDA tensor takes the ring as an all-gather over the
group instead, of which each rank keeps its predecessor's piece: gloo's
send of a CUDA tensor aborts the process ("writev ... Bad address", the
installed torch on the H100), while its all-gather takes CUDA tensors.
This is the backend's only path for the case, not a fallback: nothing
falls back quietly, and a failing call raises.
"""
from __future__ import annotations

from typing import Any, List

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_gather0(x, group):
    out = torch.empty((group_size(group) * x.shape[0], *x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _reduce_scatter0(x, group):
    out = torch.empty((x.shape[0] // group_size(group), *x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum `x` over the group, in place; → x."""
    if group_size(group) == 1:
        return x
    if x.is_contiguous():
        dist.all_reduce(x, group=group)
        return x
    y = x.contiguous()
    dist.all_reduce(y, group=group)
    return x.copy_(y)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in group-rank order."""
    if group_size(group) == 1:
        return x
    out = _all_gather0(x.movedim(dim, 0).contiguous(), group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's 1/n slice along `dim` of the group's sum of `x`."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide by {n} ranks")
    out = _reduce_scatter0(x.movedim(dim, 0).contiguous(), group)
    return out.movedim(0, dim)


def ring_shift(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """The tensor of the rank `step` places before this one on the group's
    ring; this rank's `x` goes to the rank `step` places after it
    (`step` -1: the reverse ring, the transpose)."""
    n = group_size(group)
    if n == 1:
        return x
    me = dist.get_rank(group)
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return _all_gather0(x[None], group)[(me - step) % n]
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (me + step) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (me - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def from_last(x: torch.Tensor, group) -> torch.Tensor:
    """The last rank's `x` on every rank of the group: JAX's masked psum
    (pipeline.py:276-280), a sum in f32 of the last rank's `x` and zeros
    elsewhere, exact."""
    n = group_size(group)
    if n == 1:
        return x
    last = dist.get_rank(group) == n - 1
    y = (x.to(torch.float32, memory_format=torch.contiguous_format,
              copy=True) if last else
         torch.zeros(x.shape, dtype=torch.float32, device=x.device))
    return all_reduce(y, group).to(x.dtype)


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's picklable `obj`, in rank order; [obj] in one
    process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
