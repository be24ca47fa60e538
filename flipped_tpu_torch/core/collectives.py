"""The one module through which the port's collectives go: all-reduce,
all-gather and reduce-scatter over a process group of core/mesh.py, and the
small object gathers of the meters and the result merge.

Each call on a group of one rank (or `group` None) returns its input: a
single-rank axis costs nothing. On the nccl backend every call runs on the
card; gloo takes CPU tensors, and the installed torch's gloo also takes
all three tensor collectives on CUDA tensors (the card's ranks of
chip_smoke.py's phase 16 share one card over it).
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
