"""Adapter-only training checkpoints (JAX: flipped_tpu/ckpt/manager.py).

Only the trainables (adapter, gates, temporal_emb, visual_proj and, under
an audio merge, audio_proj and video_audio_cross_attn: ~4.6M parameters at
7B without audio) and the optimizer's state are written, never the frozen
backbone, which a resumed or evaluated run loads from the base checkpoint
again (reference: util/misc.py:297-336). Layout under `output_dir`:

    <name>/state.pt     {'trainable': {name: tensor}, 'optimizer':
                         Optimizer.state_dict(), 'meta': {...}}, CPU tensors
    <name>.meta.json    {"epoch": N, "best_acc": x}, beside the directory

Each file is written under a temporary name and moved into place with
`os.replace`, so a save cut short leaves the previous checkpoint whole.
The meta also travels inside state.pt, which `restore` reads, so the two
can never be of different saves.

Under torch.distributed the trainables are replicated on every rank
(model/parallel.py splits frozen leaves only): rank 0 writes the
checkpoint, every rank waits for it at a barrier, and every rank
restores it.
"""
from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING, Dict, Optional

import torch

from ..core.collectives import barrier
from ..core.distributed import get_rank

if TYPE_CHECKING:
    from ..train.optim import Optimizer

STATE_FILE = "state.pt"


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def _replace(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Adapter-only train-state checkpoints (best, and the rolling last)."""

    def __init__(self, output_dir: str):
        self.output_dir = os.path.abspath(output_dir)

    def path(self, name: str) -> str:
        return os.path.join(self.output_dir, name)

    def exists(self, name: str) -> bool:
        return os.path.isfile(os.path.join(self.path(name), STATE_FILE))

    def save(self, name: str, model: torch.nn.Module, optimizer: Optimizer,
             epoch: int, best_acc: float = 0.0) -> None:
        """Write the trainables of `model` and the state of `optimizer`,
        moved to the CPU first, so a checkpoint written on the card loads
        on a machine without one; rank 0 writes, every rank returns once
        it is written."""
        if get_rank() != 0:
            barrier()
            return
        meta = {"epoch": int(epoch), "best_acc": float(best_acc)}
        state = {"trainable": {n: _to_cpu(p) for n, p in
                               model.named_parameters() if p.requires_grad},
                 "optimizer": _to_cpu(optimizer.state_dict()),
                 "meta": meta}
        path = self.path(name)
        os.makedirs(path, exist_ok=True)
        _replace(os.path.join(path, STATE_FILE),
                 lambda tmp: torch.save(state, tmp))

        def write_meta(tmp):
            with open(tmp, "w") as f:
                json.dump(meta, f)
        _replace(path + ".meta.json", write_meta)
        barrier()

    @torch.no_grad()
    def restore(self, name: str, model: torch.nn.Module,
                optimizer: Optional[Optimizer] = None) -> Dict:
        """Copy the saved trainables into `model` (and the optimizer state
        into `optimizer`, when given); → the meta {'epoch', 'best_acc'}.
        Strict: a trainable of the model missing from the checkpoint, or a
        saved one the model lacks, raises."""
        state = torch.load(os.path.join(self.path(name), STATE_FILE),
                           map_location="cpu", weights_only=True)
        params = {n: p for n, p in model.named_parameters()
                  if p.requires_grad}
        saved = state["trainable"]
        missing = sorted(set(params) - set(saved))
        extra = sorted(set(saved) - set(params))
        if missing or extra:
            raise KeyError(f"checkpoint {name}: trainables missing "
                           f"{missing}, unexpected {extra}")
        for n, p in params.items():
            if saved[n].shape != p.shape:
                raise ValueError(f"checkpoint {name}: {n} is "
                                 f"{tuple(saved[n].shape)}, the model's "
                                 f"{tuple(p.shape)}")
            p.copy_(saved[n])
        if optimizer is not None:
            optimizer.load_state_dict(state["optimizer"])
        return state["meta"]
