"""Partial freeze, AdamW with weight-decay masking, warmup-cosine schedule
(JAX: flipped_tpu/train/optim.py).

- Trainables by parameter name: gates, adapter, temporal_emb, visual_proj
  and the audio merges' audio_proj and video_audio_cross_attn train in
  f32; the rest stays frozen with requires_grad=False (reference:
  llama_vqa.py:71-77, whose name filter left the audio modules frozen at
  their init, the fork's bug that JAX optim.py:6-7 fixes).
- AdamW betas (0.9, 0.95), eps 1e-8, in two groups: timm-style no decay on
  1-D parameters (the cross-attention's biases among them), except the
  gates, which DO decay (the reference stores them 4-D; JAX
  optim.py:121-139).
- The lr is set before each update from `lr_schedule(count)`, count being
  the number of updates before this one, so the first update has lr 0
  (reference: util/lr_sched.py:9-21). Optional global-norm clipping is
  optax's `clip_by_global_norm`: grads scale by clip / norm when the norm
  is at least `clip`.
- `Optimizer.state_dict()` keys AdamW's state by parameter name, with the
  update count that drives the schedule, so a resumed run continues the
  schedule (ckpt/manager.py).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from ..core.config import TrainConfig

TRAINABLE_MARKERS = ("gate", "adapter", "temporal_emb", "visual_proj",
                     "audio_proj", "video_audio_cross_attn")


def is_trainable(name: str) -> bool:
    return any(m in name for m in TRAINABLE_MARKERS)


def trainable_parameters(model) -> List[Tuple[str, torch.nn.Parameter]]:
    """Set requires_grad by `is_trainable` on every parameter of `model`;
    → the trainable (name, parameter) pairs."""
    out = []
    for name, p in model.named_parameters():
        p.requires_grad_(is_trainable(name))
        if p.requires_grad:
            out.append((name, p))
    return out


def wd_mask(name: str, p: torch.Tensor) -> bool:
    """The weight-decay mask (JAX `wd_mask`): gates decay, other 1-D
    parameters do not."""
    return "gate" in name.rsplit(".", 1)[-1] or p.dim() > 1


def lr_schedule(cfg: TrainConfig, steps_per_epoch: int, world_batch: int):
    """lr(update_idx): fractional-epoch linear warmup, then a half-cycle
    cosine to min_lr; the epoch advances by accum_iter data steps per
    update (JAX: optim.py:104-118)."""
    base_lr = cfg.absolute_lr(world_batch)

    def schedule(count: int) -> float:
        epoch = count * cfg.accum_iter / steps_per_epoch
        if epoch < cfg.warmup_epochs:
            return base_lr * epoch / cfg.warmup_epochs
        progress = (epoch - cfg.warmup_epochs) / max(
            cfg.epochs - cfg.warmup_epochs, 1e-8)
        return cfg.min_lr + (base_lr - cfg.min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * progress))

    return schedule


class Optimizer:
    """AdamW over the model's trainables with the schedule and clipping of
    the JAX `make_optimizer` chain. `step(grad_norm)` applies one update
    from the gradients in `.grad` and returns the lr it used."""

    def __init__(self, model, cfg: TrainConfig, steps_per_epoch: int,
                 world_batch: int):
        named = trainable_parameters(model)
        self.named = dict(named)
        self.params = [p for _, p in named]
        groups = [
            {"params": [p for n, p in named if wd_mask(n, p)],
             "weight_decay": cfg.weight_decay},
            {"params": [p for n, p in named if not wd_mask(n, p)],
             "weight_decay": 0.0}]
        self.adamw = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=0.0, betas=(0.9, 0.95),
            eps=1e-8)
        self.schedule = lr_schedule(cfg, steps_per_epoch, world_batch)
        self.clip_grad = cfg.clip_grad
        self.count = 0

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, grad_norm: torch.Tensor) -> float:
        if self.clip_grad:
            scale = torch.where(grad_norm < self.clip_grad,
                                torch.ones_like(grad_norm),
                                self.clip_grad / grad_norm)
            for p in self.params:
                p.grad.mul_(scale)
        lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1
        return lr

    def state_dict(self) -> Dict:
        """{'count': updates so far, 'params': {name: AdamW's state of that
        trainable (exp_avg, exp_avg_sq, step)}}; a trainable that has not
        been updated yet has no entry. The tensors are the live ones."""
        return {"count": self.count,
                "params": {n: dict(self.adamw.state[p])
                           for n, p in self.named.items()
                           if p in self.adamw.state}}

    def load_state_dict(self, state: Dict) -> None:
        """Restore `state_dict()`'s output, each moment onto its
        parameter's device; a name that is not a trainable of the model
        raises."""
        extra = sorted(set(state["params"]) - set(self.named))
        if extra:
            raise KeyError(f"optimizer state for unknown trainables {extra}")
        self.count = int(state["count"])
        self.adamw.state.clear()
        for name, st in state["params"].items():
            p = self.named[name]
            self.adamw.state[p] = {
                k: (v.to(p.device) if k != "step" else v.to(torch.float32))
                for k, v in st.items()}


def make_optimizer(model, cfg: TrainConfig, steps_per_epoch: int,
                   world_batch: int) -> Optimizer:
    """(JAX: optim.py:142-149)"""
    return Optimizer(model, cfg, steps_per_epoch, world_batch)
