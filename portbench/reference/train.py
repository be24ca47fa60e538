"""The reference's training steps: the three flipped objectives' losses,
their gradients in float32 by autograd, and AdamW by hand.

Each microbatch runs in blocks of `rows` examples (each loss divided by
the whole microbatch's count of labelled tokens, so that the blocks' sums
are the microbatch's means), the gradients summed over the microbatches
and divided by their number, then one AdamW update: betas (0.9, 0.95),
eps 1e-8, weight decay on the gates and on every 2-D trainable, the lr of
a linear warmup over `warmup_epochs` then a half cosine, the first update
at lr 0 (Flipped-VQA's `util/lr_sched.py`).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from .model import Reference, token_ce

BETAS = (0.9, 0.95)
ADAM_EPS = 1e-8


def lr_at(t: dict, count: int) -> float:
    """The lr of update `count` (0-based) of the traffic's schedule."""
    base = t["blr"] * t["batch_size"] * t["accum_iter"] / 256.0
    epoch = count * t["accum_iter"] / t["steps_per_epoch"]
    if epoch < t["warmup_epochs"]:
        return base * epoch / t["warmup_epochs"]
    progress = (epoch - t["warmup_epochs"]) / max(
        t["epochs"] - t["warmup_epochs"], 1e-8)
    return base * 0.5 * (1.0 + math.cos(math.pi * progress))


def decays(name: str, p: torch.Tensor) -> bool:
    return "gate" in name.rsplit(".", 1)[-1] or p.dim() > 1


def objectives(t: dict) -> List[str]:
    return ["vqa"] + (["vaq"] if t["vaq"] else []) + (["qav"] if t["qav"]
                                                     else [])


def _last_label(labels: torch.Tensor, ignore: int) -> torch.Tensor:
    """The last position of any row that holds a label."""
    pos = torch.arange(labels.shape[1], device=labels.device)
    return torch.where(labels != ignore, pos, torch.zeros_like(pos)).max()


def micro_step(ref: Reference, micro: Dict[str, torch.Tensor], t: dict,
               rows: int) -> Dict[str, float]:
    """Backpropagate one microbatch's total loss into the trainables'
    .grad (summed onto what is there); → its losses by objective."""
    keys = objectives(t)
    lm = [k for k in keys if k != "qav"]
    counts = {k: (micro[f"{k}_labels"][:, 1:] != 0).sum().clamp_min(1)
              for k in lm}
    if "qav" in keys:
        counts["qav"] = (micro["qav_labels"][:, 1:] != -1).sum().clamp_min(1)
    losses = {k: 0.0 for k in ("vqa", "vaq", "qav")}
    b = micro["vqa_tokens"].shape[0]
    for start in range(0, b, rows):
        sl = slice(start, min(start + rows, b))
        # positions past the last label change no loss (the attention is
        # causal): the block runs up to its last labelled position
        end = 1 + max(int(_last_label(micro[f"{k}_labels"][sl],
                                      -1 if k == "qav" else 0))
                      for k in keys)
        vf = ref.fuse(micro["video"][sl])
        n = vf.shape[0]
        h = ref.encode(
            torch.cat([micro[f"{k}_tokens"][sl, :end] for k in keys]),
            vf.repeat(len(keys), 1, 1),
            torch.cat([micro[f"{k}_video_start"][sl] for k in keys]),
            torch.cat([micro[f"{k}_splice"][sl] for k in keys]))
        total = 0.0
        for j, k in enumerate(keys):
            hk = h[j * n:(j + 1) * n, :-1]
            labels = micro[f"{k}_labels"][sl, 1:end]
            if k == "qav":
                logits = (torch.einsum("bsd,bfd->bsf", hk, vf)
                          / ref.meth["tau"])
                ce = token_ce(logits, labels, -1).sum() / counts[k]
            else:
                ce = token_ce(ref.logits(hk), labels, 0).sum() / counts[k]
            total = total + ce
            losses[k] += float(ce.detach())
        total.backward()
    return losses


def follow(ref: Reference, batches: List[Dict[str, torch.Tensor]], t: dict,
           steps: int, rows: int = 4) -> Dict:
    """Follow the first `steps` updates on `batches` (leaves (accum, B,
    ...)) → {'losses': [{objective: mean over microbatches}], 'grad1':
    {leaf: norm of the first update's gradient}, 'change': {leaf: norm of
    the change after `steps` updates}}."""
    params = ref.train
    start = {k: p.detach().clone() for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    out = {"losses": []}
    for step in range(steps):
        for p in params.values():
            p.grad = None
        batch = batches[step]
        accum = batch["vqa_tokens"].shape[0]
        mean = {k: 0.0 for k in ("vqa", "vaq", "qav")}
        for a in range(accum):
            got = micro_step(ref, {k: x[a] for k, x in batch.items()}, t,
                             rows)
            for k in mean:
                mean[k] += got[k] / accum
        out["losses"].append(mean)
        with torch.no_grad():
            grads = {k: p.grad / accum for k, p in params.items()}
            if step == 0:
                out["grad1"] = {k: float(torch.linalg.vector_norm(g))
                                for k, g in grads.items()}
            lr = lr_at(t, step)
            bc1 = 1 - BETAS[0] ** (step + 1)
            bc2 = 1 - BETAS[1] ** (step + 1)
            for k, p in params.items():
                if decays(k, p):
                    p.mul_(1 - lr * t["weight_decay"])
                m[k].lerp_(grads[k], 1 - BETAS[0])
                v[k].mul_(BETAS[1]).addcmul_(grads[k], grads[k],
                                             value=1 - BETAS[1])
                denom = (v[k].sqrt() / math.sqrt(bc2)).add_(ADAM_EPS)
                p.addcdiv_(m[k], denom, value=-lr / bc1)
    out["change"] = {k: float(torch.linalg.vector_norm(p.detach() - start[k]))
                     for k, p in params.items()}
    return out
