"""The reference's answers for the eval and generation traffic, each by
full forward passes in float32: an option's score is the mean CE of its
labelled tokens over a whole-sequence forward (no prompt cache); a
generated row is read by one forward over its prompt and the tokens
served, the logits at each served position.
"""
from __future__ import annotations

from typing import Dict

import torch

from .model import Reference, token_ce


def option_scores(ref: Reference, batch: Dict[str, torch.Tensor],
                  rows: int = 40) -> torch.Tensor:
    """(B, n_opt) mean token CE of each option (ignore index 0), over
    the tokens whose loss is not zero, as the port's scorers divide."""
    tokens, labels = batch["vqa_tokens"], batch["vqa_labels"]
    b, n_opt, s = tokens.shape
    vf = ref.fuse(batch["video"]).repeat_interleave(n_opt, 0)
    vs = batch["vqa_video_start"].repeat_interleave(n_opt, 0)
    splice = batch["vqa_splice"].repeat_interleave(n_opt, 0)
    flat_t, flat_l = tokens.reshape(b * n_opt, s), labels.reshape(b * n_opt, s)
    out = []
    for a in range(0, b * n_opt, rows):
        sl = slice(a, a + rows)
        h = ref.encode(flat_t[sl], vf[sl], vs[sl], splice[sl])[:, :-1]
        lab = flat_l[sl, 1:]
        keep = (lab != 0).any(0)             # score only labelled columns
        losses = token_ce(ref.logits(h[:, keep]), lab[:, keep], 0)
        out.append(losses.sum(-1) / (losses != 0).sum(-1).clamp_min(1))
    return torch.cat(out).view(b, n_opt)


def served_logits(ref: Reference, prompt: Dict[str, torch.Tensor],
                  served: torch.Tensor) -> torch.Tensor:
    """The reference's logits (T, V) at each served position of one row."""
    pre = int(prompt["prefix"])
    seq = torch.cat([prompt["tokens"][:pre], served[:-1]])[None]
    vf = ref.fuse(prompt["video"][None])
    h = ref.encode(seq, vf, prompt["video_start"][None], prompt["splice"][None])
    return ref.logits(h[0, pre - 1:])
