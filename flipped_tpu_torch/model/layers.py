"""RMSNorm, rotary embeddings, SwiGLU (JAX: flipped_tpu/model/layers.py).

Same math and the same precision islands as the JAX functions: norm
statistics and the rope rotation run in float32, results are cast back to
the input dtype. RoPE rotates INTERLEAVED pairs (x_{2i}, x_{2i+1}), the
reference's complex multiply — not the half-split `rotate_half` convention.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x²) + eps) * weight, statistics in f32, then cast
    back to x.dtype before the weight multiply (JAX: layers.py:15-20)."""
    x32 = x.float()
    normed = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
    return normed.to(x.dtype) * weight.to(x.dtype)


def precompute_rope(head_dim: int, end: int, theta: float = 10000.0,
                    device=None):
    """cos/sin tables of shape (end, head_dim//2), f32."""
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=device) / head_dim))
    t = torch.arange(end, dtype=torch.float32, device=device)
    angles = torch.outer(t, freqs)
    return torch.cos(angles), torch.sin(angles)


def _rope_core(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor):
    x32 = x.float()
    x_pairs = x32.reshape(*x.shape[:-1], -1, 2)
    x0, x1 = x_pairs[..., 0], x_pairs[..., 1]
    out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh); cos/sin: (S, Dh//2) — one shared position table."""
    return _rope_core(x, cos[None, :, None, :].float(),
                      sin[None, :, None, :].float())


def apply_rope_at(x: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor) -> torch.Tensor:
    """x: (B, Q, H, Dh); cos/sin: (B, Q, Dh//2) — a position table per
    example (chunk extend, where each row sits at its own position)."""
    return _rope_core(x, cos[:, :, None, :].float(),
                      sin[:, :, None, :].float())


def swiglu(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
           w3: torch.Tensor) -> torch.Tensor:
    """w2 @ (silu(w1 @ x) * (w3 @ x)); weights are (out, in) as in torch."""
    return F.linear(F.silu(F.linear(x, w1)) * F.linear(x, w3), w2)


def ffn_hidden_size(dim: int, multiple_of: int) -> int:
    hidden = int(2 * (4 * dim) / 3)
    return multiple_of * ((hidden + multiple_of - 1) // multiple_of)
