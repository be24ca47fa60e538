"""w8a8 matmuls of the frozen backbone as autograd Functions
(JAX: flipped_tpu/model/int8.py).

- `int8_matmul`: the per-channel w8a8 forward through K3
  (`kernels.quant_matmul.int8_fwd`); the backward is the exact bf16 dx on
  the dequantized weight, g·(bf16(kq)·bf16(scale)), straight through the
  activation rounding (int8.py:95-130). JAX computes that product outside
  Pallas, so it stays a plain matmul here.
- `int8_matmul_grouped`: the grouped forward through K7
  (`grouped_matmul`), the backward through K4 (`quant_dx`)
  (int8.py:247-269, 384-411, 473).

Both take kq in the port's (N, K) layout and return no gradient for the
frozen kq and scales. On a CPU tensor every call takes the kernels' plain
versions. `quantize_act` is the JAX `_quantize_act`; `outlier_count` sizes
the outlier modes' passthrough, for the Linear and the checkpoint tooling.
"""
from __future__ import annotations

import torch

from .kernels.quant_matmul import (dequant, grouped_matmul, int8_fwd,
                                   quant_dx, quantize_act)

__all__ = ["quantize_act", "outlier_count", "int8_matmul",
           "int8_matmul_grouped", "Int8Matmul", "Int8MatmulGrouped"]


def outlier_count(k_dim: int) -> int:
    """bf16 passthrough rows for --quantize int8o|w8a8o: 8 per 1024 input
    dims, at least 8 (JAX: ckpt/quantize.py:24-32)."""
    return max(8, (k_dim // 1024) * 8)


class Int8Matmul(torch.autograd.Function):
    """x (..., K) float; kq (N, K) int8; scale (N,) f32 → (..., N) x.dtype."""

    @staticmethod
    def forward(ctx, x, kq, scale):
        ctx.save_for_backward(kq, scale)
        return int8_fwd(x.contiguous(), kq, scale)

    @staticmethod
    def backward(ctx, g):
        kq, scale = ctx.saved_tensors
        dx = g.to(torch.bfloat16) @ dequant(kq, scale, torch.bfloat16)
        return dx.to(g.dtype), None, None


class Int8MatmulGrouped(torch.autograd.Function):
    """x (..., K) float; kq (N, K) int8; scale_g (G, N) f32 → (..., N)."""

    @staticmethod
    def forward(ctx, x, kq, scale_g):
        ctx.save_for_backward(kq, scale_g)
        return grouped_matmul(x.contiguous(), kq, scale_g)

    @staticmethod
    def backward(ctx, g):
        kq, scale_g = ctx.saved_tensors
        return quant_dx(g.contiguous(), kq, scale_g), None, None


def int8_matmul(x, kq, scale):
    return Int8Matmul.apply(x, kq, scale)


def int8_matmul_grouped(x, kq, scale_g):
    return Int8MatmulGrouped.apply(x, kq, scale_g)
