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
- `int8_matmul_dgrad` (--quantize w8a8d, w8a8rd): the K3 forward, and a
  backward through K10 (`int8_dgrad`) that runs dx on the int8 rate too:
  the cotangent times the weight scale, stochastically rounded per row
  (int8.py:133-223). JAX's own default there is the XLA formulation
  `_dgrad_dx_xla`, which K10's plain version is, bit for bit.

Both take kq in the port's (N, K) layout and return no gradient for the
frozen kq and scales. On a CPU tensor every call takes the kernels' plain
versions. `quantize_act` is the JAX `_quantize_act`; `stochastic_round` the
JAX `stochastic_round`; `outlier_count` sizes the outlier modes'
passthrough, for the Linear and the checkpoint tooling.
"""
from __future__ import annotations

import torch

from .kernels.quant_matmul import (dequant, grouped_matmul, int8_dgrad,
                                   int8_fwd, quant_dx, quantize_act, sr_codes)

__all__ = ["quantize_act", "stochastic_round", "outlier_count",
           "int8_matmul", "int8_matmul_grouped", "int8_matmul_dgrad",
           "Int8Matmul", "Int8MatmulGrouped", "Int8MatmulDgrad"]


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


def row_period(t: torch.Tensor) -> int:
    """The period of the dither's row coordinate for a tensor of t's shape:
    JAX's iota over dim -2 is the flattened row modulo t.shape[-2] (no row
    term for a 1-D tensor, which a period of 1 reproduces)."""
    return t.shape[-2] if t.dim() >= 2 else 1


def stochastic_round(x: torch.Tensor) -> torch.Tensor:
    """Round x up with probability frac(x), the dither a murmur hash of the
    value's f32 bits and its (row, col) position, saturated to the int8
    range (JAX: int8.py:154-177 with its `.astype(int8)`), → f32."""
    x32 = x.float()
    n = x32.shape[-1] if x32.dim() else 1
    return sr_codes(x32.reshape(-1, n), row_period(x32)).reshape(x32.shape)


class Int8MatmulDgrad(torch.autograd.Function):
    """x (..., K) float; kq (N, K) int8; scale (N,) f32 → (..., N) x.dtype:
    the K3 forward, the K10 backward."""

    @staticmethod
    def forward(ctx, x, kq, scale):
        ctx.save_for_backward(kq, scale)
        return int8_fwd(x.contiguous(), kq, scale)

    @staticmethod
    def backward(ctx, g):
        kq, scale = ctx.saved_tensors
        dx = int8_dgrad(g.contiguous(), kq, scale, row_period(g))
        return dx, None, None


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


def int8_matmul_dgrad(x, kq, scale):
    return Int8MatmulDgrad.apply(x, kq, scale)
