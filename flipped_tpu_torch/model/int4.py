"""Packed int4 matmuls of the frozen backbone as autograd Functions
(JAX: flipped_tpu/model/int4.py).

Storage is packed along the output features in the split-half layout:
`kernel_q4` (N/2, K) int8, byte [j, k] holding W[j, k] in its low nibble and
W[j + N/2, k] in its high nibble (the JAX (K, N/2) transposed, K-contiguous
like `kernel_q`), with grouped scales (G, N) f32 and codes in [-7, 7].

- `int4_matmul` (--quantize int4, int4r): the weight-only forward through
  K8 (`kernels.quant_matmul.int4_matmul`, act_quant=False).
- `int4_matmul_grouped` (w4a8, w4a8r): the forward through K8 with the
  per-(row, 128-group) activation quantize (act_quant=True).
- Both backwards are dx = g·dequant(W)ᵀ through K9 (`int4_dx`); the saved
  tensors are the packed weights, never an unpacked copy.

The choice between the kernels and JAX's XLA forms follows the JAX dispatch
by shape alone (`kernel_supported`, JAX `int4_pallas_supported`): where it
is false, the forward is x @ bf16-dequantized W (`_wo_xla_impl`) or the
grouped w8a8 product on the unpacked codes (`_w4a8_xla_impl`), and the
backward `_int4_dx_xla`, in plain torch on any device. At LLaMA-7B width
every block matmul passes it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels.quant_matmul import (dequant, int4_dx, int4_dx_ref,
                                   int4_matmul as int4_kernel,
                                   int4_matmul_ref, unpack_int4)

__all__ = ["pack_int4", "unpack_int4", "kernel_supported", "int4_matmul",
           "int4_matmul_grouped", "Int4Matmul", "Int4MatmulGrouped"]

_BK = 512  # the TPU kernel's preferred contraction block (quant_matmul.py:45)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 codes in [-8, 7] → (N/2, K) packed int8: row j's low
    nibble is q[j], its high nibble q[j + N/2] (JAX: int4.py:47-57,
    transposed)."""
    n = q.shape[0]
    if n % 2:
        raise ValueError(f"int4 packing needs an even output dim, got {n}")
    lo = q[: n // 2].to(torch.int32) & 0xF
    hi = q[n // 2:].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def kernel_supported(kq4: torch.Tensor, scale_g: torch.Tensor) -> bool:
    """JAX `int4_pallas_supported` (quant_matmul.py:220-233) without its
    environment switch: N/2 a multiple of 128, and the group width a
    multiple of 128 that divides the contraction block the TPU kernel would
    pick for K."""
    n_half, k = kq4.shape
    group = k // scale_g.shape[0]
    bk = _BK
    while k % bk:
        bk //= 2
    return (n_half % 128 == 0 and group % 128 == 0 and bk % group == 0
            and scale_g.shape[1] == 2 * n_half)


def _dx(g, kq4, scale_g):
    if kernel_supported(kq4, scale_g):
        return int4_dx(g.contiguous(), kq4, scale_g)
    return int4_dx_ref(g, kq4, scale_g)          # `_int4_dx_xla`


class Int4Matmul(torch.autograd.Function):
    """x (..., K) float; kq4 (N/2, K) packed; scale_g (G, N) f32 → (..., N)
    x.dtype, weight-only."""

    @staticmethod
    def forward(ctx, x, kq4, scale_g):
        ctx.save_for_backward(kq4, scale_g)
        if kernel_supported(kq4, scale_g):
            return int4_kernel(x.contiguous(), kq4, scale_g, False)
        w = dequant(unpack_int4(kq4), scale_g, torch.bfloat16)
        return F.linear(x, w.to(x.dtype))        # `_wo_xla_impl`

    @staticmethod
    def backward(ctx, g):
        kq4, scale_g = ctx.saved_tensors
        return _dx(g, kq4, scale_g), None, None


class Int4MatmulGrouped(torch.autograd.Function):
    """x (..., K) float; kq4 (N/2, K) packed; scale_g (G, N) f32 → (..., N)
    x.dtype, activations quantized per (row, group)."""

    @staticmethod
    def forward(ctx, x, kq4, scale_g):
        ctx.save_for_backward(kq4, scale_g)
        if kernel_supported(kq4, scale_g):
            return int4_kernel(x.contiguous(), kq4, scale_g, True)
        return int4_matmul_ref(x, kq4, scale_g, True)   # `_w4a8_xla_impl`

    @staticmethod
    def backward(ctx, g):
        kq4, scale_g = ctx.saved_tensors
        return _dx(g, kq4, scale_g), None, None


def int4_matmul(x, kq4, scale_g):
    return Int4Matmul.apply(x, kq4, scale_g)


def int4_matmul_grouped(x, kq4, scale_g):
    return Int4MatmulGrouped.apply(x, kq4, scale_g)
