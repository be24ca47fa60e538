"""int8 quantization of the frozen backbone (JAX: flipped_tpu/ckpt/quantize.py,
8-bit branches).

Leaves in the port's layout, the reference's `weight` layout (out, in),
transposed like every Flax `kernel` leaf (ckpt/convert.py):

    <name>.kernel_q   (N, K) int8     N = out features, K = in features;
                                      K-contiguous, what K3, K7 and K4 read
    <name>.scale      (N,) f32        per-channel, or
                      (G, N) f32      grouped, G = K / group (not transposed)
    <name>.out_idx    (n_out,) int32  outlier modes: the passthrough input
    <name>.out_w      (n_out, N)      rows, kept in the frozen dtype; their
                                      columns of kernel_q are zero

`quantize_kernel` and `quantize_frozen` run the JAX package's numpy
arithmetic on the transposed weight, so both packages give the same codes
and scales. `randomize_quantized` fills a model's int8 leaves on its
device from a `torch.Generator`, with the laws of the JAX
`randomize_quantized` (codes uniform in [-127, 127], scale
1/(127·√fan_in), random outlier rows zero in kernel_q, out_w =
randn/√fan_in) but not its random stream: a 7B backbone never passes
through the host.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..model.int8 import outlier_count

# frozen matmuls that are quantized (module names whose weight qualifies)
QUANT_MODULES = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "output")
EPS = 1e-8


def quantize_kernel(weight, group: int = 0,
                    outliers: int = 0) -> Dict[str, torch.Tensor]:
    """(N, K) float weight → {'kernel_q', 'scale'} (+ 'out_idx', 'out_w'
    when outliers > 0), absmax round-to-nearest-even, in the port's layout.

    group=0, or a group that does not divide K: per-channel scale (N,);
    else grouped scale (K/group, N). outliers > 0: the `outliers` input rows
    of largest absmax go to a bf16 passthrough and are zeroed before
    quantization (JAX: ckpt/quantize.py:35-93)."""
    k = np.asarray(torch.as_tensor(weight).detach().float().cpu(),
                   np.float32).T.copy()                        # (K, N)
    extra = {}
    if outliers > 0:
        row_amax = np.abs(k).max(axis=1)
        idx = np.sort(np.argpartition(row_amax, -outliers)[-outliers:])
        extra = {"out_idx": torch.from_numpy(idx.astype(np.int32)),
                 "out_w": torch.from_numpy(k[idx]).to(torch.bfloat16)}
        k[idx] = 0.0
    if group > 0 and k.shape[0] % group == 0:
        kg = k.reshape(k.shape[0] // group, group, k.shape[1])
        scale = np.maximum(np.abs(kg).max(axis=1) / 127.0, EPS)  # (G, N)
        q = np.clip(np.round(kg / scale[:, None, :]), -127,
                    127).astype(np.int8).reshape(k.shape)
    else:
        scale = np.maximum(np.abs(k).max(axis=0) / 127.0, EPS)   # (N,)
        q = np.clip(np.round(k / scale[None, :]), -127, 127).astype(np.int8)
    return {"kernel_q": torch.from_numpy(np.ascontiguousarray(q.T)),
            "scale": torch.from_numpy(scale.astype(np.float32)), **extra}


def dequantize_kernel(node: Dict[str, torch.Tensor]) -> torch.Tensor:
    """{'kernel_q', 'scale', ...} → the (N, K) f32 weight they stand for,
    passthrough rows restored (JAX: ckpt/quantize.py:96-113)."""
    q = node["kernel_q"].float()                               # (N, K)
    s = node["scale"].float()
    if s.dim() == 2:                                           # (G, N)
        n, k_dim = q.shape
        w = (q.view(n, s.shape[0], k_dim // s.shape[0])
             * s.t()[:, :, None]).reshape(n, k_dim)
    else:
        w = q * s[:, None]
    if "out_w" in node:
        w[:, node["out_idx"].long()] = node["out_w"].float().t()
    return w


def quantize_frozen(state: Dict[str, torch.Tensor], group: int = 0,
                    outlier_rows: bool = False) -> Dict[str, torch.Tensor]:
    """A state_dict with the frozen matmuls' `<name>.weight` replaced by
    their quantized leaves (JAX: ckpt/quantize.py:116-138); every other
    entry is kept."""
    out = {}
    for name, t in state.items():
        if name.endswith(".weight") and name.split(".")[-2] in QUANT_MODULES:
            base = name[:-len(".weight")]
            n_out = outlier_count(t.shape[1]) if outlier_rows else 0
            for leaf, v in quantize_kernel(t, group, n_out).items():
                out[f"{base}.{leaf}"] = v
        else:
            out[name] = t
    return out


@torch.no_grad()
def randomize_quantized(model: torch.nn.Module,
                        generator: torch.Generator) -> None:
    """Fill every quantized Linear of `model` in place, on its device
    (JAX: ckpt/quantize.py:141-201): codes uniform in [-127, 127], scale
    1/(127·√fan_in) in the leaf's own shape, and in the outlier modes
    n_out distinct random input rows, zero in kernel_q, with out_w =
    randn/√fan_in."""
    for module in model.modules():
        kq = getattr(module, "kernel_q", None)
        if kq is None:
            continue
        fan_in = kq.shape[1]
        kq.random_(-127, 128, generator=generator)
        module.scale.fill_(1.0 / (127.0 * math.sqrt(fan_in)))
        if getattr(module, "out_idx", None) is not None:
            n_out = module.out_idx.shape[0]
            idx = torch.randperm(fan_in, generator=generator,
                                 device=kq.device)[:n_out].sort().values
            kq[:, idx] = 0
            module.out_idx.copy_(idx.to(torch.int32))
            w = torch.randn(module.out_w.shape, generator=generator,
                            device=kq.device) / math.sqrt(fan_in)
            module.out_w.copy_(w.to(torch.bfloat16))
