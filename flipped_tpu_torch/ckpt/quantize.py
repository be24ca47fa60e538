"""int8 and packed int4 quantization of the frozen backbone (JAX:
flipped_tpu/ckpt/quantize.py).

Leaves in the port's layout, the reference's `weight` layout (out, in),
transposed like every Flax `kernel` leaf (ckpt/convert.py):

    <name>.kernel_q   (N, K) int8     N = out features, K = in features;
                                      K-contiguous, what K3, K7 and K4 read
    <name>.scale      (N,) f32        per-channel, or
                      (G, N) f32      grouped, G = K / group (not transposed)
    <name>.out_idx    (n_out,) int32  outlier modes: the passthrough input
    <name>.out_w      (n_out, N)      rows, kept in the frozen dtype; their
                                      columns of kernel_q are zero
    <name>.kernel_q4  (N/2, K) int8   int4 modes: packed codes in [-7, 7]
                                      (model/int4.py), with a grouped scale
                                      (G, N); the LM head stays int8

`quantize_kernel` and `quantize_frozen` run the JAX package's numpy
arithmetic on the transposed weight, so both packages give the same codes
and scales. `randomize_quantized` fills a model's int8 leaves on its
device from a `torch.Generator`, with the laws of the JAX
`randomize_quantized` (codes uniform in [-127, 127], scale
1/(127·√fan_in), random outlier rows zero in kernel_q, out_w =
randn/√fan_in; packed int4 codes uniform in [-7, 7], scale 1/(7·√fan_in))
but not its random stream: a 7B backbone never passes through the host.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..model.int4 import pack_int4, unpack_int4
from ..model.int8 import outlier_count

# frozen matmuls that are quantized (module names whose weight qualifies)
QUANT_MODULES = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "output")
EPS = 1e-8


def quantize_kernel(weight, group: int = 0, outliers: int = 0,
                    bits: int = 8) -> Dict[str, torch.Tensor]:
    """(N, K) float weight → {'kernel_q', 'scale'} (+ 'out_idx', 'out_w'
    when outliers > 0), absmax round-to-nearest-even, in the port's layout.

    group=0, or a group that does not divide K: per-channel scale (N,);
    else grouped scale (K/group, N). outliers > 0: the `outliers` input rows
    of largest absmax go to a bf16 passthrough and are zeroed before
    quantization (JAX: ckpt/quantize.py:35-93). bits=4: {'kernel_q4'
    (N/2, K) packed, 'scale' (G, N)} with ±7 levels, the group 128 when 0,
    one group when it does not divide K; no outliers (JAX: :55-71)."""
    k = np.asarray(torch.as_tensor(weight).detach().float().cpu(),
                   np.float32).T.copy()                        # (K, N)
    if bits == 4:
        if outliers:
            raise ValueError("int4 + outlier passthrough is unsupported — "
                             "use --quantize int4r|w4a8r instead")
        k_dim, n = k.shape
        group = group or 128
        g = group if k_dim % group == 0 else k_dim
        kg = k.reshape(k_dim // g, g, n)
        scale = np.maximum(np.abs(kg).max(axis=1) / 7.0, EPS)   # (G, N)
        q = np.clip(np.round(kg / scale[:, None, :]), -7,
                    7).astype(np.int8).reshape(k_dim, n)
        return {"kernel_q4": pack_int4(torch.from_numpy(
                    np.ascontiguousarray(q.T))),
                "scale": torch.from_numpy(scale.astype(np.float32))}
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
    s = node["scale"].float()
    q = (unpack_int4(node["kernel_q4"]) if "kernel_q4" in node
         else node["kernel_q"]).float()                        # (N, K)
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
                    outlier_rows: bool = False,
                    bits: int = 8) -> Dict[str, torch.Tensor]:
    """A state_dict with the frozen matmuls' `<name>.weight` replaced by
    their quantized leaves (JAX: ckpt/quantize.py:116-138); every other
    entry is kept. bits=4 packs every one but the LM head (`output`), which
    stays int8, and groups every scale (128 when group is 0)."""
    out = {}
    for name, t in state.items():
        module = name.split(".")[-2] if "." in name else ""
        if name.endswith(".weight") and module in QUANT_MODULES:
            base = name[:-len(".weight")]
            n_out = outlier_count(t.shape[1]) if outlier_rows else 0
            leaf_bits = 8 if module == "output" else bits
            leaf_group = (group or 128) if bits == 4 else group
            for leaf, v in quantize_kernel(t, leaf_group, n_out,
                                           leaf_bits).items():
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
    randn/√fan_in; packed int4 leaves with codes uniform in [-7, 7] and
    scale 1/(7·√fan_in)."""
    for module in model.modules():
        kq4 = getattr(module, "kernel_q4", None)
        if kq4 is not None:
            fan_in = kq4.shape[1]
            codes = torch.randint(-7, 8, (2 * kq4.shape[0], fan_in),
                                  generator=generator, device=kq4.device,
                                  dtype=torch.int8)
            kq4.copy_(pack_int4(codes))
            module.scale.fill_(1.0 / (7.0 * math.sqrt(fan_in)))
            continue
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
