"""Flax parameter tree → the port's state_dict (JAX: flipped_tpu/ckpt/convert.py).

The port's parameter names are the reference state_dict names, which the
JAX package maps to Flax paths with `torch_name_to_flax_path` and
`needs_transpose` (ckpt/convert.py:76-91). This module is the inverse, for
every leaf, trainables included:

    tok_embeddings/embedding          → tok_embeddings.weight
    layers_N/attention/wq/kernel      → layers.N.attention.wq.weight  (transposed)
    layers_N/attention/gate1          → layers.N.attention.gate1
    layers_N/attention_norm/weight    → layers.N.attention_norm.weight
    output/kernel                     → output.weight                 (transposed)
    adapter_query, temporal_emb       → adapter_query.weight, temporal_emb.weight
    visual_proj/kernel                → visual_proj.weight            (transposed)

Flax kernels are (in, out) and torch Linear weights (out, in), so every
`kernel` leaf transposes. Gates keep their (H,) shape.

The quantized leaves of a frozen Linear (--quantize int8*/w8a8*) keep their
Flax leaf names, and their dtypes end to end:

    layers_N/attention/wq/kernel_q  (K, N) int8  → layers.N.attention.wq.kernel_q
                                                   (N, K) int8, transposed
    .../scale    (N,) or (G, N) f32              → .scale, not transposed
    .../out_idx  (n_out,) int32                  → .out_idx
    .../out_w    (n_out, N) bf16                 → .out_w, not transposed

    .../kernel_q4 (K, N/2) int8 packed int4      → .kernel_q4 (N/2, K),
                                                   transposed
    qav_rot (dim, dim) f32 (rotated modes)       → qav_rot

kernel_q is stored (N, K), the reference's `weight` layout: K-contiguous,
which is how K3 and K7 read their B operand, and K4 transposes its tile in
shared memory (ckpt/quantize.py); kernel_q4 likewise, for K8 and K9.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def flatten_flax(tree, prefix: str = "") -> Dict[str, object]:
    """Nested dict → {'a/b/c': leaf}."""
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_flax(v, path))
        else:
            flat[path] = v
    return flat


def flax_path_to_torch_name(path: str) -> str:
    """'layers_3/attention/wq/kernel' → 'layers.3.attention.wq.weight'."""
    parts = path.split("/")
    if parts[0].startswith("layers_"):
        parts = ["layers", parts[0][len("layers_"):]] + parts[1:]
    if parts[-1] in ("kernel", "embedding"):
        parts[-1] = "weight"
    elif len(parts) == 1 and parts[0] != "qav_rot":
        parts.append("weight")     # bare top-level tables: adapter_query, ...
    return ".".join(parts)


def needs_transpose(path: str) -> bool:
    """Every Flax `kernel` (and quantized `kernel_q`, `kernel_q4`) is
    (in, out); its torch leaf is (out, in)."""
    return path.rsplit("/", 1)[-1] in ("kernel", "kernel_q", "kernel_q4")


def params_from_flax(flax_params) -> Dict[str, torch.Tensor]:
    """Flax param tree (leaves as numpy or jax arrays) → state_dict of CPU
    tensors: integer leaves (kernel_q, kernel_q4 int8, out_idx int32) keep
    their dtype, float leaves become f32; `load_state_dict` casts them to
    each parameter's dtype."""
    sd = {}
    for path, leaf in flatten_flax(flax_params).items():
        arr = np.asarray(leaf)
        if not np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.float32)
        if needs_transpose(path):
            arr = arr.T
        sd[flax_path_to_torch_name(path)] = torch.tensor(
            np.ascontiguousarray(arr))
    return sd
