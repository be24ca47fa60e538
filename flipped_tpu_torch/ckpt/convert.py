"""Meta's LLaMA checkpoints, and Flax parameter trees, → the port's
state_dict (JAX: flipped_tpu/ckpt/convert.py).

Meta's `consolidated.NN.pth` shards hold one tensor-parallel slice each of
a reference state_dict, in the port's own names and layout. `merge_shards`
and `load_meta_checkpoint` join them as the reference does (llama_vqa.py:
32-58; JAX convert.py:25-75): column-parallel weights (wq, wk, wv, w1, w3,
output) concatenate on dim 0, row-parallel ones (wo, w2) and
tok_embeddings on dim 1, norms are the same in every shard.
`export_meta_checkpoint` writes the shards from a state_dict.

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
    audio_proj/kernel                 → audio_proj.weight             (transposed)
    video_audio_cross_attn/query/kernel
                                      → video_audio_cross_attn.query.weight
                                                                      (transposed)
    video_audio_cross_attn/query/bias → video_audio_cross_attn.query.bias
    (key and value alike)

Flax kernels are (in, out) and torch Linear weights (out, in), so every
`kernel` leaf transposes; biases and gates keep their shapes.

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

import json
import os
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

# concat dim of each leaf in the tensor-parallel shards, -1 = the same in
# every shard (reference: llama_vqa.py:50-58)
_LAYER_SPLIT_DIMS = {
    "attention_norm.weight": -1,
    "ffn_norm.weight": -1,
    "attention.wq.weight": 0,
    "attention.wk.weight": 0,
    "attention.wv.weight": 0,
    "feed_forward.w1.weight": 0,
    "feed_forward.w3.weight": 0,
    "attention.wo.weight": 1,
    "feed_forward.w2.weight": 1,
}
_TOP_SPLIT_DIMS = {
    "tok_embeddings.weight": 1,
    "norm.weight": -1,
    "output.weight": 0,
}


def split_dim_table(n_layers: int) -> Dict[str, int]:
    table = dict(_TOP_SPLIT_DIMS)
    for i in range(n_layers):
        for k, d in _LAYER_SPLIT_DIMS.items():
            table[f"layers.{i}.{k}"] = d
    return table


def merge_shards(shards: List[dict], n_layers: int) -> dict:
    """Join Meta's tensor-parallel shards into one state_dict, emptying
    them as it goes (JAX: convert.py:55-73). One shard is returned as it
    is; with more, only the leaves of `split_dim_table` are kept."""
    if len(shards) == 1:
        return shards[0]
    merged = {}
    for name, dim in split_dim_table(n_layers).items():
        if name not in shards[0]:
            continue
        merged[name] = _merge_leaf([s[name] for s in shards], dim)
        for s in shards:
            del s[name]
    return merged


def _merge_leaf(pieces: List[torch.Tensor], dim: int) -> torch.Tensor:
    """One leaf from its pieces: concatenated on `dim`, or the first piece
    where every shard holds all of it (dim -1)."""
    return pieces[0] if dim < 0 else torch.cat(pieces, dim=dim)


def checkpoint_shards(model_dir) -> List[Path]:
    return sorted(Path(model_dir).glob("consolidated.*.pth"))


def load_meta_checkpoint(model_dir, names: Optional[Iterable[str]] = None,
                         device="cpu") -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, bf16 tensor on `device`) for each leaf of the merged
    Meta checkpoint under `model_dir` (consolidated.*.pth + params.json),
    one at a time, in the shards' order; `names` picks a subset. The
    shards are memory-mapped, so a leaf is read when it is merged, and
    `rope.freqs` is dropped (the model computes it). The merge is
    `merge_shards`' and the cast to bf16 the JAX converter's
    (convert.py:107-116), done on `device`."""
    paths = checkpoint_shards(model_dir)
    if not paths:
        raise FileNotFoundError(f"no consolidated.*.pth under {model_dir}")
    with open(Path(model_dir) / "params.json") as f:
        table = split_dim_table(json.load(f)["n_layers"])
    shards = [torch.load(p, map_location="cpu", weights_only=True,
                         mmap=True) for p in paths]
    wanted = None if names is None else set(names)
    for name in list(shards[0]):
        if "rope.freqs" in name or (wanted is not None
                                    and name not in wanted):
            continue
        dim = table.get(name)
        if len(shards) > 1 and dim is None:
            continue
        pieces = shards if len(shards) > 1 and dim >= 0 else shards[:1]
        # no local keeps the leaf: the caller frees it before the next
        yield name, _merge_leaf([s[name].to(device) for s in pieces],
                                -1 if dim is None else dim).to(
                                    torch.bfloat16)


def export_meta_checkpoint(state: Dict[str, torch.Tensor], n_shards: int,
                           out_dir, params: dict) -> None:
    """Write `state` (reference names; the leaves of `split_dim_table`, the
    rest skipped) as Meta's `consolidated.NN.pth` shards split along the
    reference dims, plus `params.json`: the inverse of
    `load_meta_checkpoint` (JAX `export_reference_style`, convert.py:
    138-186). Tensors keep their dtype; each shard is gathered on the host
    and saved before the next, so the host holds one shard at a time."""
    os.makedirs(out_dir, exist_ok=True)
    table = split_dim_table(params["n_layers"])
    for i in range(n_shards):
        shard = {}
        for name, t in state.items():
            dim = table.get(name)
            if dim is None:
                continue
            if dim >= 0 and n_shards > 1:
                t = torch.chunk(t, n_shards, dim=dim)[i]
            shard[name] = t.to("cpu", copy=True).contiguous()
        torch.save(shard, os.path.join(out_dir, f"consolidated.{i:02d}.pth"))
        del shard
    with open(os.path.join(out_dir, "params.json"), "w") as f:
        json.dump(params, f)


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
