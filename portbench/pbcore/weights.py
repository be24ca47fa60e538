"""The benchmark's own weights, drawn from the seed on the device.

Both sides take the same draw: the program gets it at set-up (quantized
there by the program itself where the configuration says so), and the
plain reference draws it again, block by block, after the window. Each
block's leaves come from one generator seeded by (seed, block) in one
large call, in the type they are served in (bf16), so a block can be
drawn again on its own and gives the same values.

Laws: a frozen linear's weight is uniform in ±1/sqrt(fan_in), the token
table and the trainable adapter rows and temporal embedding are normal
(0, 1), norms are ones, `visual_proj` is uniform in ±1/sqrt(768); the
gates stand for an adapter part-way through fine-tuning: gate1 uniform in
±0.5 (so the adapter segment adds to every row) and gate2 at -bias, its
initial value.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch

FROZEN = torch.bfloat16


def block_seed(seed: int, block: str) -> int:
    """A 63-bit generator seed for one block of one run's draw."""
    h = hashlib.sha256(f"{int(seed)}:{block}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, block: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(block_seed(seed, block))


def layer_shapes(m: dict) -> List[Tuple[str, Tuple[int, int]]]:
    """(leaf, (out, in)) of one block's frozen linears, in draw order."""
    d, f = m["dim"], m["ffn_hidden"]
    return [("attention.wq", (d, d)), ("attention.wk", (d, d)),
            ("attention.wv", (d, d)), ("attention.wo", (d, d)),
            ("feed_forward.w1", (f, d)), ("feed_forward.w2", (d, f)),
            ("feed_forward.w3", (f, d))]


def _uniform_rows(flat: torch.Tensor, shapes) -> Dict[str, torch.Tensor]:
    """Cut a flat U(0, 1) f32 draw into the leaves, each mapped onto
    ±1/sqrt(fan_in) and cast to the frozen type."""
    out, at = {}, 0
    for name, (n, k) in shapes:
        w = flat[at:at + n * k].view(n, k)
        at += n * k
        bound = 1.0 / k ** 0.5
        out[name] = w.mul_(2 * bound).sub_(bound).to(FROZEN)
    return out


@torch.no_grad()
def draw_layer(m: dict, seed: int, i: int, device) -> Dict[str, torch.Tensor]:
    """Block i's frozen linears, {leaf: (out, in) bf16}."""
    shapes = layer_shapes(m)
    total = sum(n * k for _, (n, k) in shapes)
    flat = torch.rand(total, generator=generator(seed, f"layer{i}", device),
                      device=device, dtype=torch.float32)
    return _uniform_rows(flat, shapes)


@torch.no_grad()
def draw_embeddings(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The token table (V, D) and the LM head (V, D), bf16."""
    v, d = m["vocab_size"], m["dim"]
    g = generator(seed, "embeddings", device)
    table = torch.randn(v, d, generator=g, device=device).to(FROZEN)
    head = _uniform_rows(torch.rand(v * d, generator=g, device=device),
                         [("output", (v, d))])["output"]
    return {"tok_embeddings": table, "output": head}


@torch.no_grad()
def draw_trainables(m: dict, method: dict, bias: float, seed: int,
                    device) -> Dict[str, torch.Tensor]:
    """The trainables, f32, under the port's parameter names."""
    d, layers, heads = m["dim"], m["n_layers"], m["n_heads"]
    g = generator(seed, "trainables", device)
    vis = method["visual_dim"]
    out = {
        "adapter_query.weight": torch.randn(
            method["adapter_len"] * layers, d, generator=g, device=device),
        "temporal_emb.weight": torch.randn(method["max_feats"], d,
                                           generator=g, device=device),
        "visual_proj.weight": (torch.rand(d, vis, generator=g, device=device)
                               .mul_(2).sub_(1).mul_(vis ** -0.5)),
    }
    gate1 = torch.rand(layers, heads, generator=g, device=device).sub_(0.5)
    for i in range(layers):
        out[f"layers.{i}.attention.gate1"] = gate1[i].clone()
        out[f"layers.{i}.attention.gate2"] = torch.full(
            (heads,), -float(bias), device=device)
    return out
