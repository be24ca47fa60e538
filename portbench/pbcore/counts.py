"""Model FLOPs, and each frozen linear's operations and bytes.

The model FLOPs count what the algorithm needs, each once: the forward,
the input gradients through the frozen weights, the trainables' weight
gradients, causal attention at half the dense count, and the heads on the
rows that take them; remat's recompute is not counted. This corrects the
JAX package's `bench.py` `train_step_flops`, which counted attention
dense and compared against a TPU peak. Each FLOP is filed under the
precision the configuration states for its product (`precision` in the
configuration file), so that `least_seconds` can divide each part by its
own peak.

`linear_products` lists every product the train step makes with a frozen
linear or the LM head, recompute included, and `least_seconds` gives the
least time the card's peaks allow for them: max(ops at the product's
precision, bytes at the memory bandwidth), each input byte read once and
each output byte written once.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

# bytes per stored weight element, scales included (a 128-wide group's
# f32 scale adds 4/128 a weight)
WEIGHT_BYTES = {"bf16": 2.0, "int8": 1.0, "int8g128": 1.0 + 4 / 128,
                "int4g128": 0.5 + 4 / 128}
ACT_BYTES = 2.0                               # bf16 activations


class Product(NamedTuple):
    m: int
    n: int
    k: int
    precision: str          # the peak its ops count at
    weight: str             # WEIGHT_BYTES key of the stored weight
    count: int = 1

    @property
    def ops(self) -> float:
        return 2.0 * self.m * self.n * self.k * self.count

    @property
    def bytes(self) -> float:
        return (ACT_BYTES * (self.m * self.k + self.m * self.n)
                + WEIGHT_BYTES[self.weight] * self.n * self.k) * self.count


def dims(config: dict) -> dict:
    """The sizes the counts need, from a configuration file."""
    m = config["model"]
    return {"d": m["dim"], "h": config["intermediate_size"],
            "v": m["vocab_size"], "layers": m["n_layers"],
            "a": config["method"]["adapter_len"],
            "f": config["method"]["max_feats"],
            "dv": config["method"]["visual_dim"]}


def block_linears(d: int, h: int) -> List[tuple]:
    """(n, k) of one block's seven frozen linears."""
    return [(d, d)] * 4 + [(h, d), (d, h), (h, d)]


def _add(acc: Dict[str, float], precision: str, flops: float) -> None:
    acc[precision] = acc.get(precision, 0.0) + flops


def attention_flops(seqs: int, rows: float, cols: float, d: int) -> float:
    """q k^T and p v over `rows` query rows a sequence against `cols`
    key columns each (already halved for a causal mask), all heads."""
    return 4.0 * seqs * rows * cols * d


def train_update_flops(config: dict, t: dict) -> Dict[str, float]:
    """Model FLOPs of one optimizer update, by precision."""
    z, p = dims(config), config["precision"]
    d, h, v, layers = z["d"], z["h"], z["v"], z["layers"]
    a, f, s = z["a"], z["f"], t["max_seq_len"]
    n_obj = 1 + int(t["vaq"]) + int(t["qav"])
    b = t["batch_size"]
    tokens = b * n_obj * s
    lin = sum(2.0 * n * k for n, k in block_linears(d, h)) * layers
    out: Dict[str, float] = {}
    # frozen linears: forward, and the input gradient at the dx precision
    _add(out, p["linear_forward"], lin * tokens)
    _add(out, p["linear_dx"], lin * tokens)
    # the adapter rows' k and v, forward and their gradient
    adapter = layers * 2 * 2.0 * a * d * d
    _add(out, p["linear_forward"], adapter)
    _add(out, p["linear_dx"], adapter)
    # attention: causal text segment at half, the adapter segment whole;
    # the backward is twice the forward
    attn = layers * (attention_flops(b * n_obj, s, s / 2, d)
                     + attention_flops(b * n_obj, s, a, d))
    _add(out, p["other"], 3 * attn)
    # LM head on the VQA and VAQ rows, forward and dx; QAV head f32 math
    head_rows = b * (1 + int(t["vaq"])) * (s - 1)
    _add(out, p["head"], 2 * 2.0 * head_rows * d * v)
    if t["qav"]:
        _add(out, p["other"], 3 * 2.0 * b * (s - 1) * d * f)
    # visual_proj forward and its weight gradient
    _add(out, p["other"], 2 * 2.0 * b * f * z["dv"] * d)
    return {k: x * t["accum_iter"] for k, x in out.items()}


def eval_batch_flops(config: dict, t: dict, span: int) -> Dict[str, float]:
    """Model FLOPs of one cached-scorer batch: the prefill of the padded
    prompt, the last prompt row's head, then every option's span of
    `span` tokens against the cache and the head on its rows."""
    z, p = dims(config), config["precision"]
    d, h, v, layers, a = z["d"], z["h"], z["v"], z["layers"], z["a"]
    s, b, n_opt = t["max_seq_len"], t["batch_size"], t["n_options"]
    lin = sum(2.0 * n * k for n, k in block_linears(d, h)) * layers
    ext = b * n_opt * span
    out: Dict[str, float] = {}
    _add(out, p["linear_forward"], lin * (b * s + ext)
         + 2 * layers * 2 * 2.0 * a * d * d)
    attn = layers * (attention_flops(b, s, s / 2, d)
                     + attention_flops(b * n_opt, span, s + span / 2, d)
                     + attention_flops(1, b * s + ext, a, d))
    _add(out, p["other"], attn + 2.0 * b * z["f"] * z["dv"] * d)
    _add(out, p["head"], 2.0 * (b + ext) * d * v)
    return out


def generate_batch_flops(config: dict, t: dict, prefix_sum: int,
                         new_tokens: int) -> Dict[str, float]:
    """Model FLOPs of one generated batch: the prefill of the padded
    prompt, then `new_tokens` - 1 decode steps of one row each, every
    row attending the positions before it (`prefix_sum` is the batch's
    sum of prompt lengths), and the head on one row a step."""
    z, p = dims(config), config["precision"]
    d, h, v, layers, a = z["d"], z["h"], z["v"], z["layers"], z["a"]
    s, b = t["max_seq_len"], t["batch_size"]
    steps = new_tokens - 1
    lin = sum(2.0 * n * k for n, k in block_linears(d, h)) * layers
    out: Dict[str, float] = {}
    _add(out, p["linear_forward"], lin * (b * s + b * steps)
         + (1 + steps) * layers * 2 * 2.0 * a * d * d)
    # decode row i of a sequence attends prefix + i + 1 positions
    cols = steps * prefix_sum + b * steps * (steps + 1) / 2
    attn = layers * (attention_flops(b, s, s / 2, d)
                     + attention_flops(1, cols, 1, d)
                     + attention_flops(1, b * (s + steps), a, d))
    _add(out, p["other"], attn + 2.0 * b * z["f"] * z["dv"] * d)
    _add(out, p["head"], 2.0 * b * new_tokens * d * v)
    return out


def train_linear_products(config: dict, t: dict) -> List[Product]:
    """Every product of one update with a frozen linear or the LM head:
    forward, remat's recompute and dx for the blocks (and the adapter
    rows' k and v), forward and dx for the head."""
    z, p = dims(config), config["precision"]
    d, h, v, layers, a = z["d"], z["h"], z["v"], z["layers"], z["a"]
    s, b, accum = t["max_seq_len"], t["batch_size"], t["accum_iter"]
    n_obj = 1 + int(t["vaq"]) + int(t["qav"])
    tokens = b * n_obj * s
    forwards = 2 if t["remat"] else 1
    wt = p["linear_weight"]
    out = []
    for n, k in block_linears(d, h):
        c = layers * accum
        out.append(Product(tokens, n, k, p["linear_forward"], wt,
                           forwards * c))
        out.append(Product(tokens, k, n, p["linear_dx"], wt, c))
    for _ in range(2):                                  # wk, wv on the rows
        c = layers * accum
        out.append(Product(a, d, d, p["linear_forward"], wt, forwards * c))
        out.append(Product(a, d, d, p["linear_dx"], wt, c))
    rows = b * (1 + int(t["vaq"])) * (s - 1)
    out.append(Product(rows, v, d, p["head"], p["head_weight"], accum))
    out.append(Product(rows, d, v, p["head"], p["head_weight"], accum))
    return out


def least_seconds(flops: Dict[str, float], peaks: dict) -> float:
    """The least time the card's peaks allow for FLOPs by precision."""
    return sum(f / peaks["ops_per_s"][prec] for prec, f in flops.items())


def product_least_seconds(products: List[Product], peaks: dict) -> float:
    """Σ max(ops at the product's peak, bytes at the memory bandwidth)."""
    return sum(max(q.ops / peaks["ops_per_s"][q.precision],
                   q.bytes / peaks["bytes_per_s"]) for q in products)
