"""The plain reference: the adapter-gated model in float32 PyTorch.

It follows the published Flipped-VQA block on a LLaMA-layout backbone
(RMSNorm, interleaved RoPE, SwiGLU, the two-segment attention: the text
segment causal with gate2 on the video block of the rows after it, the
adapter segment softmaxed on its own and scaled by tanh(gate1)), with no
kernel, cache or batching trick: every option and every generated token
is a full forward pass. It imports nothing of the program; it draws the
weights again from the seed (`pbcore.weights`), and under a quantized
configuration quantizes that draw itself.

Quantization, as the configuration states it (`quantize`):
  none   every product in float32 from the bf16 draw;
  w4a8   each block linear's weight in int4 with one f32 scale per
         128-wide group of inputs (absmax / 7, round half to even), its
         input rounded per (row, 128-wide group) to int8 (absmax / 127),
         the LM head's weight in int8 with 128-wide groups; the input's
         rounding passes the gradient straight through, as the program's
         backward does.
`act_levels` overrides the activations' levels (7: int4, the control).

TF32 is switched off for the reference's products (`strict_fp32`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from pbcore import weights

EPS = 1e-8


@contextlib.contextmanager
def strict_fp32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def quantize_dequantize(w: torch.Tensor, levels: int, group: int) -> torch.Tensor:
    """(N, K) weight → the f32 weight its codes stand for: absmax scale
    per (row, `group` inputs) divided by `levels` (at least 1e-8), codes
    rounded half to even and clipped to ±levels."""
    n, k = w.shape
    wg = w.float().reshape(n, k // group, group)
    amax = wg.abs().amax(-1, keepdim=True)
    scale = torch.maximum(amax / torch.full_like(amax, float(levels)),
                          torch.full_like(amax, EPS))
    codes = torch.round(wg / scale).clamp_(-levels, levels)
    return (codes * scale).reshape(n, k)


def quantize_rows(x: torch.Tensor, levels: int, group: int) -> torch.Tensor:
    """x rounded per (row, `group` inputs) to ±levels codes of absmax /
    levels, dequantized; the gradient passes straight through."""
    shape = x.shape
    xg = x.reshape(-1, shape[-1] // group, group)
    amax = xg.abs().amax(-1, keepdim=True)
    scale = torch.clamp_min(amax / torch.full_like(amax, float(levels)), EPS)
    q = (torch.round(xg / scale) * scale).reshape(shape)
    return x + (q - x).detach()


def rope_tables(head_dim: int, n: int, theta: float, device):
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=device) / head_dim))
    ang = torch.outer(torch.arange(n, dtype=torch.float32, device=device),
                      freqs)
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate interleaved pairs (x_2i, x_2i+1); x (B, S, H, Dh)."""
    p = x.reshape(*x.shape[:-1], -1, 2)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.stack([p[..., 0] * c - p[..., 1] * s,
                        p[..., 0] * s + p[..., 1] * c], -1).reshape(x.shape)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


class Reference:
    """The model of one configuration with the seed's weights, float32."""

    def __init__(self, config: dict, bias: float, seed: int, device,
                 act_levels: Optional[int] = None):
        m = dict(config["model"], ffn_hidden=config["intermediate_size"])
        meth = config["method"]
        self.m, self.meth = m, meth
        self.eps = m["norm_eps"]
        self.heads, self.dh = m["n_heads"], m["dim"] // m["n_heads"]
        self.quant = config["quantize"]
        if self.quant not in ("none", "w4a8"):
            raise ValueError(f"the reference has no --quantize {self.quant}")
        self.act_levels = act_levels or (127 if self.quant == "w4a8" else None)
        dev = torch.device(device)
        emb = weights.draw_embeddings(m, seed, dev)
        self.table = emb["tok_embeddings"].float()
        head = emb.pop("output")
        self.head = (quantize_dequantize(head, 127, 128)
                     if self.quant == "w4a8" else head.float())
        del emb, head
        self.layers = []
        for i in range(m["n_layers"]):
            drawn = weights.draw_layer(m, seed, i, dev)
            self.layers.append({k.split(".")[-1]: self._frozen(w)
                                for k, w in drawn.items()})
            del drawn
        self.train = {k: v.clone().requires_grad_(True)
                      for k, v in weights.draw_trainables(
                          m, meth, bias, seed, dev).items()}

    def _frozen(self, w: torch.Tensor) -> torch.Tensor:
        if self.quant == "w4a8":
            return quantize_dequantize(w, 7, 128)
        return w.float()

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.act_levels is not None:
            x = quantize_rows(x, self.act_levels, 128)
        return x @ w.t()

    # --- the forward ---------------------------------------------------------

    def fuse(self, video: torch.Tensor) -> torch.Tensor:
        return video.float() @ self.train["visual_proj.weight"].t()

    def embed(self, tokens, vf, splice):
        """Token rows with the video features (plus the temporal rows)
        written over the splice positions."""
        s = tokens.shape[1]
        h = self.table[tokens.long()]
        onehot = (splice.long()[..., None]
                  == torch.arange(s, device=tokens.device)).float()
        vf = vf + self.train["temporal_emb.weight"][None]
        keep = 1.0 - onehot.sum(1)
        return h * keep[..., None] + torch.einsum("bfs,bfd->bsd", onehot, vf)

    def attention(self, i: int, x, cos, sin, video_start):
        w = self.layers[i]
        b, s, _ = x.shape
        hh, dh = self.heads, self.dh
        q = rope(self.linear(x, w["wq"]).view(b, s, hh, dh), cos, sin)
        k = rope(self.linear(x, w["wk"]).view(b, s, hh, dh), cos, sin)
        v = self.linear(x, w["wv"]).view(b, s, hh, dh)
        scale = 1.0 / math.sqrt(dh)
        scores = torch.einsum("bshd,bthd->bhst", q, k) * scale
        rows = torch.arange(s, device=x.device)
        causal = rows[:, None] >= rows[None, :]
        scores = scores.masked_fill(~causal, float("-inf"))
        f = self.meth["max_feats"]
        vs = video_start.long()[:, None, None]
        block = ((rows[None, :, None] >= vs + f) & (rows[None, None, :] >= vs)
                 & (rows[None, None, :] < vs + f) & (vs >= 0))
        gate2 = self.train[f"layers.{i}.attention.gate2"]
        scores = scores + block[:, None].float() * gate2[None, :, None, None]
        out = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, -1), v)
        a = self.train["adapter_query.weight"].view(
            self.m["n_layers"], self.meth["adapter_len"], -1)[i]
        ak = self.linear(a, w["wk"]).view(-1, hh, dh)
        av = self.linear(a, w["wv"]).view(-1, hh, dh)
        ascores = torch.einsum("bshd,lhd->bhsl", q, ak) * scale
        gate1 = torch.tanh(self.train[f"layers.{i}.attention.gate1"])
        probs = torch.softmax(ascores, -1) * gate1[None, :, None, None]
        out = out + torch.einsum("bhsl,lhd->bshd", probs, av)
        return self.linear(out.reshape(b, s, hh * dh), w["wo"])

    def block(self, i: int, h, cos, sin, video_start):
        w = self.layers[i]
        h = h + self.attention(i, rms_norm(h, 1.0, self.eps), cos, sin,
                               video_start)
        x = rms_norm(h, 1.0, self.eps)
        gate = torch.nn.functional.silu(self.linear(x, w["w1"]))
        return h + self.linear(gate * self.linear(x, w["w3"]), w["w2"])

    def encode(self, tokens, vf, video_start, splice) -> torch.Tensor:
        """The final-normed hidden rows (B, S, D) of whole sequences."""
        h = self.embed(tokens, vf, splice)
        cos, sin = rope_tables(self.dh, tokens.shape[1], self.m["rope_theta"],
                               tokens.device)
        for i in range(len(self.layers)):
            h = self.block(i, h, cos, sin, video_start)
        return rms_norm(h, 1.0, self.eps)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self.head.t()


def token_ce(logits: torch.Tensor, labels: torch.Tensor,
             ignore: int) -> torch.Tensor:
    """Per-row CE, 0 where the label is `ignore`."""
    valid = labels != ignore
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    ll = torch.log_softmax(logits, -1).gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, -ll, torch.zeros_like(ll))
