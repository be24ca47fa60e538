"""Residual-stream rotation for outlier-immune quantization (QuaRot-style),
folded into a loaded checkpoint in torch, on its device (JAX:
flipped_tpu/ckpt/rotate.py).

The residual stream is conjugated by a random orthogonal R, h' = h R, with
R = diag(s)·H/√d (random signs s, Sylvester-Hadamard H) for a power-of-two
d, else a QR-orthogonalised Gaussian matrix. RMSNorm commutes with R once
its weight γ is folded into the matmuls that read it, so the rotated model
is exactly the original one. In the port's layout, weights (out, in):

    tok_embeddings   E' = E R
    attention_norm   γa → 1;  wq/wk/wv: W' = W diag(γa) R   (JAX K' = Rᵀ diag(γa) K)
    wo               W' = Rᵀ W                               (JAX K' = K R)
    ffn_norm         γf → 1;  w1/w3: W' = W diag(γf) R
    w2               W' = Rᵀ W
    norm             γn → 1;  output: W' = W diag(γn) R
    temporal_emb     T' = T R
    visual_proj, audio_proj   (out == dim) W' = Rᵀ W: visual_proj of
                     every merge (concat's 1792 inputs stay unrotated) and
                     audio_proj of sum and audio_only; the attention
                     merge's audio_proj (out = visual_dim) and its
                     cross-attention read no residual and are not rotated
    adapter_query    a'_l = a_l diag(γa_l)⁻¹ R   (the adapters feed wk/wv
                     without a norm, so the folded γ is divided out)
    qav_rot          Rᵀ diag(γn) R, symmetric, restores γn in the QAV head

The SwiGLU hidden axis is not rotated. Folds run in f32 on the bf16 leaves
and cast back to the leaf's dtype; quantization (ckpt/quantize.py) runs
after, on those bf16 values. The signs are numpy's draw for `seed`, so
train, resume and evaluate rebuild the same rotation.

`fwht` is a butterfly of adds and subtracts in f32, in place: no matmul, so
no TF32 whatever the global flags say. JAX runs the transform as two numpy
matmuls with a Hadamard factor each; the sums are the same but their order
is not, so a folded f32 value can differ in its last bits and, rarely, its
bf16 rounding by one ulp.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

DEFAULT_SEED = 0

_READS_RESIDUAL = {"attention.wq": "attention_norm",
                   "attention.wk": "attention_norm",
                   "attention.wv": "attention_norm",
                   "feed_forward.w1": "ffn_norm",
                   "feed_forward.w3": "ffn_norm"}
_WRITES_RESIDUAL = ("attention.wo", "feed_forward.w2")
_NORMS = ("attention_norm", "ffn_norm")


def fwht_(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unnormalised fast Walsh-Hadamard transform of the contiguous f32 `x`
    along `dim`, in place (y = x·H, H the symmetric Sylvester Hadamard
    matrix); a power-of-two length."""
    dim = dim % x.dim()
    d = x.shape[dim]
    if d & (d - 1):
        raise ValueError(f"fwht needs a power-of-two length, got {d}")
    pre, post = x.shape[:dim], x.shape[dim + 1:]
    h = 1
    while h < d:
        v = x.view(*pre, d // (2 * h), 2, h, *post)
        a = v.select(len(pre) + 1, 0)
        b = v.select(len(pre) + 1, 1)
        diff = a - b
        a.add_(b)
        b.copy_(diff)
        h *= 2
    return x


class Rotation:
    """A random orthogonal rotation of R^dim on `device` (JAX: rotate.py:
    98-149)."""

    def __init__(self, dim: int, seed: int = DEFAULT_SEED, device="cpu"):
        self.dim = dim
        rs = np.random.RandomState(seed)
        if dim & (dim - 1) == 0:
            self.signs = torch.from_numpy(
                rs.choice(np.float32([-1.0, 1.0]), dim)).to(device)
            self.q = None
        else:
            self.signs = None
            # JAX's f32 matmuls by q run here in f64: no TF32 either way
            self.q = torch.from_numpy(np.linalg.qr(rs.randn(dim, dim).astype(
                np.float64))[0].astype(np.float32)).to(device)

    def _normalise(self, y: torch.Tensor) -> torch.Tensor:
        """y / √dim as JAX computes it: numpy divides the f32 array by the
        float64 √dim in float64, which is exact in f32 when √dim is a
        power of two."""
        root = math.isqrt(self.dim)
        if root * root == self.dim:
            return y.div_(root)
        return (y.double() / math.sqrt(self.dim)).float()

    def rotate(self, m: torch.Tensor, dim: int,
               gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Rotate axis `dim` of `m` (f32 result): the vectors along it go to
        v·diag(gamma)·R. JAX's `right` (m @ R) is `dim=-1`, and its
        `left_t` (Rᵀ diag(γ) k on a (in, out) kernel) is `dim=-1` of the
        transposed (out, in) weight with `gamma`."""
        shape = [1] * m.dim()
        shape[dim] = self.dim
        x = m.to(torch.float32, copy=True)
        if gamma is not None:
            x.mul_(gamma.to(torch.float32).view(shape))
        if self.q is not None:
            x = torch.tensordot(x.double(), self.q.double(), ([dim], [0]))
            return x.movedim(-1, dim).float().contiguous()
        x.mul_(self.signs.view(shape))
        return self._normalise(fwht_(x, dim))

    def conjugate_diag(self, gamma: torch.Tensor) -> torch.Tensor:
        """Rᵀ diag(gamma) R (symmetric): the runtime `qav_rot` matrix."""
        g = gamma.to(torch.float32)
        if self.q is not None:
            q = self.q.double()
            return (q.t() @ (g.double()[:, None] * q)).float()
        # the signs cancel: diag(s)·diag(γ)·diag(s) = diag(γ)
        m = fwht_(fwht_(torch.diag(g), 0), 1)
        return m.div_(self.dim)

    def matrix(self) -> torch.Tensor:
        """Explicit R (tests and small dims only)."""
        eye = torch.eye(self.dim, dtype=torch.float32,
                        device=(self.signs if self.q is None
                                else self.q).device)
        return self.rotate(eye, -1)


def fold_leaf(rot: Rotation, name: str, t: torch.Tensor,
              gammas: Dict[str, torch.Tensor], n_layers: int,
              adapter_layer: int = 0) -> torch.Tensor:
    """The rotated value of the leaf `name` (reference state_dict names),
    cast back to `t`'s dtype; `gammas` holds the norm weights the folds
    read ('layers.N.attention_norm.weight', ..., 'norm.weight'). A leaf
    the rotation does not touch is returned as it is."""
    def gamma(key):
        if key not in gammas:
            raise ValueError(f"{name}: {key} is missing, so the rotation "
                             f"cannot be folded into it")
        return gammas[key]

    if name.endswith(("kernel_q", "kernel_q4")):
        raise ValueError(
            f"{name}: the rotation must fold into the bf16/f32 weights "
            f"before quantization (ckpt/quantize.py runs after)")
    parts = name.split(".")
    if parts[0] == "layers" and name.endswith(".weight"):
        module = ".".join(parts[2:-1])
        prefix = ".".join(parts[:2])
        if module in _NORMS:
            return torch.ones_like(t)
        if module in _READS_RESIDUAL:
            g = gamma(f"{prefix}.{_READS_RESIDUAL[module]}.weight")
            return rot.rotate(t, -1, g).to(t.dtype)
        if module in _WRITES_RESIDUAL:
            return rot.rotate(t, 0).to(t.dtype)
        return t
    if name == "norm.weight":
        return torch.ones_like(t)
    if name == "output.weight":
        return rot.rotate(t, -1, gamma("norm.weight")).to(t.dtype)
    if name in ("tok_embeddings.weight", "temporal_emb.weight"):
        return rot.rotate(t, -1).to(t.dtype)
    if (name in ("visual_proj.weight", "audio_proj.weight")
            and t.shape[0] == rot.dim):
        return rot.rotate(t, 0).to(t.dtype)
    if name == "adapter_query.weight":
        if adapter_layer <= 0:
            raise ValueError("adapter_query present — pass the model's "
                             "adapter_layer so rows pair with the right "
                             "attention_norm γ")
        alen = t.shape[0] // adapter_layer
        first = n_layers - adapter_layer
        blocks = []
        for j in range(adapter_layer):
            g = gamma(f"layers.{first + j}.attention_norm.weight").to(
                torch.float32)
            if bool((g == 0).any()):
                raise ValueError("attention_norm weight has exact zeros — "
                                 "cannot invert the fold for adapter_query")
            a = t[j * alen:(j + 1) * alen].to(torch.float32)
            blocks.append(rot.rotate(a / g[None, :], -1))
        return torch.cat(blocks).to(t.dtype)
    return t


def residual_dim(state: Dict[str, torch.Tensor], n_layers: int) -> int:
    """The residual width, from the first layer's wq (in features) or the
    final norm (JAX: rotate.py:188-198)."""
    for i in range(n_layers):
        wq = state.get(f"layers.{i}.attention.wq.weight")
        if wq is not None:
            return wq.shape[1]
    if "norm.weight" in state:
        return state["norm.weight"].shape[0]
    raise ValueError("rotate_params: no layer kernels or final norm found — "
                     "cannot infer the residual dim")


def rotate_params(state: Dict[str, torch.Tensor], n_layers: int,
                  adapter_layer: int = 0,
                  seed: int = DEFAULT_SEED) -> Dict[str, torch.Tensor]:
    """Fold a residual-stream rotation into an unquantized state_dict
    (JAX: rotate.py:157-299): a new dict with every norm weight at 1,
    `qav_rot` added and, where present, the trainables adapter_query,
    temporal_emb, visual_proj and audio_proj (where it writes the residual)
    rotated, so the rotated model computes what the original did. A quantized leaf raises."""
    for name in state:
        if name.endswith(("kernel_q", "kernel_q4")):
            raise ValueError(
                f"rotate_params got a quantized state ({name}) — the "
                f"rotation must fold into the bf16/f32 weights before "
                f"quantization (ckpt/quantize.py runs after)")
    if "norm.weight" not in state:
        raise ValueError("rotate_params: final norm.weight missing — needed "
                         "for the output head fold and qav_rot")
    dim = residual_dim(state, n_layers)
    rot = Rotation(dim, seed, device=state["norm.weight"].device)
    gammas = {n: t for n, t in state.items() if n.endswith("norm.weight")}
    out = {n: fold_leaf(rot, n, t, gammas, n_layers, adapter_layer)
           for n, t in state.items()}
    out["qav_rot"] = rot.conjugate_diag(gammas["norm.weight"])
    return out
