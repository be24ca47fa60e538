"""Model assembly (JAX: flipped_tpu/train/builder.py).

`build_model` resolves the config, allocates the model on the target
device (quantized as --quantize says) and marks the trainables
requires_grad; `init_params` fills every parameter the way the Flax
initialisers do, and the int8 leaves as the JAX `randomize_quantized` does,
from a `torch.Generator` on that device; `build_train_state` and
`build_eval_state` add the tokenizer and the backbone.

The backbone comes from Meta's `consolidated.*.pth` shards under
`--llama_model_path`/`--model` (with its params.json) when they are there,
as the JAX `build_train_state` takes them (builder.py:100-196): each leaf
is merged from the memory-mapped shards, cast to bf16 and moved to the
model's device, one at a time (`ckpt.convert.load_meta_checkpoint`);
under an `*r` mode the rotation is folded into it (`ckpt.rotate`); a
quantized Linear is quantized from it there (`ckpt.quantize.
quantize_kernel`), so a quantized run never holds the bf16 backbone on the
card. A frozen leaf the checkpoint lacks keeps its random init, with a
warning; extra checkpoint keys are ignored. A directory with the JAX
converter's `model.flax.safetensors` and no shards loads from that file the
same way (`ckpt.convert.load_flax_safetensors`, without the safetensors
package, which the card's image lacks), its config from a params.json
beside it, else from the preset, as in JAX; where both are there the
shards are read. With no checkpoint the backbone stays at random init,
with the JAX builder's warning.

Under a mesh every rank builds the same full tree from the seed (random
weights, or the checkpoint) and then keeps its piece of each tp-split leaf
(`model.parallel.parallelize`, leaf by leaf through `core.mesh.
shard_leaf`), so no rank holds two full copies. Under pp (`validate_pp`
first, as JAX's builder: builder.py:64-68) a rank never allocates the
frozen leaves of another stage's blocks (`model.parallel.materialize`):
their random init is drawn into one transient leaf at a time and freed,
so that the kept leaves are the single rank's, and the checkpoint's are
not read.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from pathlib import Path
from typing import List, Optional

import torch

from ..ckpt.convert import (SAFETENSORS_NAME, checkpoint_shards,
                            load_flax_safetensors, load_meta_checkpoint)
from ..ckpt.quantize import quantize_kernel, randomize_quantized
from ..ckpt.rotate import Rotation, fold_leaf
from ..core.config import (MODEL_PRESETS, ModelConfig, RunConfig,
                           check_train_ported, model_quant_kwargs,
                           validate_pp)
from ..model.llama import FlippedVQAModel, Linear
from ..model.parallel import materialize, parallelize
from ..text import load_tokenizer
from .optim import is_trainable, trainable_parameters


# the frozen leaves with a dtype of their own: a quantized Linear's (out_w
# is in the frozen dtype) and the rotated modes' qav_rot
QUANT_LEAVES = {"kernel_q": torch.int8, "kernel_q4": torch.int8,
                "out_idx": torch.int32, "scale": torch.float32,
                "qav_rot": torch.float32}


def model_dir(run_cfg: RunConfig) -> Path:
    return Path(run_cfg.llama_model_path) / run_cfg.model_name


def tokenizer_path(run_cfg: RunConfig) -> str:
    return run_cfg.tokenizer_path or os.path.join(run_cfg.llama_model_path,
                                                  "tokenizer.model")


def resolve_model_config(run_cfg: RunConfig) -> ModelConfig:
    """params.json under llama_model_path/model_name (its vocab_size -1 is
    the tokenizer's), else the preset; the adapter window is clamped to the
    model depth (JAX: builder.py:24-46)."""
    name = run_cfg.model_name.replace("_adapter", "")
    params_json = model_dir(run_cfg) / "params.json"
    overrides = dict(
        max_seq_len=run_cfg.data.max_seq_len,
        adapter_len=run_cfg.model.adapter_len,
        adapter_layer=run_cfg.model.adapter_layer,
        max_feats=run_cfg.model.max_feats, bias=run_cfg.model.bias,
        tau=run_cfg.model.tau, audio_merge=run_cfg.model.audio_merge)
    if params_json.exists():
        cfg = ModelConfig.from_params_json(str(params_json),
                                           tokenizer_path(run_cfg),
                                           **overrides)
    elif (preset := MODEL_PRESETS.get(name)) is not None:
        cfg = ModelConfig(**{**preset, **overrides})
    else:
        cfg = run_cfg.model
    if cfg.adapter_layer > cfg.n_layers:
        cfg = dataclasses.replace(cfg, adapter_layer=cfg.n_layers)
    return cfg


def build_model(run_cfg: RunConfig, device, dtype=torch.bfloat16,
                mesh=None):
    """→ (model with uninitialised parameters on `device`, trainables
    marked requires_grad, cfg) (JAX: builder.py:49-75); under a `mesh`
    with pp > 1 only the leaves this rank's stage keeps are allocated."""
    quant = model_quant_kwargs(run_cfg.train.quantize)
    cfg = resolve_model_config(run_cfg)
    validate_pp(run_cfg.mesh, cfg, run_cfg.train.is_generation_task)
    model = FlippedVQAModel(cfg, dtype=dtype, frozen_dtype=dtype,
                            trainable_dtype=torch.float32,
                            device=torch.device("meta"),
                            use_flash=run_cfg.train.flash_attention, **quant)
    materialize(model, torch.device(device), mesh)
    model.pp_microbatches = run_cfg.mesh.pp_microbatches
    trainable_parameters(model)
    return model, cfg


def lecun_normal_(p: torch.Tensor, g: torch.Generator) -> None:
    """Flax's `nn.Dense` default kernel init, `lecun_normal`: a normal of
    variance 1/fan_in truncated at two standard deviations (variance_scaling
    "truncated_normal": the std divided by 0.8796..., the std of N(0, 1)
    cut at ±2), by the inverse CDF as torch's `trunc_normal_` draws it, from
    `g`. `p` is (out, in)."""
    std = math.sqrt(1.0 / p.shape[1]) / 0.87962566103423978
    cdf = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
    p.uniform_(2 * cdf(-2.0) - 1, 2 * cdf(2.0) - 1, generator=g)
    p.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


@contextlib.contextmanager
def transient(model: FlippedVQAModel, named):
    """Give each of the (name, parameter) pairs that `model.dropped`
    names its full shape for the block, then free it again: the random
    init draws a dropped leaf's values, so that every kept leaf gets the
    single rank's."""
    held = [(p, model.dropped[n]) for n, p in named if n in model.dropped]
    for p, shape in held:
        p.data = p.data.new_empty(shape)
    try:
        yield
    finally:
        for p, _ in held:
            p.data = p.data.new_empty(0)


@torch.no_grad()
def init_params(model: FlippedVQAModel, seed: int = 0) -> None:
    """Fill every parameter in place, as the Flax initialisers do
    (JAX: llama.py:44-47, 426-444, 507-563): U(±1/√fan_in) for Linear
    weights (audio_proj and visual_proj included), lecun-normal for the
    cross-attention's Dense kernels and zeros for their biases, N(0, 1) for
    the embedding tables (tokens, adapter_query, temporal_emb), ones for
    the norms, zeros for gate1 and -bias for gate2, the identity for
    qav_rot; the quantized leaves by `randomize_quantized` (JAX:
    builder.py:191-196). The generator lives on the parameters' device, so
    a 7B init never leaves the card. A leaf of `model.dropped` (another
    pipeline stage's) is drawn into a transient tensor and freed."""
    g = torch.Generator(device=model.device).manual_seed(seed)
    for name, p in model.named_parameters():
        with transient(model, [(name, p)]):
            _init_leaf(model, name, p, g)
    for name, mod in model.named_modules():
        if isinstance(mod, Linear) and mod.quantized:
            with transient(model, [(f"{name}.{n}", p) for n, p in
                                   mod.named_parameters()]):
                randomize_quantized(mod, g)


def _init_leaf(model: FlippedVQAModel, name: str, p: torch.Tensor,
               g: torch.Generator) -> None:
    leaf = name.rsplit(".", 1)[-1]
    if name == "qav_rot":
        p.copy_(torch.eye(p.shape[0], dtype=p.dtype, device=p.device))
    elif leaf in QUANT_LEAVES or leaf == "out_w":
        return              # randomize_quantized
    elif name.endswith("gate1"):
        p.zero_()
    elif name.endswith("gate2"):
        p.fill_(-model.cfg.bias)
    elif name.endswith("norm.weight"):
        p.fill_(1.0)
    elif name.split(".")[0] in ("tok_embeddings", "adapter_query",
                                "temporal_emb"):
        p.normal_(0.0, 1.0, generator=g)
    elif leaf == "bias":
        p.zero_()
    elif name.startswith("video_audio_cross_attn."):
        lecun_normal_(p, g)
    elif leaf == "weight" and p.dim() == 2:
        bound = 1.0 / math.sqrt(p.shape[1])
        p.uniform_(-bound, bound, generator=g)
    else:
        raise ValueError(f"no initialiser for parameter {name}")


def check_dtype_policy(model: FlippedVQAModel, frozen_dtype) -> None:
    """Trainables f32, the frozen backbone in `frozen_dtype`, except the
    leaves of QUANT_LEAVES: kernel_q and kernel_q4 int8, out_idx int32,
    scale and qav_rot f32."""
    for name, p in model.named_parameters():
        want = (torch.float32 if is_trainable(name) else
                QUANT_LEAVES.get(name.rsplit(".", 1)[-1], frozen_dtype))
        if p.dtype != want:
            raise TypeError(f"{name} is {p.dtype}, the policy wants {want}")


def find_checkpoint(run_cfg: RunConfig) -> Optional[Path]:
    """The directory of Meta shards, or of the JAX converter's
    `model.flax.safetensors`, to load, or None (synthetic run)."""
    path = model_dir(run_cfg)
    if checkpoint_shards(path) or (path / SAFETENSORS_NAME).exists():
        return path
    return None


def checkpoint_leaves(path, names=None, device="cpu", skip=None):
    """(name, bf16 tensor on `device`) for each leaf of the checkpoint
    under `path`, in the port's names and layout: Meta's shards, else the
    converted safetensors file."""
    if checkpoint_shards(path):
        return load_meta_checkpoint(path, names, device, skip)
    return load_flax_safetensors(Path(path) / SAFETENSORS_NAME, names,
                                 device, skip)


def _quantize_args(linear: Linear) -> dict:
    """quantize_kernel's arguments for a quantized Linear, read off its
    leaves' shapes as the JAX graft does (builder.py:160-170): the group
    is K over the scale's rows (the port's kernel_q/kernel_q4 are (N, K)
    and (N/2, K))."""
    if linear.weight_bits == 4:
        return {"group": linear.kernel_q4.shape[1] // linear.scale.shape[0],
                "bits": 4}
    return {"group": (linear.kernel_q.shape[1] // linear.scale.shape[0]
                      if linear.scale.dim() == 2 else 0),
            "outliers": (linear.out_w.shape[0] if linear.quant_outliers
                         else 0)}


def _put(param: torch.Tensor, name: str, value: torch.Tensor) -> None:
    if param.shape != value.shape:
        raise ValueError(f"checkpoint leaf {name} is {tuple(value.shape)}, "
                         f"the model's {tuple(param.shape)}")
    param.copy_(value)


@torch.no_grad()
def load_checkpoint(model: FlippedVQAModel, path) -> List[str]:
    """Graft the checkpoint under `path` (Meta's shards or the converted
    safetensors file, `checkpoint_leaves`) into the frozen leaves of
    `model`, leaf by leaf on its device: rotated first under an `*r` mode,
    quantized into a quantized Linear's leaves; the leaves of
    `model.dropped` (another pipeline stage's blocks) are not read. → the
    frozen leaves it did not fill, which keep their values."""
    cfg = model.cfg
    params = dict(model.named_parameters())
    modules = dict(model.named_modules())
    frozen = {n for n, p in params.items()
              if not p.requires_grad and n not in model.dropped}
    # the modules of another stage's leaves: their checkpoint leaves
    dropped = {n.rsplit(".", 1)[0] for n in model.dropped}
    device = model.device
    rot = gammas = None
    if model.rotated:
        print("folding residual-stream rotation into the checkpoint "
              "(--quantize *r)")
        norms = [f"layers.{i}.{k}.weight" for i in range(cfg.n_layers)
                 for k in ("attention_norm", "ffn_norm")]
        gammas = dict(checkpoint_leaves(path, norms + ["norm.weight"],
                                        device))
        if "norm.weight" not in gammas:
            raise ValueError("final norm.weight missing — needed for the "
                             "output head fold and qav_rot")
        rot = Rotation(cfg.dim, device=device)
    filled = set()
    for name, t in checkpoint_leaves(
            path, device=device,
            skip=lambda n: n.rsplit(".", 1)[0] in dropped):
        base = name[:-len(".weight")]
        linear = modules.get(base)
        quantized = isinstance(linear, Linear) and linear.quantized
        if name not in params and not quantized:
            continue                         # not a leaf of this model
        if rot is not None:
            t = fold_leaf(rot, name, t, gammas, cfg.n_layers,
                          cfg.adapter_layer)
        if quantized:
            for leaf, v in quantize_kernel(t, **_quantize_args(
                    linear)).items():
                _put(getattr(linear, leaf), f"{base}.{leaf}", v)
                filled.add(f"{base}.{leaf}")
        else:
            _put(params[name], name, t)
            filled.add(name)
        del t
    if rot is not None:
        model.qav_rot.copy_(rot.conjugate_diag(gammas["norm.weight"]))
        filled.add("qav_rot")
    return sorted(frozen - filled)


def build_eval_state(run_cfg: RunConfig, device, seed: int = 0,
                     dtype=torch.bfloat16, mesh=None):
    """→ (model, cfg, tokenizer) with the model's parameters initialised
    and, where there is a checkpoint, its frozen backbone loaded; under a
    `mesh` (core/mesh.py) cut to this rank's pieces."""
    model, cfg = build_model(run_cfg, device, dtype, mesh)
    tok_path = tokenizer_path(run_cfg)
    tokenizer = load_tokenizer(tok_path if os.path.exists(tok_path) else "",
                               n_words=cfg.vocab_size)
    if tokenizer.n_words != cfg.vocab_size:
        raise ValueError(
            f"tokenizer vocab ({tokenizer.n_words}, from {tok_path}) != model "
            f"vocab_size ({cfg.vocab_size}): embedding lookups would go out "
            f"of bounds. Use a matching --model preset or --tokenizer_path.")
    path = find_checkpoint(run_cfg)
    init_params(model, seed)
    if path is None:
        print("WARNING: no LLaMA checkpoint found — frozen backbone stays "
              "randomly initialized (synthetic mode)")
    else:
        print(f"loading the checkpoint under {path}")
        missing = load_checkpoint(model, path)
        if missing:
            print(f"WARNING: checkpoint is missing {len(missing)} frozen "
                  f"leaves — they stay RANDOMLY initialized (first few: "
                  f"{missing[:5]}). The checkpoint is likely incomplete.")
    check_dtype_policy(model, dtype)
    if mesh is not None:
        parallelize(model, mesh)
    return model, cfg, tokenizer


def build_train_state(run_cfg: RunConfig, device, seed: int = 0,
                      dtype=torch.bfloat16, mesh=None):
    """→ (model, cfg, tokenizer) for training: parameters initialised,
    trainables requires_grad, blocks rematerialised unless --no_remat, in
    groups of --remat_group, under --remat_policy (JAX: builder.py:113-209).
    The audio trainables, which no Meta shard holds, keep their init, as
    visual_proj does."""
    check_train_ported(run_cfg.train)
    model, cfg, tokenizer = build_eval_state(run_cfg, device, seed, dtype,
                                             mesh)
    model.remat = run_cfg.train.remat
    model.remat_group = run_cfg.train.remat_group
    model.remat_policy = run_cfg.train.remat_policy
    return model, cfg, tokenizer
