"""Model assembly (JAX: flipped_tpu/train/builder.py).

`build_model` resolves the config, allocates the model on the target
device (quantized as --quantize says) and marks the trainables
requires_grad; `init_params` fills every parameter the way the Flax
initialisers do, and the int8 leaves as the JAX `randomize_quantized` does,
from a `torch.Generator` on that device; `build_train_state` and
`build_eval_state` add the tokenizer.
Loading a Meta or safetensors checkpoint is not ported yet: a run without
one keeps the frozen backbone at random init, with the same warning as the
JAX builder, and a run that finds one raises rather than ignore it.
"""
from __future__ import annotations

import dataclasses
import math
import os
from pathlib import Path

import torch

from ..ckpt.quantize import randomize_quantized
from ..core.config import (MODEL_PRESETS, ModelConfig, RunConfig,
                           check_train_ported, model_quant_kwargs)
from ..model.llama import FlippedVQAModel
from ..text import load_tokenizer
from .optim import is_trainable, trainable_parameters


# the frozen leaves with a dtype of their own: a quantized Linear's (out_w
# is in the frozen dtype) and the rotated modes' qav_rot
QUANT_LEAVES = {"kernel_q": torch.int8, "kernel_q4": torch.int8,
                "out_idx": torch.int32, "scale": torch.float32,
                "qav_rot": torch.float32}


def resolve_model_config(run_cfg: RunConfig) -> ModelConfig:
    """params.json under llama_model_path/model_name, else the preset; the
    adapter window is clamped to the model depth (JAX: builder.py:24-46)."""
    name = run_cfg.model_name.replace("_adapter", "")
    model_dir = Path(run_cfg.llama_model_path) / run_cfg.model_name
    overrides = dict(
        max_seq_len=run_cfg.data.max_seq_len,
        adapter_len=run_cfg.model.adapter_len,
        adapter_layer=run_cfg.model.adapter_layer,
        max_feats=run_cfg.model.max_feats, bias=run_cfg.model.bias,
        tau=run_cfg.model.tau, audio_merge=run_cfg.model.audio_merge)
    if (model_dir / "params.json").exists():
        cfg = ModelConfig.from_params_json(str(model_dir / "params.json"),
                                           **overrides)
    elif (preset := MODEL_PRESETS.get(name)) is not None:
        cfg = ModelConfig(**{**preset, **overrides})
    else:
        cfg = run_cfg.model
    if cfg.adapter_layer > cfg.n_layers:
        cfg = dataclasses.replace(cfg, adapter_layer=cfg.n_layers)
    return cfg


def build_model(run_cfg: RunConfig, device, dtype=torch.bfloat16):
    """→ (model with uninitialised parameters on `device`, trainables
    marked requires_grad, cfg) (JAX: builder.py:49-75)."""
    quant = model_quant_kwargs(run_cfg.train.quantize)
    cfg = resolve_model_config(run_cfg)
    model = FlippedVQAModel(cfg, dtype=dtype, frozen_dtype=dtype,
                            trainable_dtype=torch.float32,
                            device=torch.device(device), **quant)
    trainable_parameters(model)
    return model, cfg


@torch.no_grad()
def init_params(model: FlippedVQAModel, seed: int = 0) -> None:
    """Fill every parameter in place, as the Flax initialisers do
    (JAX: llama.py:44-47, 507-543): U(±1/√fan_in) for Linear weights,
    N(0, 1) for the embedding tables (tokens, adapter_query, temporal_emb),
    ones for the norms, zeros for gate1 and -bias for gate2, the identity
    for qav_rot; the quantized leaves by `randomize_quantized` (JAX:
    builder.py:191-196). The generator lives on the parameters' device, so
    a 7B init never leaves the card."""
    g = torch.Generator(device=model.device).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name == "qav_rot":
            p.copy_(torch.eye(p.shape[0], dtype=p.dtype, device=p.device))
        elif leaf in QUANT_LEAVES or leaf == "out_w":
            continue            # randomize_quantized below
        elif name.endswith("gate1"):
            p.zero_()
        elif name.endswith("gate2"):
            p.fill_(-model.cfg.bias)
        elif name.endswith("norm.weight"):
            p.fill_(1.0)
        elif name.split(".")[0] in ("tok_embeddings", "adapter_query",
                                    "temporal_emb"):
            p.normal_(0.0, 1.0, generator=g)
        elif leaf == "weight" and p.dim() == 2:
            bound = 1.0 / math.sqrt(p.shape[1])
            p.uniform_(-bound, bound, generator=g)
        else:
            raise ValueError(f"no initialiser for parameter {name}")
    randomize_quantized(model, g)


def check_dtype_policy(model: FlippedVQAModel, frozen_dtype) -> None:
    """Trainables f32, the frozen backbone in `frozen_dtype`, except the
    leaves of QUANT_LEAVES: kernel_q and kernel_q4 int8, out_idx int32,
    scale and qav_rot f32."""
    for name, p in model.named_parameters():
        want = (torch.float32 if is_trainable(name) else
                QUANT_LEAVES.get(name.rsplit(".", 1)[-1], frozen_dtype))
        if p.dtype != want:
            raise TypeError(f"{name} is {p.dtype}, the policy wants {want}")


def _checkpoint_files(run_cfg: RunConfig):
    model_dir = Path(run_cfg.llama_model_path) / run_cfg.model_name
    return (sorted(model_dir.glob("*.pth"))
            + sorted(model_dir.glob("*.safetensors")))


def build_eval_state(run_cfg: RunConfig, device, seed: int = 0,
                     dtype=torch.bfloat16):
    """→ (model, cfg, tokenizer) with the model's parameters initialised."""
    model, cfg = build_model(run_cfg, device, dtype)
    tok_path = run_cfg.tokenizer_path or os.path.join(
        run_cfg.llama_model_path, "tokenizer.model")
    tokenizer = load_tokenizer(tok_path if os.path.exists(tok_path) else "",
                               n_words=cfg.vocab_size)
    if tokenizer.n_words != cfg.vocab_size:
        raise ValueError(
            f"tokenizer vocab ({tokenizer.n_words}, from {tok_path}) != model "
            f"vocab_size ({cfg.vocab_size}): embedding lookups would go out "
            f"of bounds. Use a matching --model preset or --tokenizer_path.")
    if _checkpoint_files(run_cfg):
        raise NotImplementedError(
            f"found a LLaMA checkpoint under {run_cfg.llama_model_path}: "
            f"loading Meta/safetensors checkpoints is not ported yet")
    init_params(model, seed)
    check_dtype_policy(model, dtype)
    print("WARNING: no LLaMA checkpoint found — frozen backbone stays "
          "randomly initialized (synthetic mode)")
    return model, cfg, tokenizer


def build_train_state(run_cfg: RunConfig, device, seed: int = 0,
                      dtype=torch.bfloat16):
    """→ (model, cfg, tokenizer) for training: parameters initialised,
    trainables requires_grad, blocks rematerialised unless --no_remat, in
    groups of --remat_group (JAX: builder.py:113-209). Refuses the training
    options the port does not run yet."""
    check_train_ported(run_cfg.train)
    model, cfg, tokenizer = build_eval_state(run_cfg, device, seed, dtype)
    model.remat = run_cfg.train.remat
    model.remat_group = run_cfg.train.remat_group
    return model, cfg, tokenizer
