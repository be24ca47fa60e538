"""The system under test: the port's model, built from a configuration
file and filled with the benchmark's draw.

The model is the one `flipped_tpu_torch.train.builder.build_model` makes
(the configuration is not a preset, so its `ModelConfig` is taken as
given); its frozen leaves are filled from `pbcore.weights`' draw, and a
quantized linear is quantized from that bf16 draw on the card by the
port's own `ckpt.quantize.quantize_kernel`, as its checkpoint path does.
"""
from __future__ import annotations

import torch

from . import weights


def model_config(config: dict, bias: float, max_seq_len: int):
    from flipped_tpu_torch.core.config import ModelConfig
    m, meth = config["model"], config["method"]
    cfg = ModelConfig(
        dim=m["dim"], n_layers=m["n_layers"], n_heads=m["n_heads"],
        vocab_size=m["vocab_size"], multiple_of=m["multiple_of"],
        norm_eps=m["norm_eps"], rope_theta=m["rope_theta"],
        max_seq_len=max_seq_len, adapter_len=meth["adapter_len"],
        adapter_layer=m["n_layers"], max_feats=meth["max_feats"],
        visual_dim=meth["visual_dim"], bias=bias, tau=meth["tau"])
    if cfg.ffn_hidden != config["intermediate_size"]:
        raise ValueError(f"ModelConfig gives ffn_hidden {cfg.ffn_hidden}, the "
                         f"configuration {config['intermediate_size']}")
    return cfg


# the traffic's keys that are the port's TrainConfig fields, by the same name
TRAIN_KEYS = ("epochs", "warmup_epochs", "accum_iter", "blr", "weight_decay",
              "vaq", "qav", "remat", "remat_policy")


def run_config(config: dict, t: dict, quantize: str):
    from flipped_tpu_torch.core.config import (DataConfig, RunConfig,
                                               TrainConfig)
    return RunConfig(
        model=model_config(config, t["bias"], t["max_seq_len"]),
        data=DataConfig(batch_size=t["batch_size"],
                        max_seq_len=t["max_seq_len"],
                        max_feats=config["method"]["max_feats"]),
        train=TrainConfig(quantize=quantize,
                          **{k: t[k] for k in TRAIN_KEYS if k in t}),
        llama_model_path="portbench/no-checkpoint", model_name=config["name"])


def _quantize_args(linear) -> dict:
    if linear.weight_bits == 4:
        return {"group": linear.kernel_q4.shape[1] // linear.scale.shape[0],
                "bits": 4}
    return {"group": (linear.kernel_q.shape[1] // linear.scale.shape[0]
                      if linear.scale.dim() == 2 else 0)}


@torch.no_grad()
def _put(model, name: str, w: torch.Tensor) -> None:
    """Copy the bf16 draw `w` of linear `name` into the model, quantized
    by the port where the linear is."""
    from flipped_tpu_torch.ckpt.quantize import quantize_kernel
    linear = model.get_submodule(name)
    if not getattr(linear, "quantized", False):
        linear.weight.copy_(w)
        return
    for leaf, v in quantize_kernel(w, **_quantize_args(linear)).items():
        getattr(linear, leaf).copy_(v)


@torch.no_grad()
def build(config: dict, t: dict, seed: int, device, quantize=None):
    """→ (model, run_cfg): the port's model with the seed's draw, at the
    configuration's --quantize mode unless `quantize` names another."""
    from flipped_tpu_torch.train.builder import build_model, check_dtype_policy
    run_cfg = run_config(config, t, quantize or config["quantize"])
    model, _ = build_model(run_cfg, device)
    dev = torch.device(device)
    m = dict(config["model"], ffn_hidden=config["intermediate_size"])
    emb = weights.draw_embeddings(m, seed, dev)
    model.tok_embeddings.weight.copy_(emb["tok_embeddings"])
    _put(model, "output", emb.pop("output"))
    del emb
    for i in range(m["n_layers"]):
        for leaf, w in weights.draw_layer(m, seed, i, dev).items():
            _put(model, f"layers.{i}.{leaf}", w)
        blk = model.layers[str(i)]
        blk.attention_norm.weight.fill_(1.0)
        blk.ffn_norm.weight.fill_(1.0)
    model.norm.weight.fill_(1.0)
    params = dict(model.named_parameters())
    for name, v in weights.draw_trainables(m, config["method"], t["bias"],
                                           seed, dev).items():
        params[name].copy_(v)
    check_dtype_policy(model, torch.bfloat16)
    model.remat = run_cfg.train.remat
    model.remat_policy = run_cfg.train.remat_policy
    return model, run_cfg


def to_device(batch: dict, device) -> dict:
    """The numeric arrays of a packed batch as tensors on `device`, as
    the port's `cli/evaluate.batch_to_device` gives them."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
