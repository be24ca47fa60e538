"""Configuration for the evaluate path (JAX counterpart: flipped_tpu/core/config.py).

The dataclasses keep the JAX package's field names, so the JAX package's
numpy-only dataset readers (`flipped_tpu.data.build_dataset`), which read
attributes only, accept the port's `DataConfig` as they are. Only the
fields the classification eval reads are ported; the training fields come
with the training slice.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters of the adapter-gated LLaMA; defaults are
    LLaMA-7B (JAX: core/config.py:18-66)."""

    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    vocab_size: int = 32000
    multiple_of: int = 256
    norm_eps: float = 1e-6
    max_seq_len: int = 128
    adapter_len: int = 10
    adapter_layer: int = 32
    max_feats: int = 10
    visual_dim: int = 768
    bias: float = 3.0
    tau: float = 100.0
    rope_theta: float = 10000.0
    audio_merge: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def ffn_hidden(self) -> int:
        hidden = int(2 * (4 * self.dim) / 3)
        return self.multiple_of * ((hidden + self.multiple_of - 1)
                                   // self.multiple_of)

    @classmethod
    def from_params_json(cls, path: str, **overrides) -> "ModelConfig":
        with open(path) as f:
            params = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        merged = {k: v for k, v in params.items() if k in known}
        merged.update(overrides)
        return cls(**merged)


MODEL_PRESETS = {
    "tiny": dict(dim=64, n_layers=2, n_heads=4, vocab_size=512, multiple_of=32),
    "small": dict(dim=256, n_layers=2, n_heads=4, multiple_of=32),
    "llama7B": dict(dim=4096, n_layers=32, n_heads=32),
    "llama13B": dict(dim=5120, n_layers=40, n_heads=40),
    "llama33B": dict(dim=6656, n_layers=60, n_heads=52),
}

# The JAX package's --quantize grammar (core/config.py:292-296). Only 'none'
# runs in the port so far; every other mode raises in check_quantize.
QUANTIZE_CHOICES = ("none", "int8", "w8a8", "int8g", "w8a8g", "int8o",
                    "w8a8o", "int8r", "w8a8r", "int4", "w4a8", "int4r",
                    "w4a8r", "w8a8d", "w8a8rd")


def check_quantize(mode: str) -> None:
    if mode not in QUANTIZE_CHOICES:
        raise ValueError(f"unknown --quantize mode {mode!r}")
    if mode != "none":
        raise NotImplementedError(
            f"--quantize {mode}: not ported yet (only 'none' runs in "
            f"flipped_tpu_torch)")


@dataclass(frozen=True)
class DataConfig:
    """Dataset and batching (JAX: core/config.py:82-102)."""

    dataset: str = "nextqa"
    data_root: str = "./data"
    batch_size: int = 8
    max_seq_len: int = 128
    max_feats: int = 10
    sub: bool = False
    audio: bool = False
    audio_only: bool = False
    audio_merge: str = "none"
    is_generation_task: bool = False
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig:
    """The eval fields of the JAX TrainConfig (core/config.py:105-150)."""

    is_generation_task: bool = False
    seed: int = 0
    resume: str = ""
    quantize: str = "none"


@dataclass
class RunConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    llama_model_path: str = "./pretrained/llama/"
    model_name: str = "llama7B"
    tokenizer_path: str = ""
    debug: bool = False
    device: str = "cuda"


def get_args_parser() -> argparse.ArgumentParser:
    """The evaluate subset of the JAX parser (core/config.py:227-325), with
    the same flag names, plus --device."""
    p = argparse.ArgumentParser("flipped_tpu_torch evaluate", add_help=False)
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--llama_model_path", default="./pretrained/llama/", type=str)
    p.add_argument("--tokenizer_path", default="", type=str)
    p.add_argument("--model", default="llama7B", type=str)
    p.add_argument("--adapter_layer", type=int, default=32)
    p.add_argument("--adapter_len", type=int, default=10)
    p.add_argument("--max_seq_len", type=int, default=128)
    p.add_argument("--max_feats", type=int, default=10)
    p.add_argument("--dataset", default="nextqa", type=str)
    p.add_argument("--data_root", default="./data", type=str)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--resume", default="")
    p.add_argument("--bias", type=float, default=3.0)
    p.add_argument("--tau", type=float, default=100.0)
    p.add_argument("--sub", action="store_true")
    p.add_argument("--is_generation_task", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--audio", action="store_true")
    p.add_argument("--audio_only", action="store_true")
    p.add_argument("--audio_merge", type=str, default="none",
                   choices=["sum", "concat", "attention", "none"])
    p.add_argument("--quantize", default="none", choices=QUANTIZE_CHOICES)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device to run on: cuda, cuda:N or cpu")
    return p


def validate_audio_flags(audio: bool, audio_only: bool,
                         audio_merge: str) -> Optional[str]:
    """(JAX: core/config.py:328-341)"""
    if audio_only and not audio:
        raise ValueError("audio_only requires audio")
    if audio and audio_only:
        if audio_merge not in ("none", None):
            raise ValueError("audio_only must not specify a merge method")
        return "audio_only"
    if audio:
        if audio_merge not in ("sum", "concat", "attention"):
            raise ValueError("audio without audio_only requires a merge method")
        return audio_merge
    return None


def run_config_from_args(args: argparse.Namespace) -> RunConfig:
    merge = validate_audio_flags(args.audio, args.audio_only, args.audio_merge)
    name = args.model.replace("_adapter", "")
    if name not in MODEL_PRESETS:
        raise ValueError(f"unknown --model '{args.model}' — choose from "
                         f"{sorted(MODEL_PRESETS)}")
    model = ModelConfig(
        max_seq_len=args.max_seq_len, adapter_len=args.adapter_len,
        adapter_layer=args.adapter_layer, max_feats=args.max_feats,
        bias=args.bias, tau=args.tau, audio_merge=merge,
        **MODEL_PRESETS[name])
    data = DataConfig(
        dataset=args.dataset, data_root=args.data_root,
        batch_size=args.batch_size, max_seq_len=args.max_seq_len,
        max_feats=args.max_feats, sub=args.sub,
        audio=args.audio, audio_only=args.audio_only,
        audio_merge=args.audio_merge,
        is_generation_task=args.is_generation_task, seed=args.seed)
    train = TrainConfig(
        is_generation_task=args.is_generation_task, seed=args.seed,
        resume=args.resume, quantize=args.quantize)
    return RunConfig(model=model, data=data, train=train,
                     llama_model_path=args.llama_model_path,
                     model_name=args.model,
                     tokenizer_path=args.tokenizer_path, debug=args.debug,
                     device=args.device)
