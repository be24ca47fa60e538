"""Configuration of the train and evaluate CLIs (JAX counterpart:
flipped_tpu/core/config.py).

The dataclasses and flags keep the JAX package's names and defaults, so a
reference run script translates one to one. Every training option runs on
one card: the audio merges, both remat policies, --trace_dir and both
loaders. The mesh flags --dp, --pp, --sp and --tp lay the ranks of a
torch.distributed run out on a (dp, pp, sp, tp) grid (`MeshConfig`,
core/mesh.py), and --pp_microbatches sets the pipeline's microbatch count
(model/pipeline.py); `validate_pp` refuses what the pipeline cannot run,
with JAX's messages. `quant_flags` decodes a --quantize mode as the JAX
package does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional

from ..text import load_tokenizer


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
    audio_dim: int = 1024
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
    def from_params_json(cls, path: str, tokenizer_path: str = "",
                         **overrides) -> "ModelConfig":
        """Meta's params.json, as the reference builds ModelArgs
        (llama_vqa.py:8-9, 61-62): a `vocab_size` of -1, which Meta's
        published files carry, is the vocabulary of the tokenizer at
        `tokenizer_path`, and without one it raises. The JAX
        `from_params_json` passes the -1 through (a divergence, ROADMAP
        Queue 3)."""
        with open(path) as f:
            params = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        merged = {k: v for k, v in params.items() if k in known}
        if merged.get("vocab_size", 0) < 0:
            if not (tokenizer_path and os.path.exists(tokenizer_path)):
                raise ValueError(
                    f"{path} has vocab_size {merged['vocab_size']}, which "
                    f"means the tokenizer's vocabulary, but there is no "
                    f"tokenizer at {tokenizer_path!r}: pass --tokenizer_path "
                    f"or put tokenizer.model under --llama_model_path")
            merged["vocab_size"] = load_tokenizer(tokenizer_path).n_words
        merged.update(overrides)
        return cls(**merged)


MODEL_PRESETS = {
    "tiny": dict(dim=64, n_layers=2, n_heads=4, vocab_size=512, multiple_of=32),
    "small": dict(dim=256, n_layers=2, n_heads=4, multiple_of=32),
    "llama7B": dict(dim=4096, n_layers=32, n_heads=32),
    "llama13B": dict(dim=5120, n_layers=40, n_heads=40),
    "llama33B": dict(dim=6656, n_layers=60, n_heads=52),
}

# The JAX package's --quantize grammar (core/config.py:292-296); every mode
# runs on one card.
# the trainables, by parameter name (train/optim.py); the rest is frozen
TRAINABLE_MARKERS = ("gate", "adapter", "temporal_emb", "visual_proj",
                     "audio_proj", "video_audio_cross_attn")


def is_trainable(name: str) -> bool:
    return any(m in name for m in TRAINABLE_MARKERS)


QUANTIZE_CHOICES = ("none", "int8", "w8a8", "int8g", "w8a8g", "int8o",
                    "w8a8o", "int8r", "w8a8r", "int4", "w4a8", "int4r",
                    "w4a8r", "w8a8d", "w8a8rd")


def check_quantize(mode: str) -> None:
    if mode not in QUANTIZE_CHOICES:
        raise ValueError(f"unknown --quantize mode {mode!r}")


def model_quant_kwargs(mode: str) -> dict:
    """The FlippedVQAModel kwargs of a --quantize mode: the seven
    `quant_flags` keys."""
    check_quantize(mode)
    return quant_flags(mode)


def quant_flags(mode: str) -> dict:
    """--quantize mode → FlippedVQAModel quantization kwargs, the JAX
    grammar with the same keys (JAX: core/config.py:153-181): int8/w8a8
    base, 'g' = grouped 128-wide scales, 'o' = grouped plus bf16 outlier
    rows, 'r' = rotation fold, int4/w4a8 = packed 4-bit, trailing 'd' =
    int8 dgrad (per-channel w8a8 only)."""
    dgrad = mode.endswith("d") and mode != "none"
    if dgrad:
        if mode not in ("w8a8d", "w8a8rd"):
            raise ValueError(
                f"--quantize {mode}: the 'd' (quantized-dgrad) suffix "
                f"composes only with per-channel w8a8 (w8a8d|w8a8rd)")
        mode = mode[:-1]
    bits4 = mode in ("int4", "w4a8", "int4r", "w4a8r")
    return {
        "quantized": mode != "none",
        "act_quant": mode.startswith(("w8a8", "w4a8")),
        "weight_bits": 4 if bits4 else 8,
        "quant_group": 128 if (bits4 or mode[-1:] in ("g", "o")) else 0,
        "quant_outliers": mode.endswith("o"),
        "rotated": mode.endswith("r"),
        "dgrad_quant": dgrad,
    }


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
    """Optimizer, schedule and objective configuration
    (JAX: core/config.py:105-150)."""

    epochs: int = 5
    warmup_epochs: float = 2.0
    accum_iter: int = 1
    blr: float = 9e-2
    lr: Optional[float] = None  # absolute lr; derived from blr when None
    min_lr: float = 0.0
    weight_decay: float = 0.14
    vaq: bool = False           # VQA is always on
    qav: bool = False
    is_generation_task: bool = False
    seed: int = 0
    output_dir: str = "./output_dir"
    resume: str = ""
    start_epoch: int = 0
    clip_grad: Optional[float] = None
    remat: bool = True          # recompute each block in the backward
    remat_policy: str = "full"
    remat_group: int = 1
    quantize: str = "none"
    lm_head_chunk: int = 0
    flash_attention: bool = True  # False: --no_flash, the einsum attention

    def absolute_lr(self, world_batch: int) -> float:
        # lr = blr * eff_batch / 256 (reference: train.py:104-107)
        if self.lr is not None:
            return self.lr
        return self.blr * world_batch / 256.0


# 'full' recomputes whole blocks in the backward; 'qkv' keeps the
# attention's outputs (model/llama.py `FlippedVQAModel`)
REMAT_POLICIES = ("full", "qkv")


def check_train_ported(train: "TrainConfig") -> None:
    """Refuse a training configuration the port cannot run: an unknown
    --quantize mode or remat policy."""
    check_quantize(train.quantize)
    if train.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown --remat_policy {train.remat_policy!r}")


@dataclass(frozen=True)
class MeshConfig:
    """The rank grid (JAX: core/config.py:185-210): dp data parallel (-1:
    every rank the other axes leave), pp pipeline stages, sp sequence
    parallel, tp tensor parallel (core/mesh.py); pp_microbatches the
    GPipe schedule's microbatch count (0: pp), shrunk to divide each
    rank's rows (model/pipeline.py `pick_microbatches`)."""

    dp: int = -1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    pp_microbatches: int = 0


def validate_pp(mesh_cfg: MeshConfig, cfg: ModelConfig,
                is_generation_task: bool = False) -> None:
    """Refuse a configuration the pipeline cannot run, with JAX's messages
    (flipped_tpu/model/pipeline.py:89-106): pp must divide n_layers, and
    every layer must be an adapter layer (a stage of skipped blocks would
    be empty). Generation runs under pp (the decode crosses the stage
    ring)."""
    pp = max(1, mesh_cfg.pp)
    if pp <= 1:
        return
    if cfg.n_layers % pp:
        raise ValueError(
            f"--pp {pp} must divide n_layers={cfg.n_layers} evenly "
            f"(stages would be ragged)")
    if cfg.adapter_layer != cfg.n_layers:
        raise ValueError(
            f"--pp requires adapter_layer == n_layers "
            f"(got {cfg.adapter_layer} != {cfg.n_layers}): the reference's "
            f"layer-window SKIPS early blocks entirely (model.py:338), which "
            f"would leave pipeline stages empty")
    del is_generation_task


@dataclass
class RunConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    llama_model_path: str = "./pretrained/llama/"
    model_name: str = "llama7B"
    tokenizer_path: str = ""
    debug: bool = False
    device: str = "cuda"



def get_args_parser() -> argparse.ArgumentParser:
    """The JAX parser (core/config.py:227-325) with the same names and
    defaults, plus --device. --dp, --pp, --sp and --tp make the rank grid
    (core/mesh.py `make_mesh`, which raises when it needs more ranks than
    the run has); --num_workers is the worker count of `--loader grain`
    (data/pipeline.py) and --trace_dir the train CLI's profiler trace."""
    p = argparse.ArgumentParser("flipped_tpu_torch", add_help=False)
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--epochs", default=5, type=int)
    p.add_argument("--accum_iter", default=1, type=int)
    p.add_argument("--llama_model_path", default="./pretrained/llama/", type=str)
    p.add_argument("--tokenizer_path", default="", type=str)
    p.add_argument("--model", default="llama7B", type=str)
    p.add_argument("--adapter_layer", type=int, default=32)
    p.add_argument("--adapter_len", type=int, default=10)
    p.add_argument("--max_seq_len", type=int, default=128)
    p.add_argument("--max_feats", type=int, default=10)
    p.add_argument("--weight_decay", type=float, default=0.14)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--blr", type=float, default=9e-2)
    p.add_argument("--min_lr", type=float, default=0.0)
    p.add_argument("--warmup_epochs", type=float, default=2.0)
    p.add_argument("--dataset", default="nextqa", type=str)
    p.add_argument("--data_root", default="./data", type=str)
    p.add_argument("--output_dir", default="./output_dir")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--resume", default="")
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--num_workers", default=2, type=int)
    p.add_argument("--vaq", action="store_true")
    p.add_argument("--qav", action="store_true")
    p.add_argument("--bias", type=float, default=3.0)
    p.add_argument("--tau", type=float, default=100.0)
    p.add_argument("--sub", action="store_true")
    p.add_argument("--is_generation_task", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--audio", action="store_true")
    p.add_argument("--audio_only", action="store_true")
    p.add_argument("--audio_merge", type=str, default="none",
                   choices=["sum", "concat", "attention", "none"])
    p.add_argument("--dp", type=int, default=-1)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--pp_microbatches", type=int, default=0)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--trace_dir", default="")
    p.add_argument("--loader", default="thread", choices=["thread", "grain"])
    p.add_argument("--remat_policy", default="full",
                   choices=list(REMAT_POLICIES))
    p.add_argument("--remat_group", type=int, default=1)
    p.add_argument("--quantize", default="none", choices=QUANTIZE_CHOICES)
    p.add_argument("--lm_head_chunk", type=int, default=0)
    p.add_argument("--no_remat", action="store_true")
    p.add_argument("--no_flash", action="store_true")
    p.add_argument("--clip_grad", type=float, default=None)
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
        epochs=args.epochs, warmup_epochs=args.warmup_epochs,
        accum_iter=args.accum_iter, blr=args.blr, lr=args.lr,
        min_lr=args.min_lr, weight_decay=args.weight_decay, vaq=args.vaq,
        qav=args.qav, is_generation_task=args.is_generation_task,
        seed=args.seed, output_dir=args.output_dir, resume=args.resume,
        start_epoch=args.start_epoch, clip_grad=args.clip_grad,
        remat=not args.no_remat, remat_policy=args.remat_policy,
        remat_group=args.remat_group, quantize=args.quantize,
        lm_head_chunk=args.lm_head_chunk,
        flash_attention=not args.no_flash)
    mesh = MeshConfig(dp=args.dp, pp=args.pp, sp=args.sp, tp=args.tp,
                      pp_microbatches=args.pp_microbatches)
    return RunConfig(model=model, data=data, train=train, mesh=mesh,
                     llama_model_path=args.llama_model_path,
                     model_name=args.model,
                     tokenizer_path=args.tokenizer_path, debug=args.debug,
                     device=args.device)
