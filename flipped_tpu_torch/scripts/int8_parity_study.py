"""Quantized-vs-bf16 eval-decision parity study at real 7B shapes (JAX:
scripts/int8_parity_study.py).

Quantifies how far each `--quantize` mode of the frozen backbone perturbs
the classification decision (the argmin of the per-option scores,
reference: engine.py:87-93) and the training trajectory. Every phase
synthesizes the SAME backbone weights on the host (seeded numpy draws,
leaf by leaf, pushed to the device and freed, so peak host memory stays
about one leaf), so a comparison isolates the quantization error:

    phase bf16:  weights = bf16(w)
    phase w8a8:  weights = per-channel absmax int8 of the SAME bf16(w)

then every phase scores the same synthetic eval examples with the
prefix-shared cached scorer (or takes the same train steps), and the
report phase computes per-option score deltas, the argmin flip rate and
the decision-margin envelope (a flip needs a bf16 margin below the score
perturbation).

    python -m flipped_tpu_torch.scripts.int8_parity_study --phase bf16 --out DIR
    python -m flipped_tpu_torch.scripts.int8_parity_study --phase w8a8 --out DIR
    python -m flipped_tpu_torch.scripts.int8_parity_study --phase report --out DIR

On the CPU: `--device cpu --preset tiny`. The flags, phases, seeds and
output files (`scores_<phase><sfx>.npz`, `train_<phase><sfx>.npz`,
`report.json`, `report_train.json`) are the JAX script's, and so are the
numpy draws: `RandomState(weight_seed + 1)`, one draw per frozen matmul in
the Flax tree's leaf order (JAX's `jit(model.init)` returns its dicts with
sorted keys, so `layers_10` comes before `layers_2`), each in JAX's
(in, out) shape with fan-in `shape[0]`, then transposed into the port's
(out, in) weight; so a study run in either package draws the same
backbone. The draw is rounded to bf16, then quantized by
`ckpt.quantize.quantize_kernel`; the packed int4 leaves take the group of
their own scale's shape. Under the rotated phases (`*r`) the
residual-stream rotation (`ckpt.rotate.Rotation`, seed ROTATION_SEED) is
folded into the f32 draw before the bf16 rounding, on the study's device:
readers (wq, wk, wv, w1, w3, output) on their input axis, writers (wo,
w2) on their output axis, and `_rotate_residual_tensors` rotates
tok_embeddings, adapter_query, temporal_emb and visual_proj. The port's
Walsh-Hadamard transform is a butterfly where JAX's is two matmuls, so a
rotated bf16 leaf may differ from JAX's by one ulp in a few elements, and
by the f32 rounding of the sums where they cancel to a value far below
the leaf's scale (tests/test_torch_tools.py states the bound).

The trainables (adapters, gates, temporal_emb, visual_proj) and the
frozen leaves that are not matmul weights (tok_embeddings, the norms) keep
the port's `init_params(model, seed=weight_seed)`. These values differ
from JAX's Flax init, but every phase of one study shares them, which is
all the study needs.

The kernels run where the device is the card: every leg there runs the
hand-written kernels of its mode (K1 in every eval and train leg, K2 in
every train leg, K3 under w8a8*, K7 and K4 under w8a8g/w8a8o, K8 and K9
under int4*/w4a8*, K10 under w8a8d). On `--device cpu` every wrapper takes
its plain version, because its tensors are on the CPU. Nothing switches
from one to the other by itself.

`--cache DIR` keeps the finished (folded, quantized) leaves of a phase, so
that the draw runs once for the eval and the train legs of the same leaves
(and int8r/w8a8r, which share their leaves); `--synth_only` fills it on the
CPU without a card. The cache holds the port's leaves in the port's names
and layout: it is not shared with a cache of the JAX script.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..ckpt.convert import torch_name_to_flax_path
from ..ckpt.quantize import quantize_kernel
from ..ckpt.rotate import Rotation
from ..cli.evaluate import batch_to_device
from ..core.config import ModelConfig, TrainConfig, is_trainable, quant_flags
from ..data.batching import (add_accum_axis, make_synthetic_items,
                             pack_eval_batch, pack_train_batch)
from ..model.int8 import outlier_count
from ..model.llama import FlippedVQAModel, Linear
from ..model.parallel import materialize as allocate
from ..text import MockTokenizer
from ..train.builder import init_params
from ..train.optim import make_optimizer, trainable_parameters
from ..train.step import make_eval_step, make_train_step, required_eval_span

# Residual-stream role of each backbone matmul (for the 'outlier'
# ensemble): readers consume the residual basis on their input rows,
# writers produce it on their output columns. Amplifying one global set of
# residual channels in both reproduces the emergent-outlier structure of
# trained LLMs (LLM.int8(): ~0.1-0.5% of hidden dims at 20-100x magnitude).
_RESIDUAL_READERS = ("wq", "wk", "wv", "w1", "w3", "output")
_RESIDUAL_WRITERS = ("wo", "w2")
OUTLIER_FRAC = 0.005          # fraction of residual dims amplified
OUTLIER_RANGE = (10.0, 30.0)  # amplification factors (x channel RMS)
ROTATION_SEED = 999           # fixed across phases and legs
DISTS = ("gaussian", "student_t", "outlier")
PHASES = ("bf16", "int8", "w8a8", "w8a8d", "int8g", "w8a8g", "int8o",
          "w8a8o", "int8r", "w8a8r", "bf16r", "int4", "w4a8", "int4r",
          "w4a8r")
# the phases the reports compare against the bf16 baseline, in order
_COMPARED = ("int8", "w8a8", "w8a8d", "int8g", "w8a8g", "int8o", "w8a8o",
             "int8r", "w8a8r", "bf16r", "int4", "w4a8", "int4r", "w4a8r")


class _SynthCache:
    """Directory of synthesized (folded, quantized) leaves, one `.npy` a
    leaf under the port's parameter name; bf16 leaves are stored as int16
    views (numpy has no bfloat16). MANIFEST.json, written last, names each
    leaf's dtype and marks the directory complete."""

    def __init__(self, cache_dir: str):
        self.dir = cache_dir
        self.manifest_path = os.path.join(cache_dir, "MANIFEST.json")
        self.loading = os.path.exists(self.manifest_path)
        self.manifest: Dict[str, str] = {}
        if self.loading:
            with open(self.manifest_path) as f:
                self.manifest = json.load(f)

    def _fn(self, name: str) -> str:
        return os.path.join(self.dir, name + ".npy")

    def save(self, name: str, t: torch.Tensor) -> None:
        t = t.detach().cpu()
        dt = str(t.dtype).replace("torch.", "")
        os.makedirs(self.dir, exist_ok=True)
        np.save(self._fn(name), (t.view(torch.int16) if dt == "bfloat16"
                                 else t).numpy())
        self.manifest[name] = dt

    def load(self, name: str, device="cpu") -> torch.Tensor:
        t = torch.from_numpy(np.load(self._fn(name)))
        if self.manifest[name] == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(device)

    def keys_under(self, prefix: str):
        return sorted(k for k in self.manifest if k.startswith(prefix + "."))

    def finish(self) -> None:
        if not self.loading:
            os.makedirs(self.dir, exist_ok=True)
            with open(self.manifest_path, "w") as f:
                json.dump(self.manifest, f)


def frozen_linears(model: FlippedVQAModel):
    """[(name, Linear)] of the frozen matmuls, in the order the JAX walk
    visits their kernels: the Flax tree's keys sorted at every level."""
    found = [(n, m) for n, m in model.named_modules()
             if isinstance(m, Linear) and not is_trainable(n)]
    return sorted(found, key=lambda nm: torch_name_to_flax_path(
        nm[0] + ".weight").split("/"))


def kernel_shape(linear: Linear) -> tuple:
    """The (in, out) shape of the Flax kernel a Linear stands for (a packed
    int4 leaf at its unpacked shape)."""
    if linear.quantized and linear.weight_bits == 4:
        n_half, k = linear.kernel_q4.shape
        return k, 2 * n_half
    w = linear.kernel_q if linear.quantized else linear.weight
    return w.shape[1], w.shape[0]


def _synthesize_frozen(model: FlippedVQAModel, seed: int, quantize: bool,
                       dist: str = "gaussian", model_dim: int = 0,
                       group: int = 0, outliers: bool = False,
                       rot: Optional[Rotation] = None,
                       cache: Optional[_SynthCache] = None,
                       materialize: bool = True, device="cpu") -> None:
    """Replace every frozen matmul weight of `model` with a deterministic
    random weight (the same draws in every phase), as bf16 or as the
    quantized leaves of that bf16, leaf by leaf: each is drawn on the host,
    finished on `device` and copied into the model (and the cache), so
    peak host memory stays about one leaf. With a complete `cache` the
    finished leaves are read from it instead.

    dist: 'gaussian', 'student_t' (df 4 heavy tails, variance-normalized)
    or 'outlier' (gaussian plus one global set of amplified residual
    channels). `rot` folds the residual-stream rotation into each weight
    before the bf16 rounding (the norm weights are ones, so their folds
    are no-ops). materialize=False fills the cache only (the model may
    then live on the meta device)."""
    rs = np.random.RandomState(seed)
    if dist == "outlier":
        o_rs = np.random.RandomState(seed + 7919)   # same dims every phase
        n_o = max(1, int(OUTLIER_FRAC * model_dim))
        o_dims = np.sort(o_rs.choice(model_dim, size=n_o, replace=False))
        o_fac = o_rs.uniform(*OUTLIER_RANGE, size=n_o).astype(np.float32)

    def draw(shape, fan_in, name):
        if dist == "student_t":
            # df=4 student-t has variance df/(df-2)=2: normalized to the
            # gaussian ensemble's scale
            w = rs.standard_t(4, size=shape).astype(np.float32) / np.sqrt(2.0)
        else:
            w = rs.randn(*shape).astype(np.float32)
        w /= np.sqrt(fan_in)
        if dist == "outlier":
            if name in _RESIDUAL_READERS and shape[0] == model_dim:
                w[o_dims, :] *= o_fac[:, None]
            if name in _RESIDUAL_WRITERS and shape[-1] == model_dim:
                w[:, o_dims] *= o_fac[None, :]
        return w

    def finish(linear, name, w):
        """The (in, out) f32 draw → the Linear's leaves on `device`."""
        shape = w.shape
        t = torch.from_numpy(w).to(device).t()                # (out, in)
        if rot is not None:
            if name in _RESIDUAL_READERS and shape[0] == model_dim:
                t = rot.rotate(t, -1)
            elif name in _RESIDUAL_WRITERS and shape[-1] == model_dim:
                t = rot.rotate(t, 0)
        wb = t.to(torch.bfloat16).contiguous()    # the checkpoint's dtype
        del t
        if linear.quantized and linear.weight_bits == 4:
            # the group from the leaf's own scale shape (tiny configs fall
            # back to one group)
            g4 = shape[0] // linear.scale.shape[0]
            return quantize_kernel(wb, g4, 0, bits=4)
        if quantize:
            n_out = outlier_count(shape[0]) if outliers else 0
            return quantize_kernel(wb, group, n_out)
        return {"weight": wb}

    def put(linear, leaf, value):
        if materialize:
            getattr(linear, leaf).copy_(value)

    with torch.no_grad():
        for path, linear in frozen_linears(model):
            if cache is not None and cache.loading:
                for full in cache.keys_under(path):
                    put(linear, full[len(path) + 1:],
                        cache.load(full, device) if materialize else None)
                continue
            shape = kernel_shape(linear)
            name = path.rsplit(".", 1)[-1]
            for leaf, v in finish(linear, name,
                                  draw(shape, shape[0], name)).items():
                if cache is not None:
                    cache.save(f"{path}.{leaf}", v)
                put(linear, leaf, v)
    if cache is not None:
        cache.finish()


def _rotate_residual_tensors(model: FlippedVQAModel, rot: Rotation) -> None:
    """Rotate the non-matmul tensors that live in the residual basis, so
    the rotated phase is the same model as the bf16 phase: tok_embeddings
    (frozen) and adapter_query, temporal_emb and visual_proj (trainable, at
    their init). The norm weights are ones, so the adapter's division by
    γ is a no-op and a'_l = a_l R."""
    with torch.no_grad():
        for leaf in (model.tok_embeddings.weight, model.adapter_query.weight,
                     model.temporal_emb.weight):
            leaf.copy_(rot.rotate(leaf, -1).to(leaf.dtype))
        vp = getattr(model, "visual_proj", None)
        if vp is not None:               # (dim, visual_dim): its out axis
            vp.weight.copy_(rot.rotate(vp.weight, 0).to(vp.weight.dtype))


def _flags_for(args) -> dict:
    flags = quant_flags("none" if args.phase in ("bf16", "bf16r")
                        else args.phase)
    if args.phase == "bf16r":
        flags["rotated"] = True
    return flags


def _cache_for(args, flags) -> Optional[_SynthCache]:
    """One synthesis cache directory per (ensemble, seed, leaf content):
    int8r/w8a8r share one (act-quant is a runtime flag), as do the eval and
    train legs (same weight_seed)."""
    if not args.cache:
        return None
    tag = (f"{args.weights}_s{args.weight_seed + 1}_"
           + ("bf16" if not flags["quantized"]
              else f"q{flags['quant_group']}"
              + ("b4" if flags.get("weight_bits", 8) == 4 else "")
              + ("o" if flags["quant_outliers"] else ""))
           + ("r" if flags["rotated"] else ""))
    return _SynthCache(os.path.join(args.cache, tag))


def _config(args) -> ModelConfig:
    if args.preset == "7b":
        return ModelConfig(dim=4096, n_layers=32, n_heads=32,
                           vocab_size=32000, multiple_of=256, max_seq_len=128,
                           adapter_len=10, adapter_layer=32, max_feats=10,
                           bias=3.5, tau=100.0)
    if args.preset == "small":
        # a CPU-runnable scale where outlier incoherence already shows
        # (dim 512 spreads an outlier by √512 ≈ 23x)
        return ModelConfig(dim=512, n_layers=4, n_heads=8, vocab_size=4096,
                           multiple_of=64, max_seq_len=128, adapter_len=10,
                           adapter_layer=4, max_feats=10, visual_dim=16)
    return ModelConfig(dim=64, n_layers=2, n_heads=4, vocab_size=512,
                       multiple_of=32, max_seq_len=128, adapter_len=10,
                       adapter_layer=2, max_feats=10, visual_dim=16)


def _sfx(args) -> str:
    """Output-file suffix per weight ensemble ('' for gaussian)."""
    return "" if args.weights == "gaussian" else f"_{args.weights}"


def _model(cfg: ModelConfig, flags: dict, device) -> FlippedVQAModel:
    """The study's model on `device` (meta: shapes only), trainables marked
    requires_grad, parameters uninitialised."""
    model = FlippedVQAModel(cfg, dtype=torch.bfloat16,
                            frozen_dtype=torch.bfloat16,
                            trainable_dtype=torch.float32,
                            device=torch.device("meta"), **flags)
    if str(device) != "meta":
        allocate(model, torch.device(device))
    trainable_parameters(model)
    return model


def _build(args, cfg: ModelConfig, flags: dict):
    """→ (model with the study's weights on args.device, synthesis
    seconds)."""
    t0 = time.perf_counter()
    model = _model(cfg, flags, args.device)
    init_params(model, seed=args.weight_seed)
    rot = (Rotation(cfg.dim, seed=ROTATION_SEED, device=args.device)
           if flags.get("rotated") else None)
    _synthesize_frozen(model, seed=args.weight_seed + 1,
                       quantize=flags["quantized"], dist=args.weights,
                       model_dim=cfg.dim, group=flags["quant_group"],
                       outliers=flags["quant_outliers"], rot=rot,
                       cache=_cache_for(args, flags), device=args.device)
    if rot is not None:
        _rotate_residual_tensors(model, rot)
    _sync(args.device)
    return model, time.perf_counter() - t0


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_synth(args, cfg: Optional[ModelConfig] = None) -> None:
    """--synth_only: draw, fold and quantize on the CPU and fill the
    --cache directory, without a card (the model's shapes on the meta
    device)."""
    flags = _flags_for(args)
    cache = _cache_for(args, flags)
    if cache is None:
        raise SystemExit("--synth_only needs --cache")
    tag = f"[study:synth:{args.phase}:{args.weights}]"
    if cache.loading:
        print(f"{tag} cache already complete at {cache.dir}", file=sys.stderr)
        return
    cfg = cfg or _config(args)
    model = _model(cfg, flags, "meta")
    t0 = time.perf_counter()
    rot = (Rotation(cfg.dim, seed=ROTATION_SEED)
           if flags.get("rotated") else None)
    _synthesize_frozen(model, seed=args.weight_seed + 1,
                       quantize=flags["quantized"], dist=args.weights,
                       model_dim=cfg.dim, group=flags["quant_group"],
                       outliers=flags["quant_outliers"], rot=rot,
                       cache=cache, materialize=False, device="cpu")
    print(f"{tag} cache filled at {cache.dir} "
          f"({time.perf_counter() - t0:.0f}s)", file=sys.stderr)


def run_train_phase(args, cfg: Optional[ModelConfig] = None) -> dict:
    """Training-parity leg: the same synthesized weights and batches, N
    optimizer steps; saves the loss / grad-norm trajectory. → {'synth_s',
    'compute_s', 'loss', 'grad_norm', 'path'}."""
    flags = _flags_for(args)
    quantized, group = flags["quantized"], flags["quant_group"]
    cfg = cfg or _config(args)
    tok = MockTokenizer(cfg.vocab_size)
    batches = []
    for i in range(args.steps):
        items = make_synthetic_items(tok, args.batch, max_feats=cfg.max_feats,
                                     max_seq_len=cfg.max_seq_len,
                                     visual_dim=cfg.visual_dim,
                                     seed=args.data_seed + i)
        batches.append(add_accum_axis(pack_train_batch(items, cfg.max_feats),
                                      1))
    print(f"[study:train:{args.phase}] build on {args.device}…",
          file=sys.stderr)
    model, synth_s = _build(args, cfg, flags)
    # remat: bf16 and the grouped/outlier modes, as the JAX study (their
    # recompute is deterministic, so the trajectory does not move)
    model.remat = not quantized or group > 0
    tcfg = TrainConfig(epochs=5, warmup_epochs=1, accum_iter=1, blr=9e-2,
                       weight_decay=0.14, vaq=True, qav=True)
    opt = make_optimizer(model, tcfg, steps_per_epoch=args.steps,
                         world_batch=args.batch)
    step = make_train_step(model, opt, vaq=True, qav=True)
    losses, gnorms = [], []
    t0 = time.perf_counter()
    for i, b in enumerate(batches):
        m = step(batch_to_device(b, args.device))
        losses.append(float(m.loss))
        gnorms.append(float(m.grad_norm))
        if i == 0:
            print(f"[study:train:{args.phase}] first step "
                  f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    compute_s = time.perf_counter() - t0
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"train_{args.phase}{_sfx(args)}.npz")
    np.savez(path, loss=np.asarray(losses), grad_norm=np.asarray(gnorms))
    print(f"[study:train:{args.phase}:{args.weights}] synthesis "
          f"{synth_s:.1f}s, {args.steps} steps ({compute_s:.1f}s) → "
          f"{args.out}", file=sys.stderr)
    return {"synth_s": synth_s, "compute_s": compute_s, "loss": losses,
            "grad_norm": gnorms, "path": path}


def run_phase(args, cfg: Optional[ModelConfig] = None) -> dict:
    """Eval leg: scores every option of the same synthetic val examples
    with the cached scorer; saves them. → {'synth_s', 'compute_s',
    'scores', 'answers', 'span', 'path'}."""
    flags = _flags_for(args)
    cfg = cfg or _config(args)
    tok = MockTokenizer(cfg.vocab_size)
    # the same eval data in every phase: fixed seeds, not salted
    raw, span = [], 1
    for i in range(args.steps):
        items = make_synthetic_items(tok, args.batch, max_feats=cfg.max_feats,
                                     max_seq_len=cfg.max_seq_len, split="val",
                                     visual_dim=cfg.visual_dim,
                                     seed=args.data_seed + i)
        b = pack_eval_batch(items, cfg.max_feats)
        need, exact = required_eval_span(b)
        assert exact
        span = max(span, need)
        raw.append(b)
    span = -(-span // 8) * 8
    print(f"[study:{args.phase}] build on {args.device}…", file=sys.stderr)
    model, synth_s = _build(args, cfg, flags)
    step = make_eval_step(model, cached=True, span_len=span)
    all_scores, all_answers = [], []
    t0 = time.perf_counter()
    for i, b in enumerate(raw):
        out = step(batch_to_device(b, args.device))
        all_scores.append(out["scores"].double().cpu().numpy())
        all_answers.append(b["answer"])
        if i == 0:
            print(f"[study:{args.phase}] first batch "
                  f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    compute_s = time.perf_counter() - t0
    scores = np.concatenate(all_scores)         # (N·B, n_opt)
    answers = np.concatenate(all_answers)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"scores_{args.phase}{_sfx(args)}.npz")
    np.savez(path, scores=scores, answers=answers, span=span)
    print(f"[study:{args.phase}:{args.weights}] synthesis {synth_s:.1f}s, "
          f"scored {len(scores)} examples ({compute_s:.1f}s) → {args.out}",
          file=sys.stderr)
    return {"synth_s": synth_s, "compute_s": compute_s, "scores": scores,
            "answers": answers, "span": span, "path": path}


def report_train(args) -> dict:
    out_all = {}
    for dist in DISTS:
        sfx = "" if dist == "gaussian" else f"_{dist}"
        bf_path = os.path.join(args.out, f"train_bf16{sfx}.npz")
        if not os.path.exists(bf_path):
            continue
        bf = np.load(bf_path)
        out = {"n_steps": int(len(bf["loss"])),
               "loss_first_bf16": float(bf["loss"][0]),
               "loss_last_bf16": float(bf["loss"][-1]),
               "loss_drop_bf16": float(bf["loss"][0] - bf["loss"][-1])}
        bfr_path = os.path.join(args.out, f"train_bf16r{sfx}.npz")
        bfr = np.load(bfr_path) if os.path.exists(bfr_path) else None
        for ph in _COMPARED:
            path = os.path.join(args.out, f"train_{ph}{sfx}.npz")
            if not os.path.exists(path):
                continue
            q8 = np.load(path)
            # rotated trajectories compare against the rotated-unquantized
            # control (see report(): reparametrization vs quantization)
            base = bfr if (ph.endswith("r") and ph != "bf16r"
                           and bfr is not None) else bf
            dl = np.abs(base["loss"] - q8["loss"])
            out[ph] = {
                "loss_first": float(q8["loss"][0]),
                "loss_last": float(q8["loss"][-1]),
                "loss_drop": float(q8["loss"][0] - q8["loss"][-1]),
                "loss_abs_delta_mean": float(dl.mean()),
                "loss_abs_delta_max": float(dl.max()),
                "loss_rel_delta_mean": float(
                    (dl / np.abs(base["loss"])).mean()),
                "grad_norm_rel_delta_mean": float(
                    (np.abs(base["grad_norm"] - q8["grad_norm"])
                     / np.abs(base["grad_norm"])).mean()),
                **({"baseline": "bf16r"} if base is bfr else {}),
            }
        out_all[dist] = out
    print(json.dumps(out_all, indent=2))
    with open(os.path.join(args.out, "report_train.json"), "w") as f:
        json.dump(out_all, f, indent=2)
    return out_all


def report(args) -> dict:
    """Compare every quantized phase on disk against its bf16 baseline,
    per weight ensemble."""
    out_all = {}
    for dist in DISTS:
        sfx = "" if dist == "gaussian" else f"_{dist}"
        bf_path = os.path.join(args.out, f"scores_bf16{sfx}.npz")
        if not os.path.exists(bf_path):
            continue
        bf = np.load(bf_path)
        bfr_path = os.path.join(args.out, f"scores_bf16r{sfx}.npz")
        bfr = np.load(bfr_path) if os.path.exists(bfr_path) else None
        out_all[dist] = {}
        for phase in _COMPARED:
            path = os.path.join(args.out, f"scores_{phase}{sfx}.npz")
            if not os.path.exists(path):
                continue
            # the rotated phases are a reparametrization: their bf16
            # rounding differs from the unrotated model's, which random
            # weights amplify into score deltas that are not quantization
            # error. int8r/w8a8r compare against the rotated-unquantized
            # bf16r control; the bf16r-vs-bf16 row is the
            # reparametrization floor.
            base = bfr if (phase.endswith("r") and phase != "bf16r"
                           and bfr is not None) else bf
            cmp = _compare(base, np.load(path))
            if base is bfr:
                cmp["baseline"] = "bf16r"
            out_all[dist][phase] = cmp
    print(json.dumps(out_all, indent=2))
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(out_all, f, indent=2)
    return out_all


def _compare(bf, q8) -> dict:
    s_bf, s_q8 = bf["scores"], q8["scores"]
    assert s_bf.shape == s_q8.shape
    n = len(s_bf)

    delta = np.abs(s_q8 - s_bf)                      # per-option |Δscore|
    pred_bf, pred_q8 = s_bf.argmin(-1), s_q8.argmin(-1)
    flips = pred_bf != pred_q8
    srt = np.sort(s_bf, axis=-1)
    margin = srt[:, 1] - srt[:, 0]                   # bf16 decision margin

    return {
        "n_examples": int(n),
        "n_options": int(s_bf.shape[1]),
        "score_delta_mean": float(delta.mean()),
        "score_delta_p99": float(np.quantile(delta, 0.99)),
        "score_delta_p999": float(np.quantile(delta, 0.999)),
        "score_delta_max": float(delta.max()),
        "argmin_flip_rate": float(flips.mean()),
        "n_flips": int(flips.sum()),
        "bf16_margin_median": float(np.median(margin)),
        "bf16_margin_p10": float(np.quantile(margin, 0.10)),
        "max_flipped_margin": float(margin[flips].max()) if flips.any() else 0.0,
        "accuracy_bf16": float((pred_bf == bf["answers"]).mean()),
        "accuracy_quant": float((pred_q8 == bf["answers"]).mean()),
        # the envelope: decisions with a margin above this bound cannot
        # flip (|Δ(s_i - s_j)| ≤ 2·max|Δs|)
        "stability_margin_bound": float(2 * delta.max()),
        "frac_examples_above_bound": float(
            (margin > 2 * delta.max()).mean()),
    }


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("quantized-vs-bf16 parity study")
    ap.add_argument("--phase", required=True, choices=[*PHASES, "report"])
    ap.add_argument("--out", default="./output_dir/int8_study")
    ap.add_argument("--preset", default="7b", choices=["7b", "small", "tiny"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--data_seed", type=int, default=1234)
    ap.add_argument("--weight_seed", type=int, default=0)
    ap.add_argument("--mode", default="eval", choices=["eval", "train"])
    ap.add_argument("--weights", default="gaussian", choices=list(DISTS),
                    help="weight ensemble: gaussian, student_t (heavy "
                         "tails), outlier (amplified residual channels: the "
                         "absmax stressor)")
    ap.add_argument("--cache", default="",
                    help="directory for the synthesized-leaf cache (draw, "
                         "fold and quantize run once; the legs load)")
    ap.add_argument("--synth_only", action="store_true",
                    help="fill the --cache for this phase on the CPU and "
                         "exit (no card needed)")
    ap.add_argument("--device", default="cuda",
                    help="where the legs run: cuda (the kernels) or cpu "
                         "(their plain versions)")
    return ap


def main(argv=None) -> None:
    args = get_args_parser().parse_args(argv)
    if args.synth_only:
        run_synth(args)
    elif args.phase == "report":
        report_train(args) if args.mode == "train" else report(args)
    elif args.mode == "train":
        run_train_phase(args)
    else:
        run_phase(args)


if __name__ == "__main__":
    main()
