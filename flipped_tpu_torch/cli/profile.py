"""Where the time of a train or eval step goes on the card.

    python -m flipped_tpu_torch.cli.profile --mode train --model llama7B \
        --data_root ./data --batch_size 8 --max_seq_len 128 --vaq --qav \
        --no_remat --quantize w8a8 --device cuda

The long-context step takes the same flags as the train CLI, e.g.
`--batch_size 1 --max_seq_len 4096 --lm_head_chunk 512` (with remat, and
`--remat_group N`). `--mode generation` profiles one `gen_step` a step
(the prefill and 30 decode steps of train/generation.py) on a val batch,
e.g. the MUSIC-AVQA recipe's `--dataset musicavqa --is_generation_task
--batch_size 32 --max_seq_len 128`.

The card's name and power limit come from nvidia-smi. Builds the model the
CLIs build (random weights from the seed), takes one batch from the loader,
runs two warm-up steps, STEPS steps timed on the host clock, then STEPS more
under `torch.profiler` (CUDA activity only: recording every CPU op as well
doubles the wall time), each step ending in `torch.cuda.synchronize()`.
Prints one JSON line: wall seconds per step without and with the profiler,
the peak allocated device memory over the steps without it (the model and
its weights included), device busy seconds per step (the union of kernel
intervals) and its share of the profiled window's wall time, kernel
launches per step, device time by kernel class (bf16 and f32 GEMMs, the
port's flash kernels K1/K2 and the streaming K5/K6, its int8 GEMMs K3/K7,
its quantized dx K4, K8's two GEMMs, K9, K10's quantize pass and GEMM,
other), and the top kernels by device time. The activation quantize
pass that K7 and K8's w4a8 branch share counts in the K3/K7 class.
`--quantize` builds the model it names, as the CLIs do, and the audio
flags (`--audio --audio_merge ...`, `--audio --audio_only`) the merge
they name, its batch read from the data root's audio features as the
CLIs read them. `--trace_dir DIR` also writes the profiled steps as a
Chrome trace, `DIR/profile_{mode}.pt.trace.json`.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from ..core.config import get_args_parser, run_config_from_args
from ..data.pipeline import load_data
from ..train.builder import build_eval_state, build_train_state
from ..train.generation import make_generation_step
from ..train.optim import make_optimizer
from ..train.step import make_eval_step, make_train_step
from .evaluate import batch_to_device

STEPS = 3


def kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_stream" in low:
        return "flash stream (K5/K6)"
    if "flash_text" in low or "flash_bwd" in low:
        return "flash (K1/K2)"
    # before "gemm": K3 is int8_fwd_quantize_kernel and int8_fwd_wgmma_kernel,
    # K7 int8_grouped_wgmma_kernel and the grouped quantize pass (which K8's
    # w4a8 branch runs too)
    if ("int8_fwd" in low or "int8_grouped" in low
            or "quantize_rows" in low):
        return "int8 GEMM (K3/K7)"
    if "quant_dx" in low:
        return "quant dx (K4)"
    if "int4_w4a8" in low or "int4_wo" in low:
        return "int4 GEMM (K8)"
    if "int4_dx" in low:
        return "int4 dx (K9)"
    # before "gemm": K10's GEMM is wgmma_int8::kn_gemm_row_kernel
    if "int8_dgrad" in low or "kn_gemm_row" in low:
        return "int8 dgrad (K10)"
    if any(m in low for m in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "gemm f32" if "f32f32" in low else "gemm"
    return "other"


def summarize(prof, steps: int, wall: float, wall_plain: float) -> dict:
    """`wall` is the profiled window's, `wall_plain` that of the same steps
    run without the profiler."""
    kernels = [e for e in prof.profiler.function_events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no kernel on the card")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:                       # union of kernel intervals, us
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    by_class: dict = {}
    for name, (t, _) in by_name.items():
        c = kernel_class(name)
        by_class[c] = by_class.get(c, 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "wall_s_per_step": wall_plain / steps,
        "profiled_wall_s_per_step": wall / steps,
        "device_busy_s_per_step": busy * 1e-6 / steps,
        "device_busy_share": busy * 1e-6 / wall,
        "launches_per_step": len(kernels) / steps,
        "device_ms_per_step_by_class": {c: t * 1e-3 / steps
                                        for c, t in by_class.items()},
        "top_kernels": [{"name": n[:120], "ms_per_step": t * 1e-3 / steps,
                         "calls_per_step": c / steps}
                        for n, (t, c) in top],
    }


def main(argv=None) -> dict:
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--mode", choices=["train", "eval", "generation"],
                       default="train")
    opts, rest = extra.parse_known_args(argv)
    args = get_args_parser().parse_args(rest)
    run_cfg = run_config_from_args(args)
    device = torch.device(run_cfg.device)
    if device.type != "cuda":
        raise ValueError("the profile measures the card: --device cuda")
    build = build_train_state if opts.mode == "train" else build_eval_state
    model, _, tokenizer = build(run_cfg, device, seed=run_cfg.train.seed)
    split = "train" if opts.mode == "train" else "val"
    loader = load_data(run_cfg.data, tokenizer, split,
                       accum_iter=run_cfg.train.accum_iter)
    it = iter(loader)
    host_batch = next(it)
    it.close()
    batch = batch_to_device(host_batch, device)
    if opts.mode == "train":
        step = make_train_step(
            model, make_optimizer(model, run_cfg.train, len(loader),
                                  run_cfg.data.batch_size),
            vaq=run_cfg.train.vaq, qav=run_cfg.train.qav,
            lm_chunk=run_cfg.train.lm_head_chunk)
        run = lambda: step(batch)
    elif opts.mode == "eval":
        step = make_eval_step(model, cached=True)
        span = (int(host_batch["span_need"]), bool(host_batch["span_exact"]))
        run = lambda: step(batch, span_info=span)
    else:
        step = make_generation_step(model, tokenizer.eos_id)
        run = lambda: step(batch)
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(STEPS):
        run()
        torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            args.trace_dir, f"profile_{opts.mode}.pt.trace.json"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out = {"mode": opts.mode, "remat": model.remat,
           "remat_group": model.remat_group,
           "remat_policy": model.remat_policy,
           "audio_merge": model.cfg.audio_merge,
           "lm_head_chunk": run_cfg.train.lm_head_chunk,
           "max_seq_len": run_cfg.data.max_seq_len,
           "batch_size": run_cfg.data.batch_size,
           "quantize": run_cfg.train.quantize, "card": card,
           "peak_allocated_gib": peak / 2 ** 30,
           **summarize(prof, STEPS, wall, wall_plain)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
