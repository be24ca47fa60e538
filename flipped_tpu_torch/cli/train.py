"""Training CLI: fine-tune the adapter of the frozen LLaMA on one card.

    python -m flipped_tpu_torch.cli.train --model llama7B --dataset nextqa \
        --llama_model_path ./pretrained/llama/ --data_root ./data \
        --batch_size 8 --max_seq_len 128 --vaq --qav \
        --output_dir ./output_dir/nextqa --device cuda

The port of flipped_tpu/cli/train.py (reference train.py + engine.py), in
one process with no mesh: loaders → model build → optimizer → epoch loop
{train_one_epoch, `val_one_epoch`}. Each train step runs
the three objectives stacked in one encode, K1 forward and K2 backward in
every block (above S = 2048 K5 forward and K6a + K6b backward), and one
AdamW update on the adapter. `--quantize` runs the frozen backbone in int8
or int4 (K3, K7, K4, K8, K9, K10 by mode). The long-context options run:
`--lm_head_chunk N` sweeps the LM head in N-token chunks, `--remat_group N`
checkpoints N blocks as one unit, e.g.

    python -m flipped_tpu_torch.cli.train --model llama7B --max_seq_len 4096 \
        --batch_size 1 --vaq --qav --lm_head_chunk 512 ...

The frozen backbone is Meta's `consolidated.*.pth` shards under
`--llama_model_path`/`--model` when they are there (train/builder.py:
merged, bf16, rotated and quantized on the card as --quantize says), else
random. With an `--output_dir` (the default is ./output_dir; '' writes
nothing) each epoch appends a JSON line to log.txt and saves the adapter
as `checkpoint_last`, and as `checkpoint_best` when the val accuracy rises
(ckpt/manager.py); `--resume checkpoint_last` continues a run from the
epoch after the saved one, with the optimizer's moments and schedule
(a name that does not exist starts afresh). `--is_generation_task` runs
the val loop as generation eval (cli/evaluate.py), the MUSIC-AVQA recipe:

    python -m flipped_tpu_torch.cli.train --model llama7B --dataset musicavqa \
        --is_generation_task --max_seq_len 128 --batch_size 32 --bias 3 \
        --tau 100 --max_feats 10 --output_dir ./output_dir/musicavqa ...

and writes each epoch's answers to
`{output_dir}/extracted_answers/extracted_answers_epoch{N}.json`.

The audio merges run as in the fork's sweep (scripts/params.txt):
`--audio --audio_merge sum|concat|attention` or `--audio --audio_only`,
reading `audio_imagebind.pth` (the attention merge
`audio_imagebind_clip.pth`) beside the video features, e.g. its headline
recipe:

    python -m flipped_tpu_torch.cli.train --model llama7B --dataset musicavqa \
        --is_generation_task --audio --audio_merge attention \
        --max_seq_len 128 --batch_size 32 --max_feats 10 ...

`--remat_policy qkv` keeps each block's attention outputs through the
recompute (model/llama.py), so the attention forward runs once per block
an update. `--loader grain` packs the batches in `--num_workers` worker
processes (data/pipeline.py `WorkerLoader`), the thread loader's batches
in its order. Each epoch prints JAX's progress lines (`MetricLogger.
log_every`: every quarter of the epoch, with the device memory on the
card). `--trace_dir DIR` traces steps 1 to min(4, len - 1) of the first
epoch run, as JAX does (cli/train.py:100-122; JAX compares with
--start_epoch, so under --resume it traces nothing; the port traces the
first epoch it runs), with `torch.profiler` (CPU activity, and CUDA on
the card), each step a `train step N` span, into
`DIR/train_epoch{N}.pt.trace.json` (Chrome trace format). A one-step
epoch (--debug) writes no trace, as in JAX.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import time
from typing import Dict

import numpy as np
import torch

from ..ckpt.manager import CheckpointManager
from ..core.config import (check_train_ported, get_args_parser,
                           run_config_from_args)
from ..data.pipeline import load_data
from ..train.builder import build_train_state
from ..train.optim import make_optimizer
from ..train.step import make_train_step
from ..utils.logging import write_log_line
from ..utils.metrics import MetricLogger, SmoothedValue
from .evaluate import batch_to_device, make_val_steps, val_one_epoch


def trace_file(trace_dir: str, epoch: int) -> str:
    return os.path.join(trace_dir, f"train_epoch{epoch}.pt.trace.json")


def train_one_epoch(train_step, loader, epoch: int, device,
                    debug: bool = False,
                    trace_dir: str = "") -> Dict[str, float]:
    """One pass over the train loader, one update per batch, JAX's progress
    lines every quarter of the epoch; → averaged metrics plus 'steps' (JAX:
    cli/train.py:92-131). With a `trace_dir`, steps 1 to min(4, len - 1)
    are traced (`trace_file`). A non-finite loss stops the run with exit
    code 1 (reference: engine.py:33-35)."""
    logger = MetricLogger()
    logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.6f}"))
    print_freq = max(len(loader) // 4, 1)
    loader.set_epoch(epoch)
    trace_stop_it = min(4, max(len(loader) - 1, 1))
    prof = None
    n_steps = 0
    try:
        for it, batch in enumerate(logger.log_every(
                iter(loader), print_freq, f"Epoch: [{epoch}]")):
            if trace_dir and it == 1:
                # skip step 0 (first calls: kernel loads, allocator warm-up)
                prof = torch.profiler.profile(activities=_activities(device))
                prof.start()
            with (torch.profiler.record_function(f"train step {it}")
                  if prof is not None else contextlib.nullcontext()):
                m = train_step(batch_to_device(batch, device))
                loss = float(m.loss)
            if prof is not None and it >= trace_stop_it:
                _stop_trace(prof, trace_dir, epoch)
                prof = None
            if not math.isfinite(loss):
                print(f"Loss is {loss}, stopping training")
                sys.exit(1)
            logger.update(loss=loss, vqa_loss=float(m.vqa_loss),
                          vaq_loss=float(m.vaq_loss),
                          qav_loss=float(m.qav_loss),
                          grad_norm=float(m.grad_norm))
            logger.update(lr=m.lr)
            n_steps += 1
            if debug:
                break
    finally:
        if prof is not None:
            _stop_trace(prof, trace_dir, epoch)
    print("Averaged stats:", logger)
    return {**logger.averages(), "steps": n_steps}


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _stop_trace(prof, trace_dir: str, epoch: int) -> None:
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(trace_file(trace_dir, epoch))
    print(f"wrote the trace of epoch {epoch} to "
          f"{trace_file(trace_dir, epoch)}")


def main(args):
    """→ (model, per-epoch stats), the model as trained."""
    run_cfg = run_config_from_args(args)
    check_train_ported(run_cfg.train)
    output_dir = run_cfg.train.output_dir
    if run_cfg.train.resume and not output_dir:
        raise ValueError("--resume reads its checkpoint from --output_dir, "
                         "which is empty")
    device = torch.device(run_cfg.device)
    np.random.seed(run_cfg.train.seed)
    model, cfg, tokenizer = build_train_state(run_cfg, device,
                                              seed=run_cfg.train.seed)
    loader_train = load_data(run_cfg.data, tokenizer, "train",
                             accum_iter=run_cfg.train.accum_iter,
                             backend=args.loader,
                             num_workers=args.num_workers)
    loader_val = load_data(run_cfg.data, tokenizer, "val",
                           backend=args.loader, num_workers=args.num_workers)

    # examples per optimizer update (reference eff_bs, train.py:104-107)
    world_batch = run_cfg.data.batch_size * run_cfg.train.accum_iter
    print(f"effective batch size: {world_batch}")
    print(f"actual lr: {run_cfg.train.absolute_lr(world_batch):.2e}")
    steps_per_epoch = max(len(loader_train) * run_cfg.train.accum_iter, 1)
    optimizer = make_optimizer(model, run_cfg.train, steps_per_epoch,
                               world_batch)

    mgr = CheckpointManager(output_dir) if output_dir else None
    start_epoch, best_acc = run_cfg.train.start_epoch, 0.0
    if run_cfg.train.resume:
        if mgr.exists(run_cfg.train.resume):
            meta = mgr.restore(run_cfg.train.resume, model, optimizer)
            start_epoch = meta["epoch"] + 1
            best_acc = meta["best_acc"]
            print(f"resumed from {run_cfg.train.resume} at epoch "
                  f"{start_epoch}")
        else:
            print(f"no checkpoint {run_cfg.train.resume} under "
                  f"{mgr.output_dir}: starting afresh")

    train_step = make_train_step(model, optimizer, vaq=run_cfg.train.vaq,
                                 qav=run_cfg.train.qav,
                                 lm_chunk=run_cfg.train.lm_head_chunk)
    # one process: no eval span is pinned (data.pipeline.pinned_eval_span),
    # each batch carries its pack-time span
    eval_step, gen_step = make_val_steps(model, run_cfg, tokenizer)

    print(f"Start training for {run_cfg.train.epochs} epochs")
    history = []
    t_start = time.time()
    for epoch in range(start_epoch, run_cfg.train.epochs):
        train_stats = train_one_epoch(
            train_step, loader_train, epoch, device, debug=run_cfg.debug,
            trace_dir=args.trace_dir if epoch == start_epoch else "")
        val_stats = val_one_epoch(eval_step, loader_val, run_cfg.data.dataset,
                                  device, debug=run_cfg.debug,
                                  gen_step=gen_step, tokenizer=tokenizer,
                                  output_dir=output_dir, epoch=epoch)
        if best_acc < val_stats.get("acc", 0.0):
            best_acc = val_stats["acc"]
            if mgr is not None:
                mgr.save("checkpoint_best", model, optimizer, epoch, best_acc)
                print(f"saved checkpoint_best (acc={best_acc:.4f})")
        if mgr is not None:
            # the rolling checkpoint a preempted run resumes from
            mgr.save("checkpoint_last", model, optimizer, epoch, best_acc)
        log_stats = {**{f"train_{k}": v for k, v in train_stats.items()},
                     "epoch": epoch,
                     **{f"val_{k}": v for k, v in val_stats.items()}}
        write_log_line(output_dir, log_stats)
        print(json.dumps(log_stats))
        history.append(log_stats)
        if run_cfg.debug:
            break
    print(f"Training time {time.time() - t_start:.0f}s, "
          f"best acc {best_acc:.4f}")
    return model, history


if __name__ == "__main__":
    main(get_args_parser().parse_args())
