"""Training CLI: fine-tune the adapter of the frozen LLaMA on one card or
on a grid of torch.distributed ranks.

    python -m flipped_tpu_torch.cli.train --model llama7B --dataset nextqa \
        --llama_model_path ./pretrained/llama/ --data_root ./data \
        --batch_size 8 --max_seq_len 128 --vaq --qav \
        --output_dir ./output_dir/nextqa --device cuda

The port of flipped_tpu/cli/train.py (reference train.py + engine.py):
process group → rank grid → loaders → model build → optimizer → epoch loop
{train_one_epoch, `val_one_epoch`}. Under torchrun (or SLURM, OpenMPI;
core/distributed.py) --dp, --pp, --sp and --tp lay the ranks out
(core/mesh.py), one card a rank over NCCL, or gloo under --device cpu:

    torchrun --nproc_per_node 8 -m flipped_tpu_torch.cli.train \
        --model llama7B --dp 2 --sp 2 --tp 2 --batch_size 4 --vaq --qav ...
    torchrun --nproc_per_node 2 -m flipped_tpu_torch.cli.train \
        --model llama7B --pp 2 --pp_microbatches 4 --batch_size 8 ...

Each dp row reads its own shard of the data (`--batch_size` rows a shard,
so the global batch is batch_size · dp), the pp ranks hold L/pp blocks
each and pass --pp_microbatches microbatches through them in a GPipe
schedule (model/pipeline.py), the sp ranks keep S/sp rows of the sequence
each, the tp ranks H/tp heads and ffn_hidden/tp columns
(model/parallel.py), and the step sums the gradients over dp×pp×sp.
Generation eval (--is_generation_task) runs on every grid.

Each train step runs the three objectives stacked in one encode, K1
forward and K2 backward in every block (above S = 2048 K5 forward and
K6a + K6b backward), and one AdamW update on the adapter. `--quantize` runs the frozen backbone in int8
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
the card), into `DIR/train_epoch{N}.pt.trace.json` (Chrome trace format),
with the program's spans (utils/spans.py) over the traced steps written in
on the trace's time base: each step's `train.step` span as `train step N`,
the others under their own names (`train.forward`, `train.backward`,
`train.update`), each with its span name and parent in `args`. A one-step
epoch (--debug) writes no trace, as in JAX.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import threading
import time
from typing import Dict

import numpy as np
import torch

from ..ckpt.manager import CheckpointManager
from ..core.config import (check_train_ported, get_args_parser,
                           run_config_from_args)
from ..core.distributed import init_distributed_mode
from ..core.mesh import loader_shards, make_mesh
from ..data.pipeline import load_data, pinned_eval_span
from ..train.builder import build_train_state
from ..train.optim import make_optimizer
from ..train.step import make_train_step
from ..utils import spans
from ..utils.logging import setup_for_distributed, write_log_line
from ..utils.metrics import MetricLogger, SmoothedValue
from .evaluate import (batch_to_device, make_val_steps, shard_leader,
                       val_one_epoch)


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
    tracing = contextlib.ExitStack()
    prof = rec = None
    n_steps = 0
    try:
        for it, batch in enumerate(logger.log_every(
                iter(loader), print_freq, f"Epoch: [{epoch}]")):
            if trace_dir and it == 1:
                # skip step 0 (first calls: kernel loads, allocator warm-up)
                prof = tracing.enter_context(torch.profiler.profile(
                    activities=_activities(device)))
                rec = tracing.enter_context(spans.record())
            m = train_step(batch_to_device(batch, device))
            loss = float(m.loss)
            if prof is not None and it >= trace_stop_it:
                tracing.close()
                _write_trace(prof, rec, trace_dir, epoch)
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
            tracing.close()
            _write_trace(prof, rec, trace_dir, epoch)
    logger.synchronize_between_processes()
    print("Averaged stats:", logger)
    return {**logger.averages(), "steps": n_steps}


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _write_trace(prof, rec, trace_dir: str, epoch: int) -> None:
    """The profile as a Chrome trace, with the recorder's spans added on
    the trace's time base; the k-th `train.step` span is `train step k`,
    as the traced steps start at step 1."""
    os.makedirs(trace_dir, exist_ok=True)
    path = trace_file(trace_dir, epoch)
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    steps = 0
    for i, s in enumerate(rec.spans):
        name = s.name
        if name == "train.step":
            steps += 1
            name = f"train step {steps}"
        trace["traceEvents"].append({
            "ph": "X", "cat": "user_annotation", "name": name,
            "pid": os.getpid(), "tid": threading.get_native_id(),
            "ts": (s.start_ns - base) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"span": s.name, "index": i, "parent": s.parent}})
    with open(path, "w") as f:
        json.dump(trace, f)
    print(f"wrote the trace of epoch {epoch} to {path}")


def main(args):
    """→ (model, per-epoch stats), the model as trained."""
    run_cfg = run_config_from_args(args)
    check_train_ported(run_cfg.train)
    output_dir = run_cfg.train.output_dir
    if run_cfg.train.resume and not output_dir:
        raise ValueError("--resume reads its checkpoint from --output_dir, "
                         "which is empty")
    device = init_distributed_mode(run_cfg.device)
    setup_for_distributed()
    mesh = make_mesh(run_cfg.mesh)
    np.random.seed(run_cfg.train.seed + mesh.rank)
    # a single rank builds as before the grid existed
    model, cfg, tokenizer = build_train_state(
        run_cfg, device, seed=run_cfg.train.seed,
        **({"mesh": mesh} if mesh.is_parallel else {}))
    shard, n_shards = loader_shards(mesh)
    loader_train = load_data(run_cfg.data, tokenizer, "train",
                             accum_iter=run_cfg.train.accum_iter,
                             process_index=shard, process_count=n_shards,
                             backend=args.loader,
                             num_workers=args.num_workers)
    loader_val = load_data(run_cfg.data, tokenizer, "val",
                           process_index=shard, process_count=n_shards,
                           backend=args.loader, num_workers=args.num_workers)

    # examples per optimizer update (reference eff_bs, train.py:104-107):
    # batch_size rows a loader shard, one shard a dp row
    world_batch = (run_cfg.data.batch_size * run_cfg.train.accum_iter
                   * n_shards)
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
    # more than one process: one eval span pinned for every rank
    # (data.pipeline.pinned_eval_span); one process: each batch's own
    span_pin = (None if run_cfg.train.is_generation_task else
                pinned_eval_span(loader_val.dataset,
                                 run_cfg.data.max_seq_len, mesh.ranks.size))
    if span_pin is not None:
        print(f"eval span pinned: {span_pin}")
    eval_step, gen_step = make_val_steps(model, run_cfg, tokenizer,
                                         span_pin)

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
                                  output_dir=output_dir, epoch=epoch,
                                  leader=shard_leader(mesh, n_shards))
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
