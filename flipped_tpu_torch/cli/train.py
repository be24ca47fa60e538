"""Training CLI: fine-tune the adapter of the frozen LLaMA on one card.

    python -m flipped_tpu_torch.cli.train --model llama7B --dataset nextqa \
        --data_root ./data --batch_size 8 --max_seq_len 128 --vaq --qav \
        --output_dir '' --device cuda

The port of flipped_tpu/cli/train.py (reference train.py + engine.py), in
one process with no mesh: loaders → model build → optimizer → epoch loop
{train_one_epoch, the classification `val_one_epoch`}. Each train step runs
the three objectives stacked in one encode, K1 forward and K2 backward in
every block, and one AdamW update on the adapter. `--quantize w8a8` (or
int8, int8g, int8o, w8a8g, w8a8o) runs the frozen backbone in int8: the
block matmuls through K3, or K7 and K4 in the grouped modes.

Not ported yet, and raising rather than ignored: checkpoint saving and the
JSON-lines log (a non-empty --output_dir; ROADMAP Queue 1, checkpoints),
--resume, --is_generation_task, --loader grain, and the options that
`check_train_ported` names.
"""
from __future__ import annotations

import json
import math
import sys
import time
from typing import Dict

import numpy as np
import torch

from ..core.config import (check_train_ported, get_args_parser,
                           run_config_from_args)
from ..data.pipeline import load_data
from ..train.builder import build_train_state
from ..train.optim import make_optimizer
from ..train.step import make_eval_step, make_train_step
from ..utils.metrics import MetricLogger
from .evaluate import batch_to_device, val_one_epoch


def train_one_epoch(train_step, loader, epoch: int, device,
                    debug: bool = False) -> Dict[str, float]:
    """One pass over the train loader, one update per batch; averaged
    metrics plus 'steps' (JAX: cli/train.py:92-131). A non-finite loss
    stops the run with exit code 1 (reference: engine.py:33-35)."""
    logger = MetricLogger()
    loader.set_epoch(epoch)
    n_steps = 0
    t0 = time.perf_counter()
    for batch in loader:
        m = train_step(batch_to_device(batch, device))
        loss = float(m.loss)
        if not math.isfinite(loss):
            print(f"Loss is {loss}, stopping training")
            sys.exit(1)
        logger.update(loss=loss, vqa_loss=float(m.vqa_loss),
                      vaq_loss=float(m.vaq_loss), qav_loss=float(m.qav_loss),
                      grad_norm=float(m.grad_norm), lr=m.lr)
        n_steps += 1
        if debug:
            break
    print(f"Epoch [{epoch}] {n_steps} steps in "
          f"{time.perf_counter() - t0:.3f} s  Averaged stats: {logger}")
    return {**logger.averages(), "steps": n_steps}


def main(args):
    """→ (model, per-epoch stats), the model as trained."""
    run_cfg = run_config_from_args(args)
    check_train_ported(run_cfg.train)
    if run_cfg.train.output_dir:
        raise NotImplementedError(
            f"--output_dir {run_cfg.train.output_dir!r}: checkpoint saving "
            f"and the JSON-lines log are not ported yet (ROADMAP Queue 1, "
            f"checkpoints); pass --output_dir ''")
    if run_cfg.train.is_generation_task:
        raise NotImplementedError(
            "--is_generation_task: generation eval is not ported yet")
    device = torch.device(run_cfg.device)
    np.random.seed(run_cfg.train.seed)
    model, cfg, tokenizer = build_train_state(run_cfg, device,
                                              seed=run_cfg.train.seed)
    loader_train = load_data(run_cfg.data, tokenizer, "train",
                             accum_iter=run_cfg.train.accum_iter,
                             backend=args.loader)
    loader_val = load_data(run_cfg.data, tokenizer, "val",
                           backend=args.loader)

    # examples per optimizer update (reference eff_bs, train.py:104-107)
    world_batch = run_cfg.data.batch_size * run_cfg.train.accum_iter
    print(f"effective batch size: {world_batch}")
    print(f"actual lr: {run_cfg.train.absolute_lr(world_batch):.2e}")
    steps_per_epoch = max(len(loader_train) * run_cfg.train.accum_iter, 1)
    optimizer = make_optimizer(model, run_cfg.train, steps_per_epoch,
                               world_batch)
    train_step = make_train_step(model, optimizer, vaq=run_cfg.train.vaq,
                                 qav=run_cfg.train.qav)
    # one process: no eval span is pinned (data.pipeline.pinned_eval_span),
    # each batch carries its pack-time span
    eval_step = make_eval_step(model, cached=True)

    print(f"Start training for {run_cfg.train.epochs} epochs")
    history, best_acc = [], 0.0
    t_start = time.time()
    for epoch in range(run_cfg.train.start_epoch, run_cfg.train.epochs):
        train_stats = train_one_epoch(train_step, loader_train, epoch, device,
                                      debug=run_cfg.debug)
        val_stats = val_one_epoch(eval_step, loader_val, run_cfg.data.dataset,
                                  device, debug=run_cfg.debug)
        best_acc = max(best_acc, val_stats.get("acc", 0.0))
        log_stats = {**{f"train_{k}": v for k, v in train_stats.items()},
                     "epoch": epoch,
                     **{f"val_{k}": v for k, v in val_stats.items()}}
        print(json.dumps(log_stats))
        history.append(log_stats)
        if run_cfg.debug:
            break
    print(f"Training time {time.time() - t_start:.0f}s, "
          f"best acc {best_acc:.4f}")
    return model, history


if __name__ == "__main__":
    main(get_args_parser().parse_args())
