"""Classification-eval CLI: score a split with the adapter-gated LLaMA.

    python -m flipped_tpu_torch.cli.evaluate --model llama7B --dataset nextqa \
        --llama_model_path ./pretrained/llama/ --data_root ./data \
        --resume checkpoint_best --output_dir ./output_dir/nextqa --device cuda

The port of flipped_tpu/cli/evaluate.py plus the classification half of
`val_one_epoch` (flipped_tpu/cli/train.py:134-221): the deploy/serve use of
an adapter, scoring every answer option of each video question and taking
the argmin. Batches come from the port's copies of the JAX package's
numpy readers and loader (`flipped_tpu_torch.data`), which the tests hold
equal to the originals.

The backbone loads as the train CLI's does (train/builder.py);
`--resume NAME` then restores the trainables that a train run saved as
NAME under `--output_dir` (ckpt/manager.py), and a name that is not there
raises. --quantize runs every frozen-backbone mode. Long context runs as it
is asked for: at --max_seq_len above 4096 the prefill (and the dense
scorer) take K5 instead of K1, e.g. `--max_seq_len 8192 --batch_size 1`.
Not ported yet, and raising rather than ignored: --is_generation_task
(generation eval) and audio merges.
"""
from __future__ import annotations

import json
import time
from typing import Dict

import numpy as np
import torch

from ..ckpt.manager import CheckpointManager
from ..core.config import get_args_parser, run_config_from_args
from ..data.datasets import build_dataset
from ..data.pipeline import Loader
from ..train.builder import build_eval_state
from ..train.step import make_eval_step
from ..utils.metrics import MetricLogger, log_qtype

# per-example host bookkeeping of a packed eval batch (data/batching.py);
# its 0-d scalars and lists are skipped by type
_HOST_KEYS = ("answer", "qtype", "qid")


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The numeric arrays of a packed eval batch as tensors on `device`."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if k not in _HOST_KEYS and isinstance(v, np.ndarray) and v.ndim}


def val_one_epoch(eval_step, loader, dataset_name: str, device,
                  debug: bool = False) -> Dict[str, float]:
    """Score every batch; returns count-weighted accuracy meters, with the
    per-question-type buckets, plus 'batches' (JAX: cli/train.py:134-221)."""
    logger = MetricLogger()
    n_batches = 0
    t0 = time.perf_counter()
    for batch in loader:
        valid = int(batch.get("valid", batch["answer"].shape[0]))
        answer = batch["answer"][:valid]
        qtype = batch["qtype"][:valid]
        span_info = (int(batch["span_need"]), bool(batch["span_exact"]))
        out = eval_step(batch_to_device(batch, device), span_info=span_info)
        if not bool(torch.isfinite(out["scores"]).all()):
            # a NaN score would silently decide the argmin
            raise FloatingPointError(f"non-finite option scores in batch "
                                     f"{n_batches}")
        prediction = out["prediction"].cpu().numpy()[:valid]
        correct = (prediction == answer).astype(np.float32)
        log_qtype(dataset_name, qtype, correct, logger)
        logger.update(n=valid, acc=float(correct.mean()) if valid else 0.0)
        n_batches += 1
        if debug:
            break
    elapsed = time.perf_counter() - t0
    print(f"scored {n_batches} batches in {elapsed:.3f} s  {logger}")
    return {**logger.averages(), "batches": n_batches}


def main(args) -> Dict[str, float]:
    run_cfg = run_config_from_args(args)
    if run_cfg.train.is_generation_task:
        raise NotImplementedError(
            "--is_generation_task: generation eval is not ported yet")
    device = torch.device(run_cfg.device)
    model, cfg, tokenizer = build_eval_state(run_cfg, device,
                                             seed=run_cfg.train.seed)
    if run_cfg.train.resume:
        mgr = CheckpointManager(run_cfg.train.output_dir)
        if not mgr.exists(run_cfg.train.resume):
            raise FileNotFoundError(f"no checkpoint {run_cfg.train.resume} "
                                    f"under {mgr.output_dir}")
        meta = mgr.restore(run_cfg.train.resume, model)
        print(f"loaded {run_cfg.train.resume} (epoch {meta['epoch']}, "
              f"best_acc {meta['best_acc']:.4f})")
    dataset = build_dataset(run_cfg.data, tokenizer, "val")
    loader = Loader(dataset, run_cfg.data.batch_size, shuffle=False,
                    seed=run_cfg.data.seed, split="val")
    eval_step = make_eval_step(model, cached=True)
    stats = val_one_epoch(eval_step, loader, run_cfg.data.dataset, device,
                          debug=run_cfg.debug)
    print(json.dumps({f"val_{k}": v for k, v in stats.items()}))
    return stats


if __name__ == "__main__":
    main(get_args_parser().parse_args())
