"""Eval CLI: score or generate over a split with the adapter-gated LLaMA.

    python -m flipped_tpu_torch.cli.evaluate --model llama7B --dataset nextqa \
        --llama_model_path ./pretrained/llama/ --data_root ./data \
        --resume checkpoint_best --output_dir ./output_dir/nextqa --device cuda

The port of flipped_tpu/cli/evaluate.py and of `val_one_epoch`
(flipped_tpu/cli/train.py:134-221): the deploy/serve use of an adapter.
The classification eval scores every answer option of each video question
and takes the argmin. `--is_generation_task` (the MUSIC-AVQA recipe,
`--dataset musicavqa --max_seq_len 128 --batch_size 32`) decodes 31
greedy tokens a question from a KV cache (train/generation.py), counts
MUSIC-AVQA's answer right when it starts with the ground truth (the
other datasets: the option nearest the answer's pooled embedding), and
writes the answers, by dataset row id, to
`{output_dir}/extracted_answers/extracted_answers_epoch0.json`. Batches
come from the port's copies of the JAX package's numpy readers and
loader (`flipped_tpu_torch.data`), which the tests hold equal to the
originals.

The backbone loads as the train CLI's does (train/builder.py);
`--resume NAME` then restores the trainables that a train run saved as
NAME under `--output_dir` (ckpt/manager.py), and a name that is not there
raises. --quantize runs every frozen-backbone mode. Long context runs as it
is asked for: at --max_seq_len above 4096 the prefill (and the dense
scorer) take K5 instead of K1, e.g. `--max_seq_len 8192 --batch_size 1`.
The audio merges (`--audio --audio_merge sum|concat|attention`, `--audio
--audio_only`) score and generate as they train. The val loop prints JAX's
progress lines (`MetricLogger.log_every`); `--trace_dir` is accepted and
ignored, as JAX's evaluate ignores it, and `--loader` too: the eval reads
the val split in order with the thread loader.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np
import torch

from ..ckpt.manager import CheckpointManager
from ..core.config import get_args_parser, run_config_from_args
from ..data.datasets import build_dataset
from ..data.pipeline import Loader
from ..train.builder import build_eval_state
from ..train.generation import decode_generated, make_generation_step
from ..train.step import make_eval_step
from ..utils.logging import save_result
from ..utils.metrics import MetricLogger, log_qtype

# per-example host bookkeeping of a packed eval batch (data/batching.py);
# its 0-d scalars and lists are skipped by type
_HOST_KEYS = ("answer", "qtype", "qid")


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The numeric arrays of a packed batch as tensors on `device`: those
    it has ('video' is absent under --audio_only, 'audio' without
    --audio)."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if k not in _HOST_KEYS and isinstance(v, np.ndarray) and v.ndim}


def generation_correct(gen_step, tokenizer, batch: Dict, tb, valid: int,
                       dataset_name: str):
    """One batch through `gen_step` → (correct (valid,) f32, the rows
    {'qid', 'generated_answer'} of the extracted-answers file) (JAX:
    cli/train.py:162-190): MUSIC-AVQA counts an answer right when it
    starts with the ground-truth text, the other datasets when the
    nearest option is the answer."""
    out = gen_step(tb)
    if not bool(torch.isfinite(out["similarity"]).all()):
        # a NaN similarity would silently decide the argmax
        raise FloatingPointError("non-finite option similarities")
    generated = out["generated"].cpu().numpy()[:valid]
    answers = [decode_generated(tokenizer, g, tokenizer.eos_id)
               for g in generated]
    rows = [{"qid": int(q), "generated_answer": a}
            for q, a in zip(batch["qid"][:valid], answers)]
    if dataset_name == "musicavqa":
        correct = np.array([1.0 if a.startswith(str(g)) else 0.0
                            for a, g in zip(answers, batch["gt_answer"])],
                           np.float32)
    else:
        prediction = out["prediction"].cpu().numpy()[:valid]
        correct = (prediction == batch["answer"][:valid]).astype(np.float32)
    return correct, rows


def val_one_epoch(eval_step, loader, dataset_name: str, device,
                  debug: bool = False, gen_step=None, tokenizer=None,
                  output_dir: str = "", epoch: int = 0) -> Dict[str, float]:
    """Score (or, with a `gen_step`, generate for) every batch; returns
    count-weighted accuracy meters, with the per-question-type buckets,
    plus 'batches' (JAX: cli/train.py:134-221). Generation writes the
    extracted answers under `output_dir` when there is one."""
    logger = MetricLogger()
    n_batches = 0
    extracted = []
    t0 = time.perf_counter()
    for batch in logger.log_every(iter(loader), max(len(loader) // 4, 1),
                                  f"Epoch: [{epoch}]"):
        valid = int(batch.get("valid", batch["answer"].shape[0]))
        answer = batch["answer"][:valid]
        qtype = batch["qtype"][:valid]
        tb = batch_to_device(batch, device)
        if gen_step is not None:
            correct, rows = generation_correct(gen_step, tokenizer, batch,
                                               tb, valid, dataset_name)
            extracted += rows
        else:
            span_info = (int(batch["span_need"]), bool(batch["span_exact"]))
            out = eval_step(tb, span_info=span_info)
            if not bool(torch.isfinite(out["scores"]).all()):
                # a NaN score would silently decide the argmin
                raise FloatingPointError(f"non-finite option scores in "
                                         f"batch {n_batches}")
            prediction = out["prediction"].cpu().numpy()[:valid]
            correct = (prediction == answer).astype(np.float32)
        log_qtype(dataset_name, qtype, correct, logger)
        logger.update(n=valid, acc=float(correct.mean()) if valid else 0.0)
        n_batches += 1
        if debug:
            break
    elapsed = time.perf_counter() - t0
    print(f"{'generated' if gen_step else 'scored'} {n_batches} batches in "
          f"{elapsed:.3f} s")
    print("Averaged stats:", logger)
    if gen_step is not None and output_dir:
        save_result(extracted, os.path.join(output_dir, "extracted_answers"),
                    f"extracted_answers_epoch{epoch}")
    return {**logger.averages(), "batches": n_batches}


def make_val_steps(model, run_cfg, tokenizer):
    """(eval_step, gen_step): the cached scorer, and under
    --is_generation_task the generation step (JAX: cli/evaluate.py:
    70-72), else None."""
    gen_step = (make_generation_step(model, tokenizer.eos_id)
                if run_cfg.train.is_generation_task else None)
    return make_eval_step(model, cached=True), gen_step


def main(args) -> Dict[str, float]:
    run_cfg = run_config_from_args(args)
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
    eval_step, gen_step = make_val_steps(model, run_cfg, tokenizer)
    stats = val_one_epoch(eval_step, loader, run_cfg.data.dataset, device,
                          debug=run_cfg.debug, gen_step=gen_step,
                          tokenizer=tokenizer,
                          output_dir=run_cfg.train.output_dir)
    print(json.dumps({f"val_{k}": v for k, v in stats.items()}))
    return stats


if __name__ == "__main__":
    main(get_args_parser().parse_args())
