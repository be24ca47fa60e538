"""One rank of the torch.distributed groups that tests/test_torch_parallel.py
spawns on the CPU (gloo). It imports torch and the port only.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python tests/torch_parallel_worker.py JOB.pt OUT_DIR

JOB.pt (torch.save) holds a list of tasks {'name', 'kind', 'mesh', ...},
run in order, each on a grid of its own over the same ranks:
- kind 'attention': full q, k, v, adapter_k, adapter_v, gate1, gate2,
  video_start, the cotangent g and max_feats. The rank runs
  `sp_flash_adapter_attention` on its dp rows, tp heads and sp rows and
  writes its out and the seven grads.
- kind 'step': the model config, --quantize mode, full f32 state dict, train
  config, global train batch (accum axis first), number of updates and a
  global eval batch, and optionally a remat policy, an LM-head chunk and
  a pipeline microbatch count. The rank cuts the model (`parallelize`)
  and the batches (`dp_slice`), runs the cached eval on the loaded
  weights, then the updates, and writes the metrics, its trainables, its
  eval scores, whether its frozen pieces stayed unchanged, the sp
  dispatch's whole-sequence calls and warnings (a sequence sp does not
  divide), and the pipeline's microbatch counts.
- kind 'gen': the model config, full f32 state dict, a global eval batch,
  the eos id and optionally a pipeline microbatch count. The rank runs
  the cached eval and the generation step on its dp rows and writes the
  scores, the generated tokens and similarities, and the microbatch
  counts.
OUT_DIR gets rank{r}.pt: {task name: its results}.
"""
import os
import sys
import warnings

import numpy as np
import torch
import torch.distributed as dist

from flipped_tpu_torch.core.config import (MeshConfig, ModelConfig,
                                           TrainConfig, model_quant_kwargs)
from flipped_tpu_torch.core.distributed import init_distributed_mode
from flipped_tpu_torch.core.mesh import (DP_AXIS, SP_AXIS, TP_AXIS,
                                         make_mesh)
from flipped_tpu_torch.model import FlippedVQAModel
from flipped_tpu_torch.model.kernels import flash_attention as fa
from flipped_tpu_torch.model import pipeline
from flipped_tpu_torch.model.kernels.flash_attention import \
    sp_flash_adapter_attention
from flipped_tpu_torch.model.parallel import parallelize
from flipped_tpu_torch.train import (is_trainable, make_eval_step,
                                     make_generation_step, make_optimizer,
                                     make_train_step)

F32 = dict(dtype=torch.float32, frozen_dtype=torch.float32,
           trainable_dtype=torch.float32)


def dp_slice(batch, mesh, train):
    """This dp row's rows of a global batch, cut as JAX's `_shard_batch`
    shards it (flipped_tpu/cli/train.py:39-60): under the accumulation
    axis (train) the batch axis is axis 1, else axis 0; arrays without
    that axis, and non-arrays, stay whole."""
    dp, i = mesh.size(DP_AXIS), mesh.index(DP_AXIS)
    axis = 1 if train else 0
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray) or v.ndim <= axis:
            out[k] = v
            continue
        n = v.shape[axis] // dp
        out[k] = np.take(v, range(i * n, (i + 1) * n), axis=axis)
    return out


def run_attention(job, mesh):
    """Forward and backward of the sp attention on this rank's block."""
    dp, di = mesh.size(DP_AXIS), mesh.index(DP_AXIS)
    sp, si = mesh.size(SP_AXIS), mesh.index(SP_AXIS)
    tp, ti = mesh.size(TP_AXIS), mesh.index(TP_AXIS)
    q = job["q"]
    b, s, h, dh = q.shape
    rows = slice(di * b // dp, (di + 1) * b // dp)
    seq = slice(si * s // sp, (si + 1) * s // sp)
    heads = slice(ti * h // tp, (ti + 1) * h // tp)
    leaf = lambda t: t.clone().requires_grad_()
    q, k, v = (leaf(job[n][rows, seq, heads]) for n in ("q", "k", "v"))
    ak, av = (leaf(job[n][:, heads]) for n in ("adapter_k", "adapter_v"))
    g1, g2 = leaf(job["gate1"][heads]), leaf(job["gate2"][heads])
    out = sp_flash_adapter_attention(
        q, k, v, ak, av, g1, g2, job["video_start"][rows], job["max_feats"],
        mesh.group(SP_AXIS), seq.start)
    g = job["g"].view(b, s, h, dh)[rows, seq, heads].reshape(out.shape)
    out.backward(g)
    return {"out": out.detach(), "grads": [t.grad for t in
                                           (q, k, v, ak, av, g1, g2)]}


def load_model(job, mesh):
    """The job's model on its weights, cut for this rank; → (model, the
    list the pipeline's microbatch counts are appended to)."""
    model = FlippedVQAModel(ModelConfig(**job["cfg"]), **F32,
                            **model_quant_kwargs(job.get("quantize",
                                                         "none")))
    model.load_state_dict(job["state"], strict=True)
    model.pp_microbatches = job.get("pp_microbatches", 0)
    global _COUNTS
    _COUNTS = []
    return model, _COUNTS


_COUNTS = []
_pick = pipeline.pick_microbatches


def _counted_pick(*a):
    _COUNTS.append(_pick(*a))
    return _COUNTS[-1]


pipeline.pick_microbatches = _counted_pick


def tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()
            if isinstance(v, np.ndarray) and v.ndim}


def run_gen(job, mesh):
    """The cached eval and the generation step on this rank's dp rows."""
    model, counts = load_model(job, mesh)
    parallelize(model, mesh)
    batch = tensors(dp_slice(job["eval_batch"], mesh, train=False))
    scores = make_eval_step(model, cached=True)(batch)["scores"]
    gen = make_generation_step(model, job["eos_id"])(batch)
    return {"scores": scores, "generated": gen["generated"],
            "similarity": gen["similarity"], "microbatches": counts}


def run_step(job, mesh):
    model, counts = load_model(job, mesh)
    if job.get("remat_policy"):
        model.remat, model.remat_policy = True, job["remat_policy"]
    opt = make_optimizer(model, TrainConfig(**job["train"]),
                         job["steps_per_epoch"], job["world_batch"])
    parallelize(model, mesh)
    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
               if not is_trainable(n)}
    # the sp dispatch's whole-sequence calls (a sequence sp does not divide)
    whole = []
    flash = fa.flash_adapter_attention
    fa.flash_adapter_attention = lambda *a: whole.append(1) or flash(*a)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            eval_batch = tensors(dp_slice(job["eval_batch"], mesh,
                                          train=False))
            scores = make_eval_step(model, cached=True)(
                eval_batch)["scores"]
            step = make_train_step(model, opt, vaq=True, qav=True,
                                   lm_chunk=job.get("lm_chunk", 0))
            batch = {k: torch.from_numpy(v) for k, v in
                     dp_slice(job["batch"], mesh, train=True).items()}
            metrics = [[float(x) for x in step(batch)]
                       for _ in range(job["n_updates"])]
    finally:
        fa.flash_adapter_attention = flash
    return {"metrics": metrics, "scores": scores,
            "trainable": {n: p.detach() for n, p in
                          model.named_parameters() if is_trainable(n)},
            "grads": {n: p.grad for n, p in model.named_parameters()
                      if is_trainable(n) and p.grad is not None},
            "frozen_same": all(torch.equal(p, frozen0[n]) for n, p in
                               model.named_parameters() if n in frozen0),
            "sp_whole_calls": len(whole),
            "sp_warnings": sorted({str(w.message) for w in seen
                                   if "sequence-parallel" in str(w.message)}),
            "heads": model.stage_blocks()[-1][0].attention.n_local_heads,
            "microbatches": counts}


def main(job_path, out_dir):
    torch.set_num_threads(1)
    tasks = torch.load(job_path, weights_only=False)
    init_distributed_mode("cpu")
    run = {"attention": run_attention, "step": run_step, "gen": run_gen}
    out = {t["name"]: run[t["kind"]](t, make_mesh(MeshConfig(**t["mesh"])))
           for t in tasks}
    torch.save(out, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
