"""The port's data, pipeline, sequence and tensor parallelism against the
JAX package.

In-process: the rank grid and its axis lines against
`flipped_tpu.core.mesh.make_mesh`'s device array on 8 virtual CPU devices,
`loader_shards` against JAX's (process index and count monkeypatched, as
tests/test_sharding.py does), the split table and `shard_state_dict`
against `param_pspec` and the pieces `param_shardings` puts on each device,
and the sp dispatch of a sequence sp does not divide.

Spawned: two torch.distributed groups over gloo on the CPU, one process a
rank, and the single-process CLI run the second is held against, all
started together at the top of the module; the JAX references are computed
while they run, and the tests collect them:

1. Eight ranks of tests/torch_parallel_worker.py, on two grids in turn:
   - dp2×sp2×tp2: `sp_flash_adapter_attention` on each rank's dp rows, sp
     rows and tp heads, then one cached eval batch and two updates of the
     train step (--vaq --qav, accum 2) of the tiny f32 model, against JAX's
     adapter_gated_attention (value and seven grads) and JAX's
     make_eval_step and make_train_step under the same mesh, on the same
     weights (`params_from_flax`) and batches; and again with remat under
     the qkv policy and a chunked LM head, against the same JAX run; and
     at S 95, which sp 2 does not divide, against the single-rank port;
   - w8a8d dp4×tp2: the same eval and step, quantized;
   - dp1×pp2×sp2×tp2 (JAX's dry-run pp leg): the dp2×sp2×tp2 eval and
     step, with the blocks in two pipeline stages, against JAX's
     `PipelinedModel` under the same mesh;
   - dp4×pp2 with --pp_microbatches 3, which a dp row's 2 eval rows do
     not divide: the cached eval and the generated tokens against JAX's
     pipelined prefill, extend and decode under the same mesh (JAX's
     partitioner aborts on its pipelined decode under dp2×pp2×tp2);
   - dp2×sp2×tp2: the generated tokens against JAX's single-device
     `make_generation_step` and the single-rank port;
   - w4a8 dp4×pp2: one update and the eval against the single-rank port.
   Each step's update-2 gradients are held, leaf by leaf, against the
   single-rank port's run of the same task in this process.
2. A 2-rank `cli.train --dp 2 --is_generation_task` on MUSIC-AVQA fixtures,
   against the single-process run of the same command.
3. A 2-rank `cli.train --pp 2` on NExT-QA fixtures writing its
   checkpoint, against the single-process run of the same command; the
   checkpoint then restores into a pp-1 build.
"""
import functools
import importlib.util
import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from flipped_tpu.ckpt import quantize as jquantize
from flipped_tpu.core import mesh as jmesh_mod
from flipped_tpu.core.config import MeshConfig as JMeshConfig
from flipped_tpu.core.config import ModelConfig as JModelConfig
from flipped_tpu.core.config import TrainConfig as JTrainConfig
from flipped_tpu.core.config import quant_flags as jquant_flags
from flipped_tpu.data import (add_accum_axis, make_synthetic_items,
                              pack_eval_batch, pack_train_batch)
from flipped_tpu.model import FlippedVQAModel as JModel
from flipped_tpu.model.attention import adapter_gated_attention
from flipped_tpu.model.pipeline import (PipelinedModel, stack_layer_params,
                                        unstack_layer_params)
from flipped_tpu.text import MockTokenizer
from flipped_tpu.train import make_eval_step as jmake_eval_step
from flipped_tpu.train import make_optimizer as jmake_optimizer
from flipped_tpu.train import make_train_step as jmake_train_step
from flipped_tpu.train import partition_params
from flipped_tpu.train.generation import \
    make_generation_step as jmake_generation_step
from flipped_tpu.train.optim import lr_schedule as jlr_schedule
from flipped_tpu_torch.ckpt import params_from_flax
from flipped_tpu_torch.ckpt.convert import (flatten_flax,
                                            flax_path_to_torch_name,
                                            needs_transpose)
from flipped_tpu_torch.core.config import MeshConfig
from flipped_tpu_torch.core.mesh import (AXES, Mesh, _lines, keeps_leaf,
                                         loader_shards, param_pspec,
                                         rank_grid, shard_leaf)
from flipped_tpu_torch.data.synthetic import make_musicavqa, make_nextqa

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_parallel_worker.py"
KW = dict(dim=32, n_layers=2, n_heads=4, vocab_size=512, multiple_of=16,
          max_seq_len=96, adapter_len=4, adapter_layer=2, max_feats=4,
          visual_dim=16)
# w8a8d needs dims the quantized kernels' plain versions take (as
# tests/test_torch_dgrad.py); one block keeps JAX's compile short
QKW = dict(KW, dim=128, multiple_of=128, n_layers=1, adapter_layer=1)
# w4a8 in two pipeline stages: two blocks at the quantized dims
Q4KW = dict(QKW, n_layers=2, adapter_layer=2)
TCFG = dict(epochs=8, warmup_epochs=1.0, lr=1e-2, weight_decay=0.1)
STEPS_PER_EPOCH, WORLD_BATCH, ACCUM, N_UPDATES = 4, 8, 2, 2
# f32 on both sides; the mesh changes only the order of the sums
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
# as tests/test_torch_train.py: AdamW moves an element whose gradient is
# within the f32 disagreement of zero by up to lr; 1e-3 of the lr
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
SCORE_TOL = dict(rtol=1e-4, atol=1e-5)
# update 2's gradient of each trainable against the single-rank port's, by
# the norm of the difference over the leaf's: f32, only the order of the
# sums differs (measured 2e-7). A sum over ranks skipped or doubled moves a
# leaf by a part of itself; the updated weights cannot show that (update 2
# is AdamW's first step, about lr per element whatever the gradient).
GRAD_TOL = 1e-4
# w8a8d: each side's gradient is the exact one (w8a8's: the same forward)
# plus its stochastic-rounding noise, drawn anew where a cotangent's bits
# differ; the single rank's noise N1 is measured against its w8a8 run, and
# ||N2 - N1|| (about 1.4 ||N1|| for independent draws) is allowed twice
# ||N1|| on top (chip_smoke.py's P16_SR_NOISE)
SR_NOISE = 2.0
# tests/test_torch_quant_model.py's rule: once an activation code differs
# between the two forwards (f32 rounding carries a value across a rounding
# boundary), the logits are held to 2.5e-3 of the largest
QUANT_SCORE_REL = 2.5e-3
SPAWN_TIMEOUT = 240
# the pp checkpoint's train command: one update at a nonzero lr (no warmup)
CKPT_ARGV = ["--model", "tiny", "--dataset", "nextqa", "--max_seq_len",
             "128", "--epochs", "1", "--debug", "--vaq", "--qav",
             "--batch_size", "4", "--lr", "1e-2", "--warmup_epochs", "0",
             "--device", "cpu"]
# the CLI computes in bf16 on the CPU too: a microbatch's GEMMs round
# otherwise than the whole batch's (2^-8 relative a rounding); the moments
# held at chip_smoke.py's GRAD_REL for bf16 gradients (measured 3.0e-3 of
# visual_proj's norm)
BF16_GRAD_REL = 2.0 ** -6
# generation: the similarities of the same tokens' pooled embeddings, f32
SIM_TOL = dict(rtol=1e-5, atol=1e-5)
# w4a8's gradients against the single rank's: the model's f32 GEMMs sum in
# an order that depends on the row count (MKL's blocking), so a rank's
# microbatch and the single rank's batch may round an activation a ulp
# apart, and the 8-bit activation quantize then flips a code (the losses
# still agree to LOSS_TOL); through the straight-through backward a flip
# moves the adapter's gradient. Measured 1.9e-3 of the leaf's norm at
# dp4×pp2, and the same at dp4×tp2 without pp; held at 1e-2, where a sum
# over pp skipped or doubled moves a leaf by a part of itself
QUANT_GRAD_REL = 1e-2
# the LM head in chunks of 40 rows: under sp 2 a rank's 48 rows of S 96
# take a full and a ragged chunk
LM_CHUNK = 40


@functools.lru_cache(maxsize=None)
def _worker():
    spec = importlib.util.spec_from_file_location("torch_parallel_worker",
                                                  WORKER)
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    return worker


def _single_rank(job):
    """The worker's step task on one rank, in this process."""
    from flipped_tpu_torch.core.mesh import make_mesh

    return _worker().run_step(job, make_mesh(MeshConfig(dp=1)))


def _check_grads(ranks, want, noise=None, rel=GRAD_TOL):
    """Each rank's update-2 gradients against `want`'s, leaf by leaf: the
    difference within `rel` (GRAD_TOL) of the leaf's norm, plus SR_NOISE
    times the leaf's `noise` norm (w8a8d)."""
    for r, out in enumerate(ranks):
        assert out["grads"].keys() == want["grads"].keys(), r
        for name, g in want["grads"].items():
            bound = rel * float(g.norm()) + SR_NOISE * (
                noise or {}).get(name, 0.0)
            diff = float((out["grads"][name] - g).norm())
            assert diff <= bound, (r, name, diff, bound)


def cpu8():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return devs[:8]


# --- in-process: the grid, the loader shards, the split table -----------------

@pytest.mark.parametrize("dp,pp,sp,tp", [(8, 1, 1, 1), (2, 1, 2, 2),
                                         (4, 1, 1, 2), (1, 1, 8, 1)])
def test_rank_grid_matches_jax_device_array(dp, pp, sp, tp):
    devs = cpu8()
    jm = jmesh_mod.make_mesh(JMeshConfig(dp=dp, pp=pp, sp=sp, tp=tp),
                             devices=devs)
    want = np.vectorize(lambda d: devs.index(d))(jm.devices)
    ours = rank_grid(MeshConfig(dp=dp, pp=pp, sp=sp, tp=tp), 8)
    np.testing.assert_array_equal(ours, want)
    # dp -1 takes what the model axes leave
    np.testing.assert_array_equal(
        rank_grid(MeshConfig(dp=-1, pp=pp, sp=sp, tp=tp), 8), want)
    # each axis line holds the ranks that differ only on that axis
    for a in range(4):
        for line in _lines(ours, a):
            coords = [np.argwhere(want == r)[0] for r in line]
            rest = {tuple(np.delete(c, a)) for c in coords}
            assert len(rest) == 1 and len(line) == ours.shape[a]
    for r in range(8):
        m = Mesh(ours, r)
        assert [m.index(ax) for ax in AXES] == list(np.argwhere(want == r)[0])


def test_mesh_larger_than_the_world_raises_like_jax():
    devs = cpu8()
    with pytest.raises(ValueError, match=r"mesh 5x1x1x2 > 8"):
        jmesh_mod.make_mesh(JMeshConfig(dp=5, tp=2), devices=devs)
    with pytest.raises(ValueError, match=r"mesh 5x1x1x2 > 8 ranks"):
        rank_grid(MeshConfig(dp=5, tp=2), 8)


@pytest.mark.parametrize("shape", [(8, 1, 1, 1), (2, 1, 2, 2),
                                   (4, 1, 1, 2), (1, 1, 8, 1)])
def test_loader_shards_match_jax(monkeypatch, shape):
    """Every rank of the grid against JAX's `loader_shards` with one local
    device a process (one process a rank, as the port runs), process
    index and count monkeypatched as tests/test_sharding.py does."""

    class FakeJMesh:
        def __init__(self, grid):
            self.shape = dict(zip(AXES, grid.shape))

    dp, pp, sp, tp = shape
    grid = rank_grid(MeshConfig(dp=dp, pp=pp, sp=sp, tp=tp), 8)
    monkeypatch.setattr(jmesh_mod.jax, "local_device_count", lambda: 1)
    monkeypatch.setattr(jmesh_mod.jax, "process_count", lambda: 8)
    for r in range(8):
        monkeypatch.setattr(jmesh_mod.jax, "process_index", lambda: r)
        assert loader_shards(Mesh(grid, r)) == \
            jmesh_mod.loader_shards(FakeJMesh(grid)), r


def shard_state_dict(full, mesh, n_layers):
    """A full state dict cut to this rank's pieces, leaf by leaf, as
    `parallelize` cuts a model."""
    return {name: shard_leaf(name, t, mesh) for name, t in full.items()
            if keeps_leaf(name, mesh, n_layers)}


def test_split_table_matches_param_pspec():
    """Every leaf of a tiny tree: the port's split (torch layout) is JAX's
    `param_pspec` (Flax layout, transposed where the kernel is), and
    `shard_state_dict` gives each tp rank the piece `param_shardings` puts
    on its devices, at dp4×tp2."""
    devs = cpu8()
    cfg = JModelConfig(**KW)
    jmodel = JModel(cfg, dtype=jnp.float32, frozen_dtype=jnp.float32)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.zeros((1, cfg.max_feats, cfg.visual_dim)), None,
        jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, cfg.max_feats), jnp.int32))["params"])
    flat = flatten_flax(params)
    full = params_from_flax(params)
    split = 0
    for path, leaf in flat.items():
        want = tuple(jmesh_mod.param_pspec(path))
        if needs_transpose(path) and want:
            want = want[::-1]
        name = flax_path_to_torch_name(path)
        ours = param_pspec(name)
        assert ours == want, (path, ours, want)
        split += bool(ours)
    assert split == 2 * 7 + 2          # 7 block matmuls, head, embedding
    jm = jmesh_mod.make_mesh(JMeshConfig(dp=4, tp=2), devices=devs)
    shardings = jmesh_mod.param_shardings(jm, params)
    grid = rank_grid(MeshConfig(dp=4, tp=2), 8)
    for r in (0, 1):
        pieces = shard_state_dict(full, Mesh(grid, int(grid[0, 0, 0, r])),
                                  cfg.n_layers)
        dev = devs[int(grid[0, 0, 0, r])]
        for path, sh in flatten_flax(shardings).items():
            arr = jax.device_put(flat[path], sh)
            shard = next(s for s in arr.addressable_shards
                         if s.device == dev)
            want = np.asarray(shard.data)
            got = pieces[flax_path_to_torch_name(path)].numpy()
            np.testing.assert_array_equal(
                got.T if needs_transpose(path) else got, want, err_msg=path)


def test_sp_dispatch_of_an_indivisible_sequence(monkeypatch):
    """S 65 under sp 2 (JAX tests/test_flash_attention.py's case): every
    sp rank holds the whole sequence, and `sp_flash_or_einsum` warns with
    JAX's text and runs it through `flash_adapter_attention` (the kernels'
    plain versions here on the CPU), matching JAX's
    adapter_gated_attention in value and in the seven grads; --no_flash
    takes the einsum attention, without the warning."""
    import warnings

    from flipped_tpu_torch.model.kernels import flash_attention as fa
    from flipped_tpu_torch.model.llama import SeqShard

    calls = []
    flash = fa.flash_adapter_attention
    monkeypatch.setattr(fa, "flash_adapter_attention",
                        lambda *a: calls.append(1) or flash(*a))
    rs = np.random.RandomState(13)
    b, s, h, dh, al = 2, 65, 4, 8, 4
    mk = lambda *shape: rs.randn(*shape).astype(np.float32)
    xs = [mk(b, s, h, dh), mk(b, s, h, dh), mk(b, s, h, dh), mk(al, h, dh),
          mk(al, h, dh), mk(h), mk(h)]
    vs = np.array([3, -1], np.int32)
    g = mk(b, s, h * dh)
    want, vjp = jax.vjp(lambda *a: adapter_gated_attention(*a, vs, 4),
                        *map(jnp.asarray, xs))
    want_grads = vjp(jnp.asarray(g).reshape(want.shape))
    seq = SeqShard(None, 0, s, "S=65 % sp=2 != 0")
    for use_flash in (True, False):
        leaves = [torch.from_numpy(x).requires_grad_() for x in xs]
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fa.sp_flash_or_einsum(*leaves, torch.from_numpy(vs), 4,
                                        seq, use_flash)
        assert [("sequence-parallel flash kernels skipped (S=65 % sp=2 "
                 "!= 0)" in str(w.message)) for w in seen] == \
            ([True] if use_flash else [])
        assert len(calls) == 1
        out.backward(torch.from_numpy(g))
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(want).reshape(b, s, -1),
                                   **ATTN_TOL)
        for n, x, w in zip(ATTN_NAMES, leaves, want_grads):
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                       err_msg=f"d{n}", **ATTN_TOL)


@pytest.mark.parametrize("env,want", [
    ({}, (None, None)),
    ({"RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "1",
      "LOCAL_WORLD_SIZE": "4", "MASTER_ADDR": "10.0.0.2",
      "MASTER_PORT": "1234"}, ("env", (3, 8, 1, 4, "10.0.0.2", 1234))),
    ({"SLURM_JOB_ID": "7", "SLURM_STEP_NODELIST": "n[1-2]",
      "SLURM_NTASKS": "4", "SLURM_PROCID": "2", "SLURM_LOCALID": "0",
      "SLURM_STEP_TASKS_PER_NODE": "2(x2)"},
     ("slurm", (2, 4, 0, 2, "127.0.0.1", 29500))),
    ({"SLURM_JOB_ID": "7", "SLURM_STEP_NODELIST": "n1", "SLURM_NTASKS": "1",
      "SLURM_PROCID": "0", "SLURM_LOCALID": "0"}, (None, None)),
    ({"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1",
      "OMPI_COMM_WORLD_LOCAL_RANK": "1", "OMPI_COMM_WORLD_LOCAL_SIZE": "2"},
     ("ompi", (1, 2, 1, 2, "127.0.0.1", 29500)))])
def test_launcher_discovery_in_jax_order(monkeypatch, env, want):
    """torchrun's variables, then SLURM's (a step of more than one task),
    then OpenMPI's (more than one rank), else one process, as JAX's
    `detect_launcher` orders them."""
    from flipped_tpu_torch.core.distributed import detect_launcher

    for k in list(os.environ):
        if k.startswith(("SLURM_", "OMPI_")) or k in (
                "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    name, kw = detect_launcher()
    assert name == want[0]
    if name is not None:
        assert (kw["rank"], kw["world_size"], kw["local_rank"],
                kw["local_world_size"], kw["master_addr"],
                kw["master_port"]) == want[1]


def test_backend_follows_the_device_and_the_cards():
    """gloo on the CPU; nccl while each local rank has a card; more local
    ranks than cards raise naming both counts, unless the caller shares
    the card, and then every rank of the host takes gloo alike."""
    from flipped_tpu_torch.core.distributed import choose_backend

    assert choose_backend("cpu", 3, 8, 0) == ("gloo", torch.device("cpu"))
    assert choose_backend("cuda", 1, 2, 2) == ("nccl",
                                               torch.device("cuda", 1))
    with pytest.raises(ValueError, match="8 local ranks on 1 card"):
        choose_backend("cuda", 0, 8, 1)
    assert [choose_backend("cuda", r, 8, 1, share_device=True)
            for r in (0, 7)] == [("gloo", torch.device("cuda", 0))] * 2


# --- the spawned groups ------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argv_of_rank, n: int, cwd=ROOT):
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            argv_of_rank(r), env=env, cwd=cwd, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    return outs


def _worker_group(tasks, n, tmp):
    job_path = tmp / "job.pt"
    torch.save(tasks, job_path)
    procs = _spawn(lambda r: [sys.executable, str(WORKER), str(job_path),
                              str(tmp)], n)
    return procs, tmp


def _collect(group, name):
    procs, tmp = group
    _wait(procs)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)[name]
            for r in range(len(procs))]


def _init_params(kw, seed):
    cfg = JModelConfig(**kw)
    items = make_synthetic_items(MockTokenizer(cfg.vocab_size),
                                 ACCUM * 4, max_feats=cfg.max_feats,
                                 max_seq_len=cfg.max_seq_len,
                                 visual_dim=cfg.visual_dim, seed=seed)
    batch = pack_train_batch(items, cfg.max_feats)
    params = jax.device_get(jax.jit(
        JModel(cfg, dtype=jnp.float32, frozen_dtype=jnp.float32).init)(
        jax.random.PRNGKey(1), jnp.array(batch["vqa_tokens"][:1]),
        jnp.array(batch["video"][:1]), None,
        jnp.array(batch["vqa_video_start"][:1]),
        jnp.array(batch["vqa_splice"][:1]))["params"])
    # nonzero gate1 so the adapter rows get gradients from the first update
    for name, sub in params.items():
        if name.startswith("layers_"):
            sub["attention"]["gate1"] = np.full(kw["n_heads"], 0.3,
                                                np.float32)
    eval_items = make_synthetic_items(MockTokenizer(cfg.vocab_size), 4,
                                      max_feats=cfg.max_feats,
                                      max_seq_len=cfg.max_seq_len,
                                      visual_dim=cfg.visual_dim,
                                      split="val", seed=seed + 1)
    return (params, add_accum_axis(batch, ACCUM),
            pack_eval_batch(eval_items, cfg.max_feats))


def _attention_inputs():
    rs = np.random.RandomState(3)
    b, s, h, dh, al = 4, 16, 4, 8, 4
    f = lambda *shape: rs.randn(*shape).astype(np.float32)
    return dict(q=f(b, s, h, dh), k=f(b, s, h, dh), v=f(b, s, h, dh),
                adapter_k=f(al, h, dh), adapter_v=f(al, h, dh),
                gate1=f(h) * 0.5, gate2=f(h) - 1.0,
                video_start=np.array([2, -1, 0, 5], np.int32),
                g=f(b, s, h * dh), max_feats=4)


def _step_job(kw, quantize, seed):
    params, batch, eval_batch = _init_params(kw, seed)
    tree = (jquantize.quantize_frozen(params) if quantize != "none"
            else params)
    job = dict(name=quantize, kind="step", cfg=kw, quantize=quantize,
               state=params_from_flax(tree),
               train=dict(accum_iter=ACCUM, vaq=True, qav=True, **TCFG),
               steps_per_epoch=STEPS_PER_EPOCH, world_batch=WORLD_BATCH,
               batch=batch, n_updates=N_UPDATES, eval_batch=eval_batch)
    return tree, job


def _odd_job(job):
    """`job` at S 95, which sp 2 does not divide: the same weights, the
    batches drawn again at that length."""
    cfg = dict(job["cfg"], max_seq_len=95)
    mk = lambda n, split, seed: make_synthetic_items(
        MockTokenizer(cfg["vocab_size"]), n, max_feats=cfg["max_feats"],
        max_seq_len=95, visual_dim=cfg["visual_dim"], split=split,
        seed=seed)
    return dict(job, name="odd", cfg=cfg, batch=add_accum_axis(
        pack_train_batch(mk(ACCUM * 4, "train", 7), cfg["max_feats"]),
        ACCUM), eval_batch=pack_eval_batch(mk(4, "val", 8),
                                           cfg["max_feats"]))


def _gen_job(tree, seed=9):
    """The cached eval and the generation step on 8 val items of `tree`."""
    cfg = JModelConfig(**KW)
    tok = MockTokenizer(cfg.vocab_size)
    items = make_synthetic_items(tok, 8, max_feats=cfg.max_feats,
                                 max_seq_len=cfg.max_seq_len,
                                 visual_dim=cfg.visual_dim, split="val",
                                 seed=seed)
    return dict(name="gen", kind="gen", cfg=KW, state=params_from_flax(tree),
                eval_batch=pack_eval_batch(items, cfg.max_feats),
                eos_id=tok.eos_id)


def _w4a8_job(job_q):
    """`job_q`'s batches on two w4a8 blocks, initialised by the port (the
    test holds it against the single-rank port only), gate1 0.3 as
    `_init_params` sets it."""
    from flipped_tpu_torch.core.config import ModelConfig as TModelConfig
    from flipped_tpu_torch.core.config import model_quant_kwargs
    from flipped_tpu_torch.model import FlippedVQAModel as TModel
    from flipped_tpu_torch.train import init_params

    model = TModel(TModelConfig(**Q4KW), dtype=torch.float32,
                   frozen_dtype=torch.float32, **model_quant_kwargs("w4a8"))
    init_params(model, 4)
    state = model.state_dict()
    for name in state:
        if name.endswith("gate1"):
            state[name] = torch.full_like(state[name], 0.3)
    return dict(job_q, name="w4a8", cfg=Q4KW, quantize="w4a8", state=state,
                n_updates=1)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Start all three groups at once; the tests collect them."""
    root = tmp_path_factory.mktemp("torch_parallel")
    attn = _attention_inputs()
    tree_f32, job_f32 = _step_job(KW, "none", 5)
    tree_q, job_q = _step_job(QKW, "w8a8d", 6)
    gen_job = _gen_job(tree_f32)
    w4a8_job = _w4a8_job(job_q)
    (root / "ranks").mkdir()
    attn_task = dict(name="attention", kind="attention",
                     mesh=dict(dp=2, sp=2, tp=2),
                     **{k: (torch.from_numpy(v) if isinstance(
                         v, np.ndarray) else v) for k, v in attn.items()})
    sp_grid = dict(dp=2, sp=2, tp=2)
    groups = {"ranks": _worker_group(
        [attn_task, dict(job_f32, mesh=sp_grid),
         dict(job_f32, mesh=sp_grid, name="qkv", remat_policy="qkv",
              lm_chunk=LM_CHUNK),
         dict(job_q, mesh=dict(dp=4, tp=2)),
         dict(_odd_job(job_f32), mesh=sp_grid),
         dict(job_f32, name="pp_sp_tp", mesh=dict(dp=1, pp=2, sp=2, tp=2)),
         dict(gen_job, name="pp_gen", mesh=dict(dp=4, pp=2),
              pp_microbatches=3),
         dict(gen_job, name="sp_tp_gen", mesh=sp_grid),
         dict(w4a8_job, mesh=dict(dp=4, pp=2))], 8, root / "ranks")}
    data = root / "data"
    make_musicavqa(str(data), 16, np.random.RandomState(0))
    nextqa = root / "nextqa"
    make_nextqa(str(nextqa), 16, np.random.RandomState(1))
    gen_argv = ["--model", "tiny", "--dataset", "musicavqa", "--data_root",
                str(data), "--max_seq_len", "128", "--epochs", "1",
                "--debug", "--is_generation_task", "--lr", "0", "--device",
                "cpu"]
    cli = [sys.executable, "-m", "flipped_tpu_torch.cli.train", *gen_argv]
    groups["gen"] = (_spawn(lambda r: cli + [
        "--batch_size", "2", "--dp", "2", "--output_dir",
        str(root / "gen_dp2")], 2), root / "gen_dp2")
    groups["gen_single"] = ([subprocess.Popen(
        cli + ["--batch_size", "4", "--output_dir", str(root / "gen_single")],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)],
        root / "gen_single")
    ckpt = [sys.executable, "-m", "flipped_tpu_torch.cli.train",
            *CKPT_ARGV, "--data_root", str(nextqa)]
    groups["ckpt_pp2"] = (_spawn(lambda r: ckpt + [
        "--pp", "2", "--output_dir", str(root / "ckpt_pp2")], 2),
        root / "ckpt_pp2")
    groups["ckpt_single"] = ([subprocess.Popen(
        ckpt + ["--output_dir", str(root / "ckpt_single")], cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)], root / "ckpt_single")
    # six threads: XLA compiles with the GIL released, and each thread
    # has its own mesh context
    with ThreadPoolExecutor(6) as ex:
        futures = {
            "attention": ex.submit(_jax_attention, attn),
            "none": ex.submit(_jax_mesh_run, tree_f32, job_f32,
                              JMeshConfig(dp=2, sp=2, tp=2), "none"),
            "w8a8d": ex.submit(_jax_mesh_run, tree_q, job_q,
                               JMeshConfig(dp=4, tp=2), "w8a8d"),
            "pp_sp_tp": ex.submit(_jax_pp_run, tree_f32, job_f32,
                                  JMeshConfig(dp=1, pp=2, sp=2, tp=2)),
            "pp_gen": ex.submit(_jax_pp_gen, tree_f32, gen_job,
                                JMeshConfig(dp=4, pp=2, pp_microbatches=3)),
            "gen": ex.submit(_jax_gen, tree_f32, gen_job)}
        jax_refs = {k: f.result() for k, f in futures.items()}
    yield dict(groups=groups, attn=attn, jax=jax_refs, f32=job_f32,
               w8a8d=job_q, odd=_odd_job(job_f32), gen=gen_job,
               w4a8=w4a8_job, nextqa=nextqa)
    for procs, _ in groups.values():
        for p in procs:
            if p.poll() is None:
                p.kill()


def _jax_mesh_run(tree, job, mesh_cfg, quantize):
    """JAX's cached eval on the loaded weights, then its train step
    (N_UPDATES), under the mesh → (metrics, trainables, eval scores)."""
    devs = cpu8()
    cfg = JModelConfig(**job["cfg"])
    mesh = jmesh_mod.make_mesh(mesh_cfg, devices=devs)
    jmodel = JModel(cfg, dtype=jnp.float32, frozen_dtype=jnp.float32,
                    trainable_dtype=jnp.float32, use_flash=False,
                    seq_shard=mesh_cfg.sp > 1, **jquant_flags(quantize))
    tcfg = JTrainConfig(accum_iter=ACCUM, vaq=True, qav=True, **TCFG)
    tx = jmake_optimizer(tcfg, STEPS_PER_EPOCH, WORLD_BATCH)
    step = jmake_train_step(jmodel, tx, vaq=True, qav=True,
                            lr_fn=jlr_schedule(tcfg, STEPS_PER_EPOCH,
                                               WORLD_BATCH))
    trainable, frozen = partition_params(tree)
    opt_state = tx.init(trainable)
    metrics = []
    with mesh:
        t = jax.device_put(trainable,
                           jmesh_mod.param_shardings(mesh, trainable))
        f = jax.device_put(frozen, jmesh_mod.param_shardings(mesh, frozen))
        o = jax.device_put(opt_state, NamedSharding(mesh, P()))
        eb = {k: jax.device_put(v, NamedSharding(mesh, P("dp")))
              for k, v in job["eval_batch"].items()
              if isinstance(v, np.ndarray) and v.ndim
              and k not in ("answer", "qtype", "qid")}
        scores = np.asarray(jmake_eval_step(jmodel, cached=True)(
            t, f, eb)["scores"])
        b = {k: jax.device_put(v, NamedSharding(mesh, P(None, "dp")))
             for k, v in job["batch"].items()}
        for _ in range(N_UPDATES):
            t, o, m = step(t, o, f, b)
            metrics.append([float(x) for x in m])
    return np.array(metrics), jax.device_get(t), scores


def _jax_pp_run(tree, job, mesh_cfg):
    """`_jax_mesh_run` on JAX's `PipelinedModel`: the stacked tree on the
    mesh, the cached eval, then N_UPDATES of the train step → (metrics,
    the trainables unstacked, eval scores)."""
    cfg = JModelConfig(**job["cfg"])
    mesh = jmesh_mod.make_mesh(mesh_cfg, devices=cpu8())
    pmodel = PipelinedModel(JModel(
        cfg, dtype=jnp.float32, frozen_dtype=jnp.float32,
        trainable_dtype=jnp.float32, use_flash=False,
        seq_shard=mesh_cfg.sp > 1), mesh_cfg.pp_microbatches)
    tcfg = JTrainConfig(accum_iter=ACCUM, vaq=True, qav=True, **TCFG)
    tx = jmake_optimizer(tcfg, STEPS_PER_EPOCH, WORLD_BATCH)
    step = jmake_train_step(pmodel, tx, vaq=True, qav=True,
                            lr_fn=jlr_schedule(tcfg, STEPS_PER_EPOCH,
                                               WORLD_BATCH))
    trainable, frozen = (stack_layer_params(x, cfg.n_layers)
                         for x in partition_params(tree))
    metrics = []
    with jax.set_mesh(mesh):
        t = jax.device_put(trainable,
                           jmesh_mod.param_shardings(mesh, trainable))
        f = jax.device_put(frozen, jmesh_mod.param_shardings(mesh, frozen))
        o = jax.jit(tx.init)(t)
        eb = {k: jax.device_put(v, NamedSharding(mesh, P("dp")))
              for k, v in job["eval_batch"].items()
              if isinstance(v, np.ndarray) and v.ndim
              and k not in ("answer", "qtype", "qid")}
        scores = np.asarray(jmake_eval_step(pmodel, cached=True)(
            t, f, eb)["scores"])
        b = {k: jax.device_put(v, NamedSharding(mesh, P(None, "dp")))
             for k, v in job["batch"].items()}
        for _ in range(N_UPDATES):
            t, o, m = step(t, o, f, b)
            metrics.append([float(x) for x in m])
    return (np.array(metrics),
            unstack_layer_params(jax.device_get(t), cfg.n_layers), scores)


def _eval_arrays(job):
    return {k: v for k, v in job["eval_batch"].items()
            if isinstance(v, np.ndarray) and v.ndim
            and k not in ("answer", "qtype", "qid")}


def _jax_pp_gen(tree, job, mesh_cfg):
    """JAX's pipelined cached eval and generation step under the mesh →
    (scores, generated tokens, similarities)."""
    cfg = JModelConfig(**job["cfg"])
    mesh = jmesh_mod.make_mesh(mesh_cfg, devices=cpu8())
    pmodel = PipelinedModel(JModel(cfg, dtype=jnp.float32,
                                   frozen_dtype=jnp.float32),
                            mesh_cfg.pp_microbatches)
    trainable, frozen = (stack_layer_params(x, cfg.n_layers)
                         for x in partition_params(tree))
    with jax.set_mesh(mesh):
        t = jax.device_put(trainable,
                           jmesh_mod.param_shardings(mesh, trainable))
        f = jax.device_put(frozen, jmesh_mod.param_shardings(mesh, frozen))
        eb = {k: jax.device_put(v, NamedSharding(mesh, P("dp")))
              for k, v in _eval_arrays(job).items()}
        scores = np.asarray(jmake_eval_step(pmodel, cached=True)(
            t, f, eb)["scores"])
        gen = jmake_generation_step(pmodel, job["eos_id"])(t, f, eb)
        return (scores, np.asarray(gen["generated"]),
                np.asarray(gen["similarity"]))


def _jax_gen(tree, job):
    """JAX's generation step on one device → (generated, similarity)."""
    cfg = JModelConfig(**job["cfg"])
    jmodel = JModel(cfg, dtype=jnp.float32, frozen_dtype=jnp.float32)
    trainable, frozen = partition_params(tree)
    eb = {k: jnp.asarray(v) for k, v in _eval_arrays(job).items()}
    with jax.default_device(cpu8()[0]):
        gen = jmake_generation_step(jmodel, job["eos_id"])(trainable,
                                                           frozen, eb)
        return np.asarray(gen["generated"]), np.asarray(gen["similarity"])


def _check_trainables(ranks, jtrainable, check):
    for path, leaf in flatten_flax(jtrainable).items():
        if leaf is None:
            continue
        name = flax_path_to_torch_name(path)
        want = np.asarray(leaf)
        for r, out in enumerate(ranks):
            got = out["trainable"][name].numpy()
            check(got.T if got.shape != want.shape else got, want,
                  f"rank {r} {name}")


def _scores(ranks, dp):
    """The global eval scores from each dp row's first rank."""
    per_row = len(ranks) // dp
    return np.concatenate([ranks[i * per_row]["scores"].numpy()
                           for i in range(dp)])


ATTN_NAMES = ("q", "k", "v", "adapter_k", "adapter_v", "gate1", "gate2")


def _jax_attention(a):
    """JAX's adapter_gated_attention under the dp2×sp2×tp2 mesh, q/k/v
    sharded (dp, sp, tp) → (out (B, S, H, Dh), its seven grads)."""
    mesh = jmesh_mod.make_mesh(JMeshConfig(dp=2, sp=2, tp=2), devices=cpu8())

    def f(*xs):
        return adapter_gated_attention(*xs, a["video_start"], a["max_feats"])

    with mesh:
        spec = NamedSharding(mesh, P("dp", "sp", "tp", None))
        args = [jax.device_put(a[n], spec) if a[n].ndim == 4 else a[n]
                for n in ATTN_NAMES]
        out, vjp = jax.vjp(jax.jit(f), *args)
        grads = [np.asarray(g) for g in vjp(jnp.asarray(a["g"]))]
    return np.asarray(out).reshape(a["q"].shape), grads


def test_sp_attention_matches_jax_value_and_grads(spawned):
    """dp2×sp2×tp2: each rank's out and dq/dk/dv rows against JAX's at its
    (dp rows, sp rows, tp heads); the adapter and gate grads, partial sums
    over a rank's rows, summed over dp×sp against JAX's whole-batch
    grads."""
    a = spawned["attn"]
    out, grads = spawned["jax"]["attention"]
    ranks = _collect(spawned["groups"]["ranks"], "attention")
    b, s, h, _ = a["q"].shape
    summed = [np.zeros_like(g) for g in grads[3:]]
    for r, res in enumerate(ranks):
        di, si, ti = r // 4, (r // 2) % 2, r % 2
        rows = slice(di * b // 2, (di + 1) * b // 2)
        seq = slice(si * s // 2, (si + 1) * s // 2)
        heads = slice(ti * h // 2, (ti + 1) * h // 2)
        att = res
        np.testing.assert_allclose(
            att["out"].numpy().reshape(b // 2, s // 2, h // 2, -1),
            out[rows, seq, heads], err_msg=f"rank {r} out", **ATTN_TOL)
        for i, n in enumerate(ATTN_NAMES[:3]):
            np.testing.assert_allclose(att["grads"][i].numpy(),
                                       grads[i][rows, seq, heads],
                                       err_msg=f"rank {r} d{n}", **ATTN_TOL)
        for i in range(4):
            g = att["grads"][3 + i].numpy()
            if g.ndim == 3:
                summed[i][:, heads] += g
            else:
                summed[i][heads] += g
    for n, got, want in zip(ATTN_NAMES[3:], summed, grads[3:]):
        np.testing.assert_allclose(got, want, err_msg=f"d{n}", **ATTN_TOL)


@pytest.mark.parametrize("run", ["none", "qkv"])
def test_dp2_sp2_tp2_step_and_eval_match_jax(spawned, run):
    """Two updates (accum 2) and one cached eval batch at dp2×sp2×tp2:
    every rank's losses, grad norm, lr and updated trainables, and the
    dp rows' scores, against JAX's step and eval under the same mesh;
    every rank's update-2 gradients against the single-rank port's
    (GRAD_TOL); every rank's frozen pieces unchanged. "qkv" runs the
    blocks under remat with the qkv policy (the sp attention's stash) and
    the LM head in chunks (`lm_ce_rowwise_chunked` on each rank's rows),
    which compute the same losses and gradients."""
    metrics, jtrainable, jscores = spawned["jax"]["none"]
    assert metrics[0, 0] > 1.0          # labels survive the prompt length
    ranks = _collect(spawned["groups"]["ranks"], run)
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(np.array(out["metrics"]), metrics,
                                   err_msg=f"rank {r}", **LOSS_TOL)
        assert out["frozen_same"], r
        assert out["heads"] == KW["n_heads"] // 2        # heads split
        assert out["sp_whole_calls"] == 0 and not out["sp_warnings"]
    _check_trainables(ranks, jtrainable,
                      lambda got, want, msg: np.testing.assert_allclose(
                          got, want, err_msg=msg, **PARAM_TOL))
    np.testing.assert_allclose(_scores(ranks, 2), jscores, **SCORE_TOL)
    job = spawned["f32"]
    if run == "qkv":
        job = dict(job, remat_policy="qkv", lm_chunk=LM_CHUNK)
    _check_grads(ranks, _single_rank(job))


def test_indivisible_sequence_under_sp_matches_one_rank(spawned):
    """S 95 at dp2×sp2×tp2: sp 2 does not divide it, so every sp rank holds
    the whole sequence, and its attention goes through the single-rank
    `flash_adapter_attention` with JAX's warning. Losses, grad norm, lr,
    trainables and eval scores equal the single-rank port's run of the
    same job (f32, only the order of the sums differs: LOSS_TOL,
    PARAM_TOL, SCORE_TOL), update 2's gradients within GRAD_TOL; frozen
    pieces unchanged."""
    want = _single_rank(spawned["odd"])
    assert want["sp_whole_calls"] == 0
    ranks = _collect(spawned["groups"]["ranks"], "odd")
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["metrics"], want["metrics"],
                                   err_msg=f"rank {r}", **LOSS_TOL)
        assert out["frozen_same"], r
        assert out["sp_whole_calls"] > 0, r
        assert out["sp_warnings"] == [
            "sequence-parallel flash kernels skipped (S=95 % sp=2 != 0); "
            "every sp rank attends over the whole sequence with the "
            "single-rank flash kernels. Pick sp/dp that divide S and B "
            "evenly."], r
        assert out["trainable"].keys() == want["trainable"].keys()
        for name, got in out["trainable"].items():
            np.testing.assert_allclose(got.numpy(),
                                       want["trainable"][name].numpy(),
                                       err_msg=f"rank {r} {name}",
                                       **PARAM_TOL)
    np.testing.assert_allclose(_scores(ranks, 2), want["scores"].numpy(),
                               **SCORE_TOL)
    _check_grads(ranks, want)


def test_w8a8d_dp4_tp2_step_and_eval_match_jax(spawned):
    """w8a8d at dp4×tp2: the quantized blocks and head replicate (only the
    embedding splits), so the forwards are w8a8's on both sides (K3's
    plain version is JAX's bit for bit): losses and the eval scores to
    1e-4 relative. The backward's stochastic rounding hashes each
    cotangent's bits, which differ in their last ulp between the two
    packages' sum orders, so codes may flip (tests/test_torch_dgrad.py's
    rule): the grad norm agrees to 1e-2 relative and each trainable after
    the second update within twice its lr. The eval scores agree to f32
    rounding until an activation code differs between the two forwards,
    then to QUANT_SCORE_REL of the largest (tests/test_torch_quant_model.py;
    measured 1.6e-4 relative, in one row). Update 2's gradients against
    the single-rank port's within GRAD_TOL plus SR_NOISE times the single
    rank's own noise (its w8a8d gradient's distance from its w8a8 one)."""
    metrics, jtrainable, jscores = spawned["jax"]["w8a8d"]
    ranks = _collect(spawned["groups"]["ranks"], "w8a8d")
    lr = metrics[-1, 5]
    for r, out in enumerate(ranks):
        ours = np.array(out["metrics"])
        np.testing.assert_allclose(ours[:, :4], metrics[:, :4], rtol=1e-4,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(ours[:, 4], metrics[:, 4], rtol=1e-2)
        np.testing.assert_allclose(ours[:, 5], metrics[:, 5], rtol=1e-6)
        assert out["frozen_same"], r
        assert out["heads"] == QKW["n_heads"]            # replicated

    def within_lr(got, want, msg):
        assert np.abs(got - want).max() <= 2 * lr, msg
    _check_trainables(ranks, jtrainable, within_lr)
    ours = _scores(ranks, 4)
    assert np.abs(ours - jscores).max() <= QUANT_SCORE_REL * np.abs(
        jscores).max()
    want = _single_rank(spawned["w8a8d"])
    exact = _single_rank(dict(spawned["w8a8d"], quantize="w8a8"))["grads"]
    _check_grads(ranks, want, {n: float((g - exact[n]).norm())
                               for n, g in want["grads"].items()})


def test_generation_cli_under_dp2_matches_one_process(spawned):
    """`cli.train --dp 2 --is_generation_task` on two gloo ranks: rank 0
    alone writes log.txt (one line for one epoch), the merged
    extracted_answers_epoch0.json holds every val row once, and its
    answers are the single-process run's (--lr 0, so both generate from
    the same weights). Both run --debug: one update and one val batch a
    rank, two rows a rank under dp 2 and all four rows in one process."""
    procs, out_dp2 = spawned["groups"]["gen"]
    _wait(procs)
    procs, single = spawned["groups"]["gen_single"]
    _wait(procs)
    with open(out_dp2 / "log.txt") as f:
        lines = f.read().splitlines()
    assert len(lines) == 1 and "val_acc" in json.loads(lines[0])
    read = lambda d: json.load(open(
        d / "extracted_answers" / "extracted_answers_epoch0.json"))
    ours, want = read(out_dp2), read(single)
    qids = [r["qid"] for r in ours]
    assert sorted(qids) == sorted(r["qid"] for r in want)
    assert len(set(qids)) == len(qids) == 4
    assert ({r["qid"]: r["generated_answer"] for r in ours}
            == {r["qid"]: r["generated_answer"] for r in want})
    for r in (0, 1):
        assert (out_dp2 / "extracted_answers"
                / f"extracted_answers_epoch0_rank{r}.json").exists()


def _dp_rows(ranks, dp, key):
    """`key` of the dp rows, in order, from each row's first rank; every
    rank of a row holds the same."""
    per_row = len(ranks) // dp
    for r, out in enumerate(ranks):
        first = ranks[r - r % per_row][key]
        assert torch.equal(out[key], first), (r, key)
    return np.concatenate([ranks[i * per_row][key].numpy()
                           for i in range(dp)])


def test_dp1_pp2_sp2_tp2_step_and_eval_match_jax(spawned):
    """JAX's dry-run pp leg: two updates (accum 2) and one cached eval batch
    with the blocks in two stages (2 microbatches of the 12 stacked rows
    and of the 4 eval rows), the sp ranks on K5/K6's plain versions inside
    the stages and the tp ranks on half the heads: every rank's losses,
    grad norm, lr and updated trainables, and the scores, against JAX's
    `PipelinedModel` under the same mesh (LOSS_TOL, PARAM_TOL,
    SCORE_TOL); update 2's gradients against the single-rank port's
    (GRAD_TOL): the dp×pp×sp sum counts each use of a trainable once."""
    metrics, jtrainable, jscores = spawned["jax"]["pp_sp_tp"]
    assert metrics[0, 0] > 1.0
    ranks = _collect(spawned["groups"]["ranks"], "pp_sp_tp")
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(np.array(out["metrics"]), metrics,
                                   err_msg=f"rank {r}", **LOSS_TOL)
        assert out["frozen_same"], r
        assert out["heads"] == KW["n_heads"] // 2
        assert out["microbatches"] and set(out["microbatches"]) == {2}, r
    _check_trainables(ranks, jtrainable,
                      lambda got, want, msg: np.testing.assert_allclose(
                          got, want, err_msg=msg, **PARAM_TOL))
    np.testing.assert_allclose(_scores(ranks, 1), jscores, **SCORE_TOL)
    _check_grads(ranks, _single_rank(spawned["f32"]))


def test_pp_generation_and_cached_eval_match_jax(spawned):
    """dp4×pp2 with --pp_microbatches 3: a dp row's 2 eval rows take 2
    microbatches, as JAX's `_pick_microbatches` shrinks it; the cached
    scores, the generated tokens (equal) and their similarities against
    JAX's pipelined prefill, extend and decode under the same mesh."""
    jscores, jgen, jsim = spawned["jax"]["pp_gen"]
    ranks = _collect(spawned["groups"]["ranks"], "pp_gen")
    from flipped_tpu.model.pipeline import _pick_microbatches

    for r, out in enumerate(ranks):
        assert out["microbatches"] == [_pick_microbatches(3, 2, 2)] * len(
            out["microbatches"]) == [2] * 3, r      # prefill, extend, prefill
    np.testing.assert_array_equal(_dp_rows(ranks, 4, "generated"), jgen)
    np.testing.assert_allclose(_dp_rows(ranks, 4, "similarity"), jsim,
                               **SIM_TOL)
    np.testing.assert_allclose(_dp_rows(ranks, 4, "scores"), jscores,
                               **SCORE_TOL)


def test_sp_tp_generation_matches_jax_and_one_rank(spawned):
    """dp2×sp2×tp2 generation: every sp rank prefills and decodes the whole
    prompt, a tp rank its heads against a cache of its heads. The tokens
    equal JAX's `make_generation_step` on one device and the single-rank
    port's."""
    jgen, jsim = spawned["jax"]["gen"]
    ranks = _collect(spawned["groups"]["ranks"], "sp_tp_gen")
    from flipped_tpu_torch.core.mesh import make_mesh

    one = _worker().run_gen(spawned["gen"], make_mesh(MeshConfig(dp=1)))
    np.testing.assert_array_equal(one["generated"].numpy(), jgen)
    np.testing.assert_array_equal(_dp_rows(ranks, 2, "generated"), jgen)
    np.testing.assert_allclose(_dp_rows(ranks, 2, "similarity"), jsim,
                               **SIM_TOL)
    np.testing.assert_allclose(_dp_rows(ranks, 2, "scores"),
                               one["scores"].numpy(), **SCORE_TOL)


def test_w4a8_dp4_pp2_step_and_eval_match_one_rank(spawned):
    """w4a8 in two stages on four dp rows (one microbatch of 3 rows a
    rank: pp 2 does not divide them): one update and the cached eval
    against the single-rank port's run of the same job (the int4 plain
    versions' integer dots are exact, the f32 sums differ only in order:
    LOSS_TOL, PARAM_TOL, SCORE_TOL; the gradients QUANT_GRAD_REL); frozen
    leaves unchanged."""
    want = _single_rank(spawned["w4a8"])
    ranks = _collect(spawned["groups"]["ranks"], "w4a8")
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["metrics"], want["metrics"],
                                   err_msg=f"rank {r}", **LOSS_TOL)
        assert out["frozen_same"], r
        for name, got in out["trainable"].items():
            np.testing.assert_allclose(got.numpy(),
                                       want["trainable"][name].numpy(),
                                       err_msg=f"rank {r} {name}",
                                       **PARAM_TOL)
    np.testing.assert_allclose(_scores(ranks, 4), want["scores"].numpy(),
                               **SCORE_TOL)
    _check_grads(ranks, want, rel=QUANT_GRAD_REL)


def test_pp2_checkpoint_matches_one_process_and_resumes_at_pp1(spawned):
    """`cli.train --pp 2` (one update at lr 1e-2) writes the whole adapter
    from rank 0. Its AdamW first moments, a tenth of the update's
    gradients, are the single-process run's within BF16_GRAD_REL of each
    leaf's norm; its trainables within twice the lr of the single run's
    (AdamW's first step moves an element by about lr whatever its
    gradient, so an element whose gradient is within f32 rounding of zero
    may move either way), and have moved. A pp-1 build restores them, bit
    for bit, with the optimizer's state (resuming at the update count
    1)."""
    from flipped_tpu_torch.ckpt import CheckpointManager
    from flipped_tpu_torch.core.config import (get_args_parser,
                                               run_config_from_args)
    from flipped_tpu_torch.train import build_train_state, make_optimizer

    for key in ("ckpt_pp2", "ckpt_single"):
        _wait(spawned["groups"][key][0])
    out_pp2 = spawned["groups"]["ckpt_pp2"][1]
    load = lambda d: torch.load(d / "checkpoint_last" / "state.pt",
                                weights_only=True)
    saved = load(out_pp2)
    single = load(spawned["groups"]["ckpt_single"][1])
    assert saved["trainable"].keys() == single["trainable"].keys()
    moments = lambda st: {n: v["exp_avg"] for n, v in
                          st["optimizer"]["params"].items()}
    want = moments(single)
    assert moments(saved).keys() == want.keys() == saved["trainable"].keys()
    for name, m in moments(saved).items():
        diff = float((m - want[name]).norm())
        assert diff <= BF16_GRAD_REL * float(want[name].norm()), (name,
                                                                  diff)
    lr = float(CKPT_ARGV[CKPT_ARGV.index("--lr") + 1])
    for name, t in saved["trainable"].items():
        assert float((t - single["trainable"][name]).abs().max()) <= \
            2 * lr, name
    run = run_config_from_args(get_args_parser().parse_args(
        CKPT_ARGV + ["--data_root", str(spawned["nextqa"]),
                     "--output_dir", str(out_pp2)]))
    model, _, _ = build_train_state(run, "cpu", seed=run.train.seed)
    init = {n: p.detach().clone() for n, p in model.named_parameters()
            if p.requires_grad}
    opt = make_optimizer(model, run.train, 1, 4)
    meta = CheckpointManager(str(out_pp2)).restore("checkpoint_last", model,
                                                   opt)
    assert meta["epoch"] == 0 and opt.count == 1
    moved = 0
    for name, p in model.named_parameters():
        if p.requires_grad:
            assert torch.equal(p, saved["trainable"][name]), name
            moved += not torch.equal(p, init[name])
    assert moved > 0
