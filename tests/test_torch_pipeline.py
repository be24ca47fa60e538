"""The port's pipeline parallelism against the JAX package, in one process
(the spawned ranks are in tests/test_torch_parallel.py).

- `pick_microbatches` is JAX's `_pick_microbatches` for every input of a
  grid, and `validate_pp` raises where JAX's raises, with its messages.
- `--pp 2 --pp_microbatches 3` reaches the port's `MeshConfig` as it
  reaches JAX's (tests/test_pipeline.py:113).
- The blocks each stage keeps are the layers that JAX's `param_shardings`
  puts on each device of the stacked layer axis (8 virtual CPU devices).
- A state dict cut by `keeps_leaf` and `shard_leaf` under pp keeps every
  trainable and, of the frozen leaves, those of its stage's blocks,
  tp-cut.
- A rank's build under pp (random init, a quantized init, and Meta
  shards) allocates only its stage's frozen leaves, and each kept leaf is
  the single rank's bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from flipped_tpu.core import mesh as jmesh_mod
from flipped_tpu.core.config import MeshConfig as JMeshConfig
from flipped_tpu.core.config import ModelConfig as JModelConfig
from flipped_tpu.core.config import get_args_parser as jget_args_parser
from flipped_tpu.core.config import run_config_from_args as jrun_config
from flipped_tpu.model.pipeline import _pick_microbatches
from flipped_tpu.model.pipeline import validate_pp as jvalidate_pp
from flipped_tpu_torch.ckpt.convert import export_meta_checkpoint
from flipped_tpu_torch.core.config import (MeshConfig, ModelConfig,
                                           get_args_parser,
                                           run_config_from_args, validate_pp)
from flipped_tpu_torch.core.mesh import (Mesh, keeps_leaf, rank_grid,
                                         shard_leaf, stage_layers)
from flipped_tpu_torch.model import pipeline
from flipped_tpu_torch.train import build_eval_state, is_trainable

JCFG = dict(dim=32, n_layers=4, n_heads=4, vocab_size=128, multiple_of=16,
            max_seq_len=96, adapter_len=4, adapter_layer=4, max_feats=4,
            visual_dim=16)


def cpu8():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return devs[:8]


def test_pick_microbatches_matches_jax():
    for requested in range(6):
        for pp in range(1, 5):
            for rows in range(1, 25):
                assert pipeline.pick_microbatches(requested, pp, rows) == \
                    _pick_microbatches(requested, pp, rows), (requested, pp,
                                                              rows)


def test_stripe_and_unstripe_are_jax_striping():
    """Microbatch t holds rows {t, M+t, ...}, and `unstripe` inverts it."""
    x = torch.arange(24).view(12, 2)
    parts = pipeline.stripe(x, 3)
    assert [p[:, 0].tolist() for p in parts] == [[0, 6, 12, 18],
                                                 [2, 8, 14, 20],
                                                 [4, 10, 16, 22]]
    assert torch.equal(pipeline.unstripe(torch.stack(parts)), x)


@pytest.mark.parametrize("mesh,layers,window,gen", [
    (dict(dp=2, pp=2), 4, 4, False), (dict(dp=1, pp=2, tp=2), 4, 4, False),
    (dict(dp=1, pp=2, sp=2), 4, 4, True), (dict(dp=1, pp=3), 4, 4, False),
    (dict(dp=1, pp=2), 4, 2, False), (dict(dp=1, pp=4), 4, 4, True),
    (dict(dp=1, pp=1), 3, 1, False)])
def test_validate_pp_raises_where_jax_raises(mesh, layers, window, gen):
    jcfg = JModelConfig(**dict(JCFG, n_layers=layers, adapter_layer=window))
    cfg = ModelConfig(**dict(JCFG, n_layers=layers, adapter_layer=window))
    try:
        jvalidate_pp(JMeshConfig(**mesh), jcfg, is_generation_task=gen)
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        validate_pp(MeshConfig(**mesh), cfg, is_generation_task=gen)
    else:
        with pytest.raises(ValueError) as got:
            validate_pp(MeshConfig(**mesh), cfg, is_generation_task=gen)
        assert str(got.value) == want


def test_cli_pp_flags_reach_mesh_config():
    argv = ["--dp", "2", "--pp", "2", "--pp_microbatches", "3"]
    ours = run_config_from_args(get_args_parser().parse_args(argv)).mesh
    ref = jrun_config(jget_args_parser().parse_args(argv)).mesh
    assert (ours.dp, ours.pp, ours.pp_microbatches) == (2, 2, 3)
    assert (ref.dp, ref.pp, ref.pp_microbatches) == \
        (ours.dp, ours.pp, ours.pp_microbatches)


@pytest.mark.parametrize("shape", [(4, 2, 1, 1), (1, 2, 2, 2), (2, 4, 1, 1),
                                   (1, 8, 1, 1)])
def test_stage_layers_are_where_jax_puts_the_stacked_layers(shape):
    """Every rank of the grid holds the layers that JAX's `param_shardings`
    places on its device of the stacked (n_layers, ...) axis (P('pp'))."""
    devs = cpu8()
    dp, pp, sp, tp = shape
    n_layers = 8
    jm = jmesh_mod.make_mesh(JMeshConfig(dp=dp, pp=pp, sp=sp, tp=tp),
                             devices=devs)
    spec = jmesh_mod.param_pspec("layers_stacked/attention/gate1")
    layer = jax.device_put(np.arange(n_layers)[:, None].repeat(4, 1),
                           NamedSharding(jm, spec))
    grid = rank_grid(MeshConfig(dp=dp, pp=pp, sp=sp, tp=tp), 8)
    for r in range(8):
        shard = next(s for s in layer.addressable_shards
                     if s.device == devs[r])
        want = sorted(set(np.asarray(shard.data)[:, 0].tolist()))
        assert list(stage_layers(Mesh(grid, r), n_layers)) == want, r
    assert spec == P("pp")


def _tiny_state(seed=0, **kw):
    cfg = ModelConfig(**dict(JCFG, **kw))
    from flipped_tpu_torch.model import FlippedVQAModel
    from flipped_tpu_torch.train import init_params

    model = FlippedVQAModel(cfg, dtype=torch.float32,
                            frozen_dtype=torch.float32)
    init_params(model, seed)
    return cfg, model.state_dict()


def shard_state_dict(full, mesh, n_layers):
    """A full state dict cut to this rank's pieces, leaf by leaf, as
    `parallelize` cuts a model."""
    return {name: shard_leaf(name, t, mesh) for name, t in full.items()
            if keeps_leaf(name, mesh, n_layers)}


@pytest.mark.parametrize("shape", [(2, 2, 1, 2), (1, 4, 1, 2)])
def test_shard_state_dict_under_pp(shape):
    """Every trainable on every rank, whole; of the frozen leaves those
    outside the blocks and those of the rank's stage's blocks, tp-cut as
    without pp."""
    dp, pp, sp, tp = shape
    cfg, full = _tiny_state()
    grid = rank_grid(MeshConfig(dp=dp, pp=pp, sp=sp, tp=tp), 8)
    no_pp = rank_grid(MeshConfig(dp=dp * pp, tp=tp), 8)
    for r in range(8):
        mesh = Mesh(grid, r)
        pieces = shard_state_dict(full, mesh, cfg.n_layers)
        ref = shard_state_dict(full, Mesh(no_pp, int(
            no_pp[0, 0, 0, mesh.index("tp")])), cfg.n_layers)
        mine = stage_layers(mesh, cfg.n_layers)
        for name, t in full.items():
            block = (int(name.split(".")[1]) if name.startswith("layers.")
                     else None)
            kept = (is_trainable(name) or block is None or block in mine)
            assert (name in pieces) == kept, (r, name)
            if kept:
                assert torch.equal(pieces[name], ref[name]), (r, name)


def _run_cfg(tmp_path, quantize="none", pp=1, model_path=None):
    argv = ["--model", "tiny", "--device", "cpu", "--quantize", quantize,
            "--pp", str(pp), "--llama_model_path",
            str(model_path or tmp_path / "none")]
    return run_config_from_args(get_args_parser().parse_args(argv))


@pytest.mark.parametrize("source", ["random", "w8a8", "meta shards"])
def test_stage_build_keeps_the_single_ranks_leaves(tmp_path, source):
    """build_eval_state for each stage of a dp1×pp2 grid (no process
    group: tp 1 needs none): the frozen leaves of the other stage's blocks
    are empty and listed in `model.dropped` with their full shapes, and
    every other leaf equals the single rank's build bit for bit: random
    init (the dropped leaves' draws taken on transient tensors), the
    quantized init, and Meta shards (the dropped blocks' leaves not
    read)."""
    quantize = "w8a8" if source == "w8a8" else "none"
    model_path = None
    if source == "meta shards":
        model_path = tmp_path / "llama"
        cfg, full = _tiny_state(seed=3, n_layers=2, adapter_layer=2,
                                vocab_size=512, dim=64, multiple_of=32)
        params = dict(dim=64, n_layers=2, n_heads=4, multiple_of=32,
                      norm_eps=1e-6, vocab_size=512)
        export_meta_checkpoint({k: v.to(torch.bfloat16) for k, v in
                                full.items()}, 2, model_path / "tiny", params)
    run = _run_cfg(tmp_path, quantize, model_path=model_path)
    single, cfg, _ = build_eval_state(run, "cpu", seed=5)
    want = dict(single.named_parameters())
    read = []
    if source == "meta shards":
        from flipped_tpu_torch.ckpt import convert

        load = convert.load_meta_checkpoint

        def counted(*a, **kw):
            for name, t in load(*a, **kw):
                read.append(name)
                yield name, t
        from flipped_tpu_torch.train import builder
        builder.load_meta_checkpoint = counted
    try:
        grid = rank_grid(MeshConfig(dp=1, pp=2), 2)
        for r in range(2):
            mesh = Mesh(grid, r)
            model, _, _ = build_eval_state(_run_cfg(tmp_path, quantize, 2,
                                                    model_path),
                                           "cpu", seed=5, mesh=mesh)
            mine = stage_layers(mesh, cfg.n_layers)
            for name, p in model.named_parameters():
                other = (name.startswith("layers.") and not is_trainable(name)
                         and int(name.split(".")[1]) not in mine)
                if other:
                    assert p.numel() == 0, name
                    assert model.dropped[name] == tuple(want[name].shape)
                else:
                    assert torch.equal(p, want[name]), (r, name)
            assert len(model.dropped) == sum(
                1 for n in want if n.startswith("layers.")
                and not is_trainable(n)) // 2
    finally:
        if source == "meta shards":
            builder.load_meta_checkpoint = load
    if source == "meta shards":
        # the two stages read each block's leaves once between them
        shard = torch.load(model_path / "tiny" / "consolidated.00.pth")
        assert sorted(n for n in read if n.startswith("layers.")) == \
            sorted(n for n in shard if n.startswith("layers."))


def test_validate_pp_runs_before_the_build(tmp_path):
    run = run_config_from_args(get_args_parser().parse_args(
        ["--model", "tiny", "--device", "cpu", "--pp", "2",
         "--adapter_layer", "1", "--llama_model_path", str(tmp_path)]))
    with pytest.raises(ValueError, match="adapter_layer == n_layers"):
        build_eval_state(run, "cpu", mesh=Mesh(rank_grid(run.mesh, 2), 0))
