"""The JAX command-line flags the port's parser accepts: the mesh axes
(--dp, --tp, --sp, --pp, --pp_microbatches), --num_workers, --trace_dir and
--no_flash.

A tiny-preset command line carrying each flag runs the train CLI on the CPU,
or raises: --dp, --tp, --sp or --pp above 1 in one process asks for a grid
larger than its one rank (core/mesh.py's ValueError); the evaluate and
profile CLIs refuse the same. --no_flash routes attention
through the einsum `adapter_gated_attention`, and a train step with it
gives the JAX package's --no_flash losses on the same weights and batch.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flipped_tpu.core.config import ModelConfig as JModelConfig
from flipped_tpu.core.config import TrainConfig as JTrainConfig
from flipped_tpu.data import add_accum_axis, make_synthetic_items, \
    pack_train_batch
from flipped_tpu.model import FlippedVQAModel as JModel
from flipped_tpu.text import MockTokenizer
from flipped_tpu.train import make_optimizer as jmake_optimizer
from flipped_tpu.train import make_train_step as jmake_train_step
from flipped_tpu.train import partition_params
from flipped_tpu.train.optim import lr_schedule as jlr_schedule
from flipped_tpu_torch.ckpt import params_from_flax
from flipped_tpu_torch.cli import evaluate as tevaluate
from flipped_tpu_torch.cli import profile as tprofile
from flipped_tpu_torch.cli import train as ttrain
from flipped_tpu_torch.core.config import (ModelConfig, TrainConfig,
                                           get_args_parser,
                                           run_config_from_args)
from flipped_tpu_torch.data.synthetic import make_nextqa
from flipped_tpu_torch.model import FlippedVQAModel
from flipped_tpu_torch.model import llama as tllama
from flipped_tpu_torch.train import make_optimizer, make_train_step

KW = dict(dim=32, n_layers=2, n_heads=4, vocab_size=512, multiple_of=16,
          max_seq_len=96, adapter_len=4, adapter_layer=2, max_feats=4,
          visual_dim=16)
TCFG = dict(epochs=8, warmup_epochs=1.0, lr=1e-2, weight_decay=0.1)
STEPS_PER_EPOCH, WORLD_BATCH = 4, 4
# f32 on both sides, the same einsum formulation: as tests/test_torch_train
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_flags_data")
    make_nextqa(str(root), 8, np.random.RandomState(0))
    return str(root)


def _args(synth_root, *extra):
    return get_args_parser().parse_args(
        ["--model", "tiny", "--dataset", "nextqa", "--data_root", synth_root,
         "--batch_size", "2", "--device", "cpu", "--debug", "--epochs", "1",
         "--output_dir", "", *extra])


def test_jax_flags_parse_with_jax_defaults():
    from flipped_tpu.core.config import get_args_parser as jget_args_parser

    ours = vars(get_args_parser().parse_args([]))
    ref = vars(jget_args_parser().parse_args([]))
    for name in ("dp", "tp", "sp", "pp", "pp_microbatches", "num_workers",
                 "trace_dir", "no_flash"):
        assert ours[name] == ref[name], name


# a JAX-style command line: each flag at the value one card runs
@pytest.mark.parametrize("extra", [
    ["--dp", "1", "--tp", "1", "--sp", "1", "--pp", "1", "--num_workers",
     "2"],
    ["--dp", "-1"], ["--pp_microbatches", "4"], ["--num_workers", "0"],
    ["--trace_dir", ""], ["--no_flash"]])
def test_train_cli_runs_with_jax_flags(synth_root, extra):
    model, history = ttrain.main(_args(synth_root, *extra))
    assert history[0]["train_steps"] == 1
    assert all(np.isfinite(history[0][f"train_{k}"])
               for k in ("vqa_loss", "vaq_loss", "qav_loss"))
    use_flash = "--no_flash" not in extra
    assert all(b.attention.use_flash == use_flash
               for b in model.layers.values())


@pytest.mark.parametrize("extra,error,item", [
    (["--dp", "2"], ValueError, r"mesh 2x1x1x1 > 1 ranks"),
    (["--tp", "2"], ValueError, r"mesh 1x1x1x2 > 1 ranks"),
    (["--sp", "4"], ValueError, r"mesh 1x1x4x1 > 1 ranks"),
    (["--pp", "2"], ValueError, r"mesh 1x2x1x1 > 1 ranks")])
@pytest.mark.parametrize("cli", ["train", "evaluate", "profile"])
def test_clis_refuse_mesh_and_trace_naming_the_item(synth_root, extra, error,
                                                    item, cli):
    with pytest.raises(error, match=item):
        if cli == "train":
            ttrain.main(_args(synth_root, *extra))
        elif cli == "evaluate":
            tevaluate.main(_args(synth_root, *extra))
        else:
            tprofile.main(["--mode", "train", "--model", "tiny",
                           "--data_root", synth_root, "--device", "cpu",
                           "--output_dir", "", *extra])


@pytest.mark.parametrize("no_flash", [False, True])
def test_no_flash_routes_around_the_flash_function(synth_root, monkeypatch,
                                                   no_flash):
    """A train run with --no_flash never calls the flash Function; one
    without it calls it in every block."""
    calls = []

    def flash(*a):
        calls.append(1)
        return tllama.adapter_gated_attention(*a)

    monkeypatch.setattr(tllama, "flash_adapter_attention", flash)
    extra = ("--no_flash",) if no_flash else ()
    run_cfg = run_config_from_args(_args(synth_root, *extra))
    assert run_cfg.train.flash_attention == (not no_flash)
    ttrain.main(_args(synth_root, *extra))
    assert bool(calls) == (not no_flash)


def test_no_flash_train_step_matches_jax():
    """JAX's --no_flash (use_flash False: the einsum attention) against the
    port's, on the same weights and batch: per-objective losses, grad_norm
    and lr at each of two updates."""
    cfg = JModelConfig(**KW)
    items = make_synthetic_items(MockTokenizer(cfg.vocab_size), 4,
                                 max_feats=cfg.max_feats,
                                 max_seq_len=cfg.max_seq_len,
                                 visual_dim=cfg.visual_dim, seed=6)
    batch = pack_train_batch(items, cfg.max_feats)
    jmodel = JModel(cfg, dtype=jnp.float32, frozen_dtype=jnp.float32,
                    trainable_dtype=jnp.float32, use_flash=False)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(2), jnp.array(batch["vqa_tokens"]),
        jnp.array(batch["video"]), None, jnp.array(batch["vqa_video_start"]),
        jnp.array(batch["vqa_splice"]))["params"])
    for name, sub in params.items():
        if name.startswith("layers_"):
            sub["attention"]["gate1"] = np.full(4, 0.3, np.float32)

    jcfg = JTrainConfig(vaq=True, qav=True, **TCFG)
    tx = jmake_optimizer(jcfg, STEPS_PER_EPOCH, WORLD_BATCH)
    jstep = jmake_train_step(jmodel, tx, vaq=True, qav=True,
                             lr_fn=jlr_schedule(jcfg, STEPS_PER_EPOCH,
                                                WORLD_BATCH))
    trainable, frozen = partition_params(params)
    opt_state = tx.init(trainable)
    jb = {k: jnp.array(v) for k, v in add_accum_axis(batch, 1).items()}
    ref = []
    for _ in range(2):
        trainable, opt_state, m = jstep(trainable, opt_state, frozen, jb)
        ref.append([float(x) for x in m])

    model = FlippedVQAModel(ModelConfig(**KW), dtype=torch.float32,
                            frozen_dtype=torch.float32,
                            trainable_dtype=torch.float32, use_flash=False)
    model.load_state_dict(params_from_flax(params), strict=True)
    tcfg = TrainConfig(vaq=True, qav=True, flash_attention=False, **TCFG)
    opt = make_optimizer(model, tcfg, STEPS_PER_EPOCH, WORLD_BATCH)
    step = make_train_step(model, opt, vaq=True, qav=True)
    tb = {k: torch.tensor(v) for k, v in add_accum_axis(batch, 1).items()}
    ours = [[float(x) for x in step(tb)] for _ in range(2)]
    np.testing.assert_allclose(np.array(ours), np.array(ref), **LOSS_TOL)
