"""flipped_tpu_torch training against the JAX package, and one run of the
port's train CLI on the CPU.

Both packages start from the same weights (f32, a small model) and take the
same batches from `make_synthetic_items` + `pack_train_batch`: per-objective
losses, grad_norm and lr agree at every update, the trainables agree after
the updates, and the frozen backbone stays bitwise unchanged.
"""
import json
import subprocess
import sys

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
from flipped_tpu.train.optim import wd_mask as jwd_mask
from flipped_tpu_torch.ckpt import params_from_flax
from flipped_tpu_torch.ckpt.convert import flatten_flax, \
    flax_path_to_torch_name
from flipped_tpu_torch.cli import train as ttrain
from flipped_tpu_torch.core.config import (ModelConfig, TrainConfig,
                                           get_args_parser)
from flipped_tpu_torch.data.synthetic import make_nextqa
from flipped_tpu_torch.model import FlippedVQAModel
from flipped_tpu_torch.train import (compute_objective_losses, wd_mask,
                                     is_trainable, lr_schedule,
                                     make_optimizer, make_train_step,
                                     trainable_parameters)

KW = dict(dim=32, n_layers=2, n_heads=4, vocab_size=512, multiple_of=16,
          max_seq_len=96, adapter_len=4, adapter_layer=2, max_feats=4,
          visual_dim=16)
TCFG = dict(epochs=8, warmup_epochs=1.0, lr=1e-2, weight_decay=0.1)
STEPS_PER_EPOCH, WORLD_BATCH = 4, 4
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
# AdamW moves each trainable by about lr per update whatever the size of
# its gradient (m/sqrt(v) is scale-free), so an element whose gradient is
# within the f32 disagreement of zero may move differently by up to lr per
# update; such elements are rare, and every other element agrees to f32
# rounding of the update. Held at 1e-5 absolute, 1e-3 of the lr.
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    cfg = JModelConfig(**KW)
    items = make_synthetic_items(MockTokenizer(cfg.vocab_size), 4,
                                 max_feats=cfg.max_feats,
                                 max_seq_len=cfg.max_seq_len,
                                 visual_dim=cfg.visual_dim, seed=5)
    batch = pack_train_batch(items, cfg.max_feats)
    jmodel = JModel(cfg, dtype=jnp.float32, frozen_dtype=jnp.float32,
                    trainable_dtype=jnp.float32, use_flash=False)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(1), jnp.array(batch["vqa_tokens"]),
        jnp.array(batch["video"]), None, jnp.array(batch["vqa_video_start"]),
        jnp.array(batch["vqa_splice"]))["params"])
    # nonzero gate1 so the adapter rows get gradients from the first update
    for name, sub in params.items():
        if name.startswith("layers_"):
            sub["attention"]["gate1"] = np.full(4, 0.3, np.float32)
    return jmodel, params, batch


def torch_model(params, remat=False):
    model = FlippedVQAModel(ModelConfig(**KW), dtype=torch.float32,
                            frozen_dtype=torch.float32,
                            trainable_dtype=torch.float32, remat=remat)
    model.load_state_dict(params_from_flax(params), strict=True)
    return model


def run_jax(jmodel, params, batch, accum, vaq, qav, n_updates, clip):
    tcfg = JTrainConfig(accum_iter=accum, vaq=vaq, qav=qav, clip_grad=clip,
                        **TCFG)
    tx = jmake_optimizer(tcfg, STEPS_PER_EPOCH, WORLD_BATCH)
    step = jmake_train_step(jmodel, tx, vaq=vaq, qav=qav,
                            lr_fn=jlr_schedule(tcfg, STEPS_PER_EPOCH,
                                               WORLD_BATCH))
    trainable, frozen = partition_params(params)
    opt_state = tx.init(trainable)
    jb = {k: jnp.array(v) for k, v in add_accum_axis(batch, accum).items()}
    metrics = []
    for _ in range(n_updates):
        trainable, opt_state, m = step(trainable, opt_state, frozen, jb)
        metrics.append([float(x) for x in m])
    return metrics, jax.device_get(trainable)


def run_torch(model, batch, accum, vaq, qav, n_updates, clip):
    cfg = TrainConfig(accum_iter=accum, vaq=vaq, qav=qav, clip_grad=clip,
                      **TCFG)
    opt = make_optimizer(model, cfg, STEPS_PER_EPOCH, WORLD_BATCH)
    step = make_train_step(model, opt, vaq=vaq, qav=qav)
    tb = {k: torch.tensor(v) for k, v in add_accum_axis(batch, accum).items()}
    return [[float(x) for x in step(tb)] for _ in range(n_updates)]


# the clipped case clips: grad_norm is ~0.3 on this model and batch
@pytest.mark.parametrize("accum,vaq,qav,n_updates,clip", [
    (1, True, True, 3, None), (2, True, True, 2, 0.05),
    (1, False, False, 2, None)])
def test_train_step_matches_jax(setup, accum, vaq, qav, n_updates, clip):
    jmodel, params, batch = setup
    ref, ref_trainable = run_jax(jmodel, params, batch, accum, vaq, qav,
                                 n_updates, clip)
    model = torch_model(params)
    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
               if not is_trainable(n)}
    ours = run_torch(model, batch, accum, vaq, qav, n_updates, clip)
    if clip:
        assert min(m[4] for m in ours) > clip
    # TrainMetrics fields: loss, vqa, vaq, qav, grad_norm, lr
    np.testing.assert_allclose(np.array(ours), np.array(ref), **LOSS_TOL)
    assert ours[0][5] == 0.0 and ours[-1][5] > 0.0
    if not vaq:
        assert ours[0][2] == 0.0 and ours[0][3] == 0.0
    sd = model.state_dict()
    for path, leaf in flatten_flax(ref_trainable).items():
        if leaf is None:
            continue
        name = flax_path_to_torch_name(path)
        want = np.asarray(leaf)
        got = sd[name].numpy()
        np.testing.assert_allclose(got.T if got.shape != want.shape else got,
                                   want, err_msg=name, **PARAM_TOL)
    for n, p in model.named_parameters():
        if n in frozen0:
            assert torch.equal(p, frozen0[n]), n


def test_remat_gives_equal_losses_and_grads(setup):
    _, params, batch = setup
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    out = []
    for remat in (False, True):
        model = torch_model(params, remat=remat)
        named = trainable_parameters(model)
        losses = compute_objective_losses(model, tb, vaq=True, qav=True)
        losses.total.backward()
        out.append(([x.detach() for x in losses], [p.grad for _, p in named]))
    (l0, g0), (l1, g1) = out
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_trainables_and_decay_mask_match_jax(setup):
    _, params, _ = setup
    model = torch_model(params)
    named = dict(trainable_parameters(model))
    trainable, _ = partition_params(params)
    flat_t = {flax_path_to_torch_name(p)
              for p, leaf in flatten_flax(trainable).items()
              if leaf is not None}
    assert set(named) == flat_t
    for n, p in model.named_parameters():
        assert p.requires_grad == (n in flat_t), n
    masks = flatten_flax(jwd_mask(params))
    sd = dict(model.named_parameters())
    for path, m in masks.items():
        name = flax_path_to_torch_name(path)
        assert wd_mask(name, sd[name]) == bool(m), name


def test_lr_schedule_matches_jax():
    cfg = TrainConfig(blr=9e-2, epochs=5, warmup_epochs=2.0, accum_iter=2,
                      min_lr=1e-5)
    jcfg = JTrainConfig(blr=9e-2, epochs=5, warmup_epochs=2.0, accum_iter=2,
                        min_lr=1e-5)
    ours, ref = lr_schedule(cfg, 6, 16), jlr_schedule(jcfg, 6, 16)
    for count in range(0, 16):
        np.testing.assert_allclose(ours(count), float(ref(count)),
                                   rtol=1e-6, atol=1e-12)
    assert ours(0) == 0.0


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train_data")
    make_nextqa(str(root), 8, np.random.RandomState(0))
    return str(root)


def test_train_cli_cpu_end_to_end(synth_root):
    proc = subprocess.run(
        [sys.executable, "-m", "flipped_tpu_torch.cli.train", "--model",
         "tiny", "--device", "cpu", "--vaq", "--qav", "--epochs", "1",
         "--debug", "--output_dir", "", "--dataset", "nextqa",
         "--data_root", synth_root, "--batch_size", "2"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(next(line for line in proc.stdout.splitlines()
                            if line.startswith("{")))
    assert stats["train_steps"] == 1 and stats["val_batches"] == 1
    assert all(np.isfinite(stats[f"train_{k}"]) and stats[f"train_{k}"] > 0
               for k in ("vqa_loss", "vaq_loss", "qav_loss", "grad_norm"))
    assert stats["train_lr"] == 0.0       # the first update has lr 0


def _args(synth_root, *extra):
    return get_args_parser().parse_args(
        ["--model", "tiny", "--dataset", "nextqa", "--data_root", synth_root,
         "--batch_size", "2", "--device", "cpu", "--debug", "--epochs", "1",
         "--output_dir", "", *extra])


def test_train_cli_runs_in_process(synth_root):
    model, history = ttrain.main(_args(synth_root, "--no_remat"))
    assert not model.remat and len(history) == 1
    assert history[0]["train_steps"] == 1


@pytest.mark.parametrize("extra", [
    ["--output_dir", "out"], ["--remat_policy", "qkv"],
    ["--remat_group", "2"], ["--lm_head_chunk", "16"],
    ["--resume", "checkpoint_best"], ["--audio", "--audio_merge", "sum"],
    ["--loader", "grain"], ["--is_generation_task"]])
def test_train_cli_refuses_unported(synth_root, extra):
    with pytest.raises(NotImplementedError):
        ttrain.main(_args(synth_root, *extra))


def test_profile_tool_classes_and_refuses_cpu(synth_root):
    from flipped_tpu_torch.cli import profile

    assert profile.kernel_class("nvjet_tst_256x128_64x4_1x2_h_bz_TNT") \
        == "gemm"
    assert profile.kernel_class(
        "void (anonymous namespace)::flash_bwd_dkdv_kernel<128>(...)") \
        == "flash (K1/K2)"
    assert profile.kernel_class(
        "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize32x32x8_stage3") \
        == "gemm f32"
    assert profile.kernel_class("vectorized_elementwise_kernel<4>") == "other"
    with pytest.raises(ValueError, match="cuda"):
        profile.main(["--mode", "train", "--model", "tiny", "--data_root",
                      synth_root, "--device", "cpu", "--output_dir", ""])
