"""flipped_tpu_torch classification eval against the JAX package, and one
run of the port's evaluate CLI on the CPU.

Both packages score one batch from `make_synthetic_items` +
`pack_eval_batch` with the same weights (f32): scores within 1e-4 and equal
predictions, for the dense scorer, the prefix-cached scorer and both eval
steps.
"""
import argparse
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flipped_tpu.core.config import ModelConfig as JModelConfig
from flipped_tpu.core.config import get_args_parser as jax_parser
from flipped_tpu.data import make_synthetic_items, pack_eval_batch
from flipped_tpu.model import FlippedVQAModel as JModel
from flipped_tpu.text import MockTokenizer
from flipped_tpu.train import ce_ignore_index as jce_ignore_index
from flipped_tpu.train import make_eval_step as jmake_eval_step
from flipped_tpu.train import option_scores as joption_scores
from flipped_tpu.train import option_scores_cached as joption_scores_cached
from flipped_tpu.train import partition_params
from flipped_tpu.train import token_ce_unreduced as jtoken_ce_unreduced
from flipped_tpu_torch.ckpt import params_from_flax
from flipped_tpu_torch.cli import evaluate as tevaluate
from flipped_tpu_torch.core.config import (QUANTIZE_CHOICES, ModelConfig,
                                           check_quantize, get_args_parser)
from flipped_tpu_torch.model import FlippedVQAModel
from flipped_tpu_torch.train import (ce_ignore_index, make_eval_step,
                                     option_scores, option_scores_cached,
                                     required_eval_span, token_ce_unreduced)

KW = dict(dim=32, n_layers=2, n_heads=4, vocab_size=512, multiple_of=16,
          max_seq_len=96, adapter_len=4, adapter_layer=2, max_feats=4,
          visual_dim=16)
TOL = dict(rtol=1e-4, atol=1e-4)
HOST_KEYS = ("answer", "qtype", "gt_answer", "qid", "valid", "span_need",
             "span_exact")


@pytest.fixture(scope="module")
def setup():
    cfg = JModelConfig(**KW)
    items = make_synthetic_items(MockTokenizer(cfg.vocab_size), 3,
                                 max_feats=cfg.max_feats,
                                 max_seq_len=cfg.max_seq_len, split="val",
                                 visual_dim=cfg.visual_dim, seed=9)
    batch = pack_eval_batch(items, cfg.max_feats)
    jmodel = JModel(cfg, dtype=jnp.float32, frozen_dtype=jnp.float32,
                    trainable_dtype=jnp.float32, use_flash=False)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(3), jnp.array(batch["vqa_tokens"][:, 0]),
        jnp.array(batch["video"]), None, jnp.array(batch["vqa_video_start"]),
        jnp.array(batch["vqa_splice"]))["params"])
    for name, sub in params.items():
        if name.startswith("layers_"):
            sub["attention"]["gate1"] = np.full(4, 0.4, np.float32)
            sub["attention"]["gate2"] = np.array([-2., -1., 0.5, 1.],
                                                 np.float32)
    tmodel = FlippedVQAModel(ModelConfig(**KW), dtype=torch.float32,
                             frozen_dtype=torch.float32,
                             trainable_dtype=torch.float32)
    tmodel.load_state_dict(params_from_flax(params), strict=True)
    jb = {k: jnp.array(v) for k, v in batch.items() if k not in HOST_KEYS}
    tb = {k: torch.tensor(v) for k, v in batch.items() if k not in HOST_KEYS}
    return jmodel, params, tmodel, batch, jb, tb


def test_option_scores(setup):
    jmodel, params, tmodel, _, jb, tb = setup
    ref = np.asarray(jax.jit(lambda p, b: joption_scores(jmodel, p, b))(
        {"params": params}, jb))
    with torch.no_grad():
        ours = option_scores(tmodel, tb).numpy()
    np.testing.assert_allclose(ours, ref, **TOL)
    assert (ours.argmin(-1) == ref.argmin(-1)).all()


def test_option_scores_cached(setup):
    jmodel, params, tmodel, _, jb, tb = setup
    ref = np.asarray(jax.jit(
        lambda p, b: joption_scores_cached(jmodel, p, b, 16))(
        {"params": params}, jb))
    with torch.no_grad():
        ours = option_scores_cached(tmodel, tb, 16).numpy()
    np.testing.assert_allclose(ours, ref, **TOL)
    assert (ours.argmin(-1) == ref.argmin(-1)).all()


@pytest.mark.parametrize("cached", [True, False])
def test_make_eval_step(setup, cached):
    jmodel, params, tmodel, batch, jb, tb = setup
    trainable, frozen = partition_params(params)
    ref = jmake_eval_step(jmodel, cached=cached)(trainable, frozen, jb)
    span_info = (int(batch["span_need"]), bool(batch["span_exact"]))
    out = make_eval_step(tmodel, cached=cached)(tb, span_info=span_info)
    np.testing.assert_allclose(out["scores"].numpy(),
                               np.asarray(ref["scores"]), **TOL)
    np.testing.assert_array_equal(out["prediction"].numpy(),
                                  np.asarray(ref["prediction"]))
    assert required_eval_span(tb) == span_info


@pytest.mark.parametrize("ignore_index", [0, -1])
def test_token_losses_match_jax(ignore_index):
    rs = np.random.RandomState(ignore_index + 2)
    logits = rs.randn(3, 7, 11).astype(np.float32)
    labels = rs.randint(0, 11, (3, 7)).astype(np.int32)
    labels[0, :3] = ignore_index
    labels[1, 2] = 0
    np.testing.assert_allclose(
        ce_ignore_index(torch.tensor(logits), torch.tensor(labels),
                        ignore_index).numpy(),
        np.asarray(jce_ignore_index(jnp.array(logits), jnp.array(labels),
                                    ignore_index)), **TOL)
    labels = np.maximum(labels, 0)
    np.testing.assert_allclose(
        token_ce_unreduced(torch.tensor(logits), torch.tensor(labels)).numpy(),
        np.asarray(jtoken_ce_unreduced(jnp.array(logits), jnp.array(labels))),
        **TOL)


def test_quantize_choices_match_jax_parser():
    jax_choices = next(a.choices for a in jax_parser()._actions
                       if a.dest == "quantize")
    assert tuple(jax_choices) == QUANTIZE_CHOICES
    for mode in QUANTIZE_CHOICES:          # every mode runs on one card
        check_quantize(mode)
    with pytest.raises(ValueError, match="unknown"):
        check_quantize("int2")


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_eval_data")
    subprocess.run([sys.executable, "scripts/make_synthetic_data.py", "--root",
                    str(root), "--n", "8"], check=True, capture_output=True)
    return str(root)


def _args(synth_root, *extra) -> argparse.Namespace:
    return get_args_parser().parse_args(
        ["--model", "tiny", "--dataset", "nextqa", "--data_root", synth_root,
         "--batch_size", "2", "--max_seq_len", "128", "--device", "cpu",
         "--debug", *extra])


def test_evaluate_cli_cpu(synth_root):
    stats = tevaluate.main(_args(synth_root))
    assert stats["batches"] == 1
    assert 0.0 <= stats["acc"] <= 1.0 and "Total" in stats


@pytest.mark.parametrize("extra", [["--resume", "checkpoint_best"],
                                   ["--is_generation_task"],
                                   ["--audio", "--audio_merge", "sum"]])
def test_evaluate_cli_refuses_unported(synth_root, extra):
    with pytest.raises(NotImplementedError):
        tevaluate.main(_args(synth_root, *extra))
