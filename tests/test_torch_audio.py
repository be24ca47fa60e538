"""flipped_tpu_torch's audio merges against the JAX package, on the CPU.

Each merge's f32 tree is initialised by the JAX model from a seed (gate1
non-zero, so the adapter rows get gradients) and carried into the port by
`params_from_flax`; both packages take the same numpy batches. Held:
`fuse` for every merge (1e-5), the stacked objectives' losses and every
trainable's gradient (tests/test_torch_train.py's parity tolerance), the
trainables per merge, the converter's names and transposes, the rotation
fold of `sum` and `concat` (tests/test_torch_ckpt.py's tolerances), the
checkpoint manager, generation with the attention merge on MUSIC-AVQA
(tokens equal), and one run of both train CLIs on the fork's headline
recipe (MUSIC-AVQA, --audio_merge attention, generation eval): the
extracted answers equal.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flipped_tpu.ckpt.rotate import rotate_params as jrotate_params
from flipped_tpu.core.config import DataConfig as JDataConfig
from flipped_tpu.core.config import ModelConfig as JModelConfig
from flipped_tpu.data import make_synthetic_items, pack_train_batch
from flipped_tpu.data.datasets import build_dataset as jbuild_dataset
from flipped_tpu.model import FlippedVQAModel as JModel
from flipped_tpu.text import MockTokenizer as JMockTokenizer
from flipped_tpu.train import merge_params, partition_params
from flipped_tpu.train.generation import \
    make_generation_step as jmake_generation_step
from flipped_tpu.train.objectives import \
    compute_objective_losses as jcompute_objective_losses
from flipped_tpu_torch.ckpt import CheckpointManager, params_from_flax
from flipped_tpu_torch.ckpt.convert import flatten_flax, \
    flax_path_to_torch_name
from flipped_tpu_torch.ckpt.rotate import rotate_params
from flipped_tpu_torch.cli import train as ttrain
from flipped_tpu_torch.core.config import (DataConfig, ModelConfig,
                                           TrainConfig, get_args_parser)
from flipped_tpu_torch.data import synthetic
from flipped_tpu_torch.data.batching import pack_eval_batch
from flipped_tpu_torch.data.datasets import build_dataset
from flipped_tpu_torch.model import FlippedVQAModel
from flipped_tpu_torch.text import MockTokenizer
from flipped_tpu_torch.train import (compute_objective_losses,
                                     make_generation_step, make_optimizer,
                                     option_scores, trainable_parameters)

# tests/test_torch_train.py's model, with tests/test_audio.py's audio_dim
KW = dict(dim=32, n_layers=2, n_heads=4, vocab_size=512, multiple_of=16,
          max_seq_len=96, adapter_len=4, adapter_layer=2, max_feats=4,
          visual_dim=16, audio_dim=24)
MERGES = ("audio_only", "sum", "concat", "attention")
F32 = dict(dtype=jnp.float32, frozen_dtype=jnp.float32,
           trainable_dtype=jnp.float32, use_flash=False)
TF32 = dict(dtype=torch.float32, frozen_dtype=torch.float32,
            trainable_dtype=torch.float32)
FUSE_TOL = dict(rtol=1e-5, atol=1e-6)
# tests/test_torch_train.py's LOSS_TOL, held by the losses and every grad
PARITY_TOL = dict(rtol=1e-4, atol=1e-6)
HOST_KEYS = ("answer", "qtype", "gt_answer", "qid", "valid", "span_need",
             "span_exact")


def media(merge, b, rs, n_audio=None):
    """(video, audio) numpy inputs of `fuse` for `merge`: no video under
    audio_only, one audio clip embedding under attention (as the dataset
    gives it), the F frames otherwise."""
    f = KW["max_feats"]
    video = (None if merge == "audio_only" else
             rs.randn(b, f, KW["visual_dim"]).astype(np.float32))
    n_audio = n_audio or (1 if merge == "attention" else f)
    audio = (None if merge is None else
             rs.randn(b, n_audio, KW["audio_dim"]).astype(np.float32))
    return video, audio


def jax_tree(merge, seed=1):
    """JAX's f32 tree of `merge`, gate1 0.3 in every block."""
    cfg = JModelConfig(audio_merge=merge, **KW)
    jmodel = JModel(cfg, **F32)
    video, audio = media(merge, 1, np.random.RandomState(0))
    f = cfg.max_feats
    # eager: a jit compile per merge costs more than the tiny init
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16), jnp.int32),
        None if video is None else jnp.asarray(video),
        None if audio is None else jnp.asarray(audio),
        jnp.zeros((1,), jnp.int32),
        jnp.tile(jnp.arange(f)[None], (1, 1)))["params"])
    for name, sub in params.items():
        if name.startswith("layers_"):
            sub["attention"]["gate1"] = np.full(4, 0.3, np.float32)
    return jmodel, params


def port_model(merge, params, **kw):
    model = FlippedVQAModel(ModelConfig(audio_merge=merge, **KW), **TF32,
                            **kw)
    model.load_state_dict(params_from_flax(params), strict=True)
    return model


@pytest.fixture(scope="module")
def trees():
    return {m: jax_tree(m) for m in (None,) + MERGES}


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("merge,n_audio", [
    (None, None), ("audio_only", None), ("sum", None), ("concat", None),
    ("attention", None), ("attention", 10)])
def test_fuse_matches_jax(trees, merge, n_audio):
    """`fuse` at f32 against JAX's `model.apply(..., method="fuse")`; the
    attention merge also over 10 audio keys, where the softmax is not
    trivially 1."""
    jmodel, params = trees[merge]
    video, audio = media(merge, 3, np.random.RandomState(4), n_audio)
    ref = np.asarray(jmodel.apply({"params": params}, _j(video), _j(audio),
                                  method="fuse"))
    with torch.no_grad():
        got = port_model(merge, params).fuse(_t(video), _t(audio)).numpy()
    assert got.shape == ref.shape == (3, KW["max_feats"], KW["dim"])
    np.testing.assert_allclose(got, ref, **FUSE_TOL)


def train_batch(merge):
    """A packed train batch of 4 synthetic items with F audio frames (the
    attention merge too: over its dataset's one clip embedding the softmax
    is 1 and the query and key get no gradient); no video key under
    audio_only, as the dataset packs it."""
    items = make_synthetic_items(JMockTokenizer(KW["vocab_size"]), 4,
                                 max_feats=KW["max_feats"],
                                 max_seq_len=KW["max_seq_len"],
                                 visual_dim=KW["visual_dim"], audio=True,
                                 audio_dim=KW["audio_dim"], seed=5)
    batch = pack_train_batch(items, KW["max_feats"])
    if merge == "audio_only":
        del batch["video"]
    return batch


@pytest.mark.parametrize("merge", MERGES)
def test_objective_losses_and_grads_match_jax(trees, merge):
    """The three stacked losses and every trainable's gradient (the audio
    modules' included) against JAX's `compute_objective_losses` and
    `jax.grad` on the same tree and batch."""
    jmodel, params = trees[merge]
    batch = train_batch(merge)
    trainable, frozen = partition_params(params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def total(t):
        losses = jcompute_objective_losses(
            jmodel, {"params": merge_params(t, frozen)}, jb, True, True)
        return losses.vqa + losses.vaq + losses.qav, losses

    (_, ref), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        trainable)
    model = port_model(merge, params)
    named = dict(trainable_parameters(model))
    losses = compute_objective_losses(
        model, {k: torch.from_numpy(v) for k, v in batch.items()},
        vaq=True, qav=True)
    losses.total.backward()
    np.testing.assert_allclose([float(x.detach()) for x in losses],
                               [float(x) for x in ref], **PARITY_TOL)
    # Flax kernels are (in, out): square ones too
    flat = {flax_path_to_torch_name(p): np.asarray(g).T
            if p.endswith("/kernel") else np.asarray(g)
            for p, g in flatten_flax(grads).items() if g is not None}
    assert set(flat) == set(named)
    fusion = [n for n in named if "audio" in n or "visual_proj" in n]
    assert fusion and all(named[n].grad.abs().sum() > 0 for n in fusion)
    for name, want in flat.items():
        np.testing.assert_allclose(named[name].grad.numpy(), want,
                                   err_msg=name, **PARITY_TOL)


@pytest.mark.parametrize("merge,expected", [
    ("audio_only", {"audio_proj.weight"}),
    ("sum", {"audio_proj.weight", "visual_proj.weight"}),
    ("concat", {"visual_proj.weight"}),
    ("attention", {"audio_proj.weight", "visual_proj.weight"}
     | {f"video_audio_cross_attn.{m}.{leaf}" for m in ("query", "key",
                                                       "value")
        for leaf in ("weight", "bias")})])
def test_trainables_per_merge_match_jax(trees, merge, expected):
    """The port's trainables are JAX's `partition_params` trainables, the
    audio modules among them (tests/test_audio.py's
    test_audio_params_are_trainable), and AdamW decays the same ones."""
    _, params = trees[merge]
    model = port_model(merge, params)
    named = dict(trainable_parameters(model))
    trainable, _ = partition_params(params)
    assert set(named) == {flax_path_to_torch_name(p) for p, leaf in
                          flatten_flax(trainable).items() if leaf is not None}
    audio = {n for n in named if "audio" in n or n.startswith("visual_proj")}
    assert audio == expected
    opt = make_optimizer(model, TrainConfig(weight_decay=0.1), 4, 4)
    decayed = {id(p) for p in opt.adamw.param_groups[0]["params"]}
    for n, p in named.items():
        assert (id(p) in decayed) == (n.endswith("weight") or "gate" in n), n


@pytest.mark.parametrize("merge", ["concat", "attention"])
def test_convert_carries_the_audio_tree(trees, merge):
    """`params_from_flax` on an audio tree: every leaf named as the port's
    parameter (a strict load), kernels transposed, biases as they are."""
    _, params = trees[merge]
    sd = params_from_flax(params)
    model = FlippedVQAModel(ModelConfig(audio_merge=merge, **KW), **TF32)
    assert set(sd) == set(model.state_dict())
    flat = flatten_flax(params)
    for path, leaf in flat.items():
        want = np.asarray(leaf, np.float32)
        got = sd[flax_path_to_torch_name(path)].numpy()
        np.testing.assert_array_equal(
            got, want.T if path.endswith("/kernel") else want, err_msg=path)
    if merge == "concat":
        assert sd["visual_proj.weight"].shape == (
            KW["dim"], KW["visual_dim"] + KW["audio_dim"])
    else:
        assert sd["audio_proj.weight"].shape == (KW["visual_dim"],
                                                 KW["audio_dim"])
        assert sd["video_audio_cross_attn.key.bias"].shape == (
            KW["visual_dim"],)


def eval_batch(merge, seed=9):
    items = make_synthetic_items(JMockTokenizer(KW["vocab_size"]), 3,
                                 max_feats=KW["max_feats"],
                                 max_seq_len=KW["max_seq_len"], split="val",
                                 visual_dim=KW["visual_dim"], audio=True,
                                 audio_dim=KW["audio_dim"], seed=seed)
    return {k: torch.tensor(v) for k, v in
            pack_eval_batch(items, KW["max_feats"]).items()
            if k not in HOST_KEYS}


@pytest.mark.parametrize("merge", ["sum", "concat"])
def test_rotated_audio_model_scores_as_the_original(merge):
    """`rotate_params` on an audio tree with real norm weights: sum folds
    audio_proj and visual_proj, concat visual_proj (its 1792 inputs, here
    40, unrotated); every leaf within tests/test_torch_ckpt.py's 1e-5 of
    JAX's `rotate_params`, and the rotated model scores the options as the
    original does (its 1e-4)."""
    _, params = jax_tree(merge, seed=3)
    rs = np.random.RandomState(1)
    for name, sub in params.items():
        if name.startswith("layers_"):
            for norm in ("attention_norm", "ffn_norm"):
                sub[norm]["weight"] = (rs.rand(KW["dim"]) + 0.5).astype(
                    np.float32)
    params["norm"]["weight"] = (rs.rand(KW["dim"]) + 0.5).astype(np.float32)
    state = params_from_flax(params)
    got = rotate_params(state, 2, 2)
    want = params_from_flax(jrotate_params(params, 2, 2))
    assert set(got) == set(want)
    for name, t in want.items():
        np.testing.assert_allclose(got[name].numpy(), t.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(t.abs().max()),
                                   err_msg=name)
    for name in ("visual_proj.weight", "audio_proj.weight"):
        if name in state:
            assert not torch.allclose(got[name], state[name]), name
    batch = eval_batch(merge)
    scores = []
    for sd, rotated in ((state, False), (got, True)):
        model = FlippedVQAModel(ModelConfig(audio_merge=merge, **KW),
                                rotated=rotated, **TF32)
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            scores.append(option_scores(model, batch).numpy())
    np.testing.assert_allclose(scores[1], scores[0], rtol=1e-4, atol=1e-4)


def test_checkpoint_manager_saves_and_restores_audio_trainables(trees,
                                                                tmp_path):
    """The attention merge's trainables go through `CheckpointManager`
    save and restore bit for bit, strictly: a video-only model refuses
    the checkpoint."""
    _, params = trees["attention"]
    model = port_model("attention", params)
    opt = make_optimizer(model, TrainConfig(), 4, 4)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save("checkpoint_last", model, opt, epoch=0, best_acc=0.5)
    fresh = port_model("attention", jax_tree("attention", seed=7)[1])
    trainable_parameters(fresh)
    assert mgr.restore("checkpoint_last", fresh)["best_acc"] == 0.5
    saved = dict(model.named_parameters())
    for n, p in fresh.named_parameters():
        if p.requires_grad:
            assert torch.equal(p, saved[n]), n
    video_only = port_model(None, params_from_flax_video_only(params))
    trainable_parameters(video_only)
    with pytest.raises(KeyError, match="video_audio_cross_attn"):
        mgr.restore("checkpoint_last", video_only)


def params_from_flax_video_only(params):
    """The attention tree without its audio modules and with a
    visual_dim-wide visual_proj: a video-only tree."""
    return {k: v for k, v in params.items()
            if k not in ("audio_proj", "video_audio_cross_attn")}


@pytest.fixture(scope="module")
def musicavqa_root(tmp_path_factory):
    """The port's fixtures at --n 8: 2 MUSIC-AVQA val rows."""
    root = tmp_path_factory.mktemp("torch_audio_data")
    synthetic.main(["--root", str(root), "--n", "8"])
    return str(root)


def test_generation_attention_on_musicavqa_matches_jax(musicavqa_root):
    """The attention merge's generation step on a MUSIC-AVQA val batch
    (its clip audio embedding, (1, 1024)) against JAX's
    `make_generation_step` at f32: the 31 tokens and the predictions
    equal, the similarities within 1e-5."""
    kw = dict(KW, max_seq_len=128, audio_dim=1024, visual_dim=768)
    cfg = JModelConfig(audio_merge="attention", **kw)
    dcfg = dict(dataset="musicavqa", data_root=musicavqa_root,
                max_seq_len=128, max_feats=kw["max_feats"], audio=True,
                audio_merge="attention", is_generation_task=True)
    items = [build_dataset(DataConfig(**dcfg), MockTokenizer(512),
                           "val").get_item(i) for i in range(2)]
    batch = pack_eval_batch(items, kw["max_feats"])
    assert batch["audio"].shape == (2, 1, 1024)
    ref_items = jbuild_dataset(JDataConfig(**dcfg), JMockTokenizer(512),
                               "val")
    assert np.array_equal(ref_items.get_item(1).audio, items[1].audio)
    jmodel = JModel(cfg, **F32)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(2), jnp.asarray(batch["vqa_tokens"][:, 0]),
        jnp.asarray(batch["video"]), jnp.asarray(batch["audio"]),
        jnp.asarray(batch["vqa_video_start"]),
        jnp.asarray(batch["vqa_splice"]))["params"])
    for name, sub in params.items():
        if name.startswith("layers_"):
            sub["attention"]["gate1"] = np.full(4, 0.4, np.float32)
    eos = JMockTokenizer(512).eos_id
    trainable, frozen = partition_params(params)
    ref = jax.device_get(jmake_generation_step(jmodel, eos)(
        trainable, frozen, {k: jnp.asarray(v) for k, v in batch.items()
                            if k not in HOST_KEYS}))
    model = FlippedVQAModel(ModelConfig(audio_merge="attention", **kw),
                            **TF32)
    model.load_state_dict(params_from_flax(params), strict=True)
    out = make_generation_step(model, eos)(
        {k: torch.from_numpy(v) for k, v in batch.items()
         if k not in HOST_KEYS})
    np.testing.assert_array_equal(out["generated"].numpy(),
                                  np.asarray(ref["generated"]))
    np.testing.assert_array_equal(out["prediction"].numpy(),
                                  np.asarray(ref["prediction"]))
    np.testing.assert_allclose(out["similarity"].numpy(),
                               np.asarray(ref["similarity"]),
                               rtol=1e-5, atol=1e-5)


def test_train_cli_audio_attention_generation_matches_jax(musicavqa_root,
                                                          tmp_path,
                                                          monkeypatch):
    """The fork's headline recipe, `cli.train --dataset musicavqa
    --is_generation_task --audio --audio_merge attention --debug`, on the
    CPU: the port's extracted_answers_epoch0.json equals JAX's on the same
    fixture and seed, at f32 (tests/test_torch_train.py's
    test_train_cli_generation_matches_jax, with audio). One update at lr
    0, then one val batch of both rows."""
    from flipped_tpu.cli import train as jtrain
    from flipped_tpu.core.config import get_args_parser as jax_parser

    argv = ["--model", "tiny", "--dataset", "musicavqa", "--data_root",
            musicavqa_root, "--batch_size", "2", "--max_seq_len", "128",
            "--epochs", "1", "--debug", "--is_generation_task", "--audio",
            "--audio_merge", "attention"]
    tree = {}
    jbuild, tbuild = jtrain.build_train_state, ttrain.build_train_state

    def jbuild_f32(run_cfg, *a, **kw):
        model, cfg, tok, trainable, frozen = jbuild(run_cfg, *a, **kw)
        model = model.clone(dtype=jnp.float32, frozen_dtype=jnp.float32,
                            trainable_dtype=jnp.float32)
        trainable, frozen = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32), (trainable, frozen))
        tree["params"] = jax.device_get(merge_params(trainable, frozen))
        return model, cfg, tok, trainable, frozen

    def tbuild_f32(run_cfg, device, seed=0):
        model, cfg, tok = tbuild(run_cfg, device, seed, dtype=torch.float32)
        model.load_state_dict(params_from_flax(tree["params"]), strict=True)
        return model, cfg, tok

    monkeypatch.setattr(jtrain, "build_train_state", jbuild_f32)
    monkeypatch.setattr(ttrain, "build_train_state", tbuild_f32)
    outs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    jtrain.main(jax_parser().parse_args(argv + ["--dp", "1", "--output_dir",
                                                outs["jax"]]))
    model, history = ttrain.main(get_args_parser().parse_args(
        argv + ["--device", "cpu", "--output_dir", outs["port"]]))
    assert model.cfg.audio_merge == "attention"
    assert history[0]["val_batches"] == 1
    answers = {}
    for name, out in outs.items():
        with open(f"{out}/extracted_answers/extracted_answers_epoch0.json") \
                as f:
            answers[name] = json.load(f)
    assert [r["qid"] for r in answers["port"]] == [0, 1]
    assert answers["port"] == answers["jax"]
