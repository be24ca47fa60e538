"""flipped_tpu_torch checkpoints against the JAX package: Meta shards loaded
(merged, bf16, rotated and quantized on load), adapter save and resume,
log.txt, and `evaluate --resume`.

One Meta checkpoint, written from a JAX init of the `tiny` preset by JAX's
`export_reference_style` as two tensor-parallel shards, is loaded by JAX's
`build_train_state` (through its safetensors conversion, in a copy of the
directory) and by the port's `build_eval_state`: every frozen leaf is
equal bit for bit in the non-rotated modes. In the rotated modes the
port's fold runs its Walsh-Hadamard transform as a butterfly where JAX
runs two numpy matmuls: the sums are the same but their order is not, so a
folded f32 value may differ in its last bits and its bf16 rounding by one
ulp; the bound is at most 0.1% of a leaf's elements, each within one bf16
ulp, `qav_rot` within 1e-5 relative, and quantized codes equal wherever
their source bf16 row (or row group) is equal.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from flipped_tpu.ckpt import convert as jconvert
from flipped_tpu.ckpt import quantize as jquantize
from flipped_tpu.ckpt.rotate import rotate_params as jrotate_params
from flipped_tpu.core.config import ModelConfig as JModelConfig
from flipped_tpu.core.config import get_args_parser as jax_parser
from flipped_tpu.core.config import quant_flags as jquant_flags
from flipped_tpu.core.config import run_config_from_args as jax_run_config
from flipped_tpu.data import make_synthetic_items, pack_eval_batch
from flipped_tpu.model import FlippedVQAModel as JModel
from flipped_tpu.text import MockTokenizer
from flipped_tpu.train import make_eval_step as jmake_eval_step
from flipped_tpu.train.builder import build_model as jbuild_model
from flipped_tpu.train.builder import build_train_state as jbuild_train_state
from flipped_tpu.train.builder import init_params as jinit_params
from flipped_tpu_torch.ckpt import (CheckpointManager, export_meta_checkpoint,
                                    load_meta_checkpoint, merge_shards,
                                    params_from_flax, quantize_kernel,
                                    rotate_params)
from flipped_tpu_torch.ckpt.rotate import Rotation, fwht_
from flipped_tpu_torch.cli import evaluate as tevaluate
from flipped_tpu_torch.cli import train as ttrain
from flipped_tpu_torch.core.config import (ModelConfig, get_args_parser,
                                           run_config_from_args)
from flipped_tpu_torch.data.synthetic import make_nextqa
from flipped_tpu_torch.model import FlippedVQAModel
from flipped_tpu_torch.model.llama import Linear
from flipped_tpu_torch.train import make_eval_step, option_scores
from flipped_tpu_torch.train.builder import (build_eval_state,
                                             resolve_model_config)

META_PARAMS = dict(dim=64, n_layers=2, n_heads=4, multiple_of=32,
                   norm_eps=1e-6, vocab_size=512)     # the tiny preset
PLAIN_MODES = ("none", "int8", "int8g", "int8o", "w8a8", "int4", "w4a8")
ROTATED_MODES = ("int8r", "w8a8r", "w4a8r")
TOL = dict(rtol=1e-4, atol=1e-4)          # tests/test_torch_eval.py's
BF16_DIFF_SHARE = 1e-3
QAV_ROT_RTOL = 1e-5


@pytest.fixture(scope="module")
def meta_ckpt(tmp_path_factory):
    """(port's llama_model_path, JAX's copy of it): a 2-shard Meta
    checkpoint of a JAX init of the tiny preset, f32 as JAX writes it."""
    root = tmp_path_factory.mktemp("meta_ckpt")
    run_cfg = jax_run_config(jax_parser().parse_args(["--model", "tiny"]))
    model, cfg = jbuild_model(run_cfg)
    params = jax.device_get(jinit_params(model, cfg, 7))
    jconvert.export_reference_style(params, 2, str(root / "port" / "tiny"),
                                    META_PARAMS)
    shutil.copytree(root / "port", root / "jax")
    return str(root / "port"), str(root / "jax")


def jax_build(jax_dir, mode):
    """JAX's frozen and trainable trees of the checkpoint at `mode`."""
    run_cfg = jax_run_config(jax_parser().parse_args(
        ["--model", "tiny", "--llama_model_path", jax_dir, "--quantize",
         mode]))
    _, cfg, _, trainable, frozen = jbuild_train_state(run_cfg)
    return cfg, trainable, frozen


def cli(*argv):
    """The port's parsed flags, on the CPU, the tiny preset."""
    return get_args_parser().parse_args(["--model", "tiny", "--device",
                                         "cpu", *argv])


def port_args(path, mode="none"):
    return cli("--llama_model_path", path, "--quantize", mode)


def drop_none(tree):
    """A JAX partition without its None placeholders."""
    return {k: drop_none(v) if isinstance(v, dict) else v
            for k, v in tree.items() if v is not None}


def port_build(path, mode, dtype=torch.bfloat16):
    model, _, _ = build_eval_state(
        run_config_from_args(port_args(path, mode)), "cpu", dtype=dtype)
    return model


def frozen_leaves(model):
    return {n: p.detach() for n, p in model.named_parameters()
            if not p.requires_grad}


@pytest.mark.parametrize("mode", PLAIN_MODES)
def test_loaded_leaves_equal_jax(meta_ckpt, mode):
    port_dir, jax_dir = meta_ckpt
    _, _, frozen = jax_build(jax_dir, mode)
    want = params_from_flax(drop_none(frozen))
    got = frozen_leaves(port_build(port_dir, mode))
    assert set(got) == set(want)
    for name, t in got.items():
        assert torch.equal(t.to(want[name].dtype), want[name]), name


def rotated_sources(port_dir, jax_dir):
    """The rotated bf16 (N, K) weights each package quantizes from."""
    jflat = jconvert.load_frozen_params(
        os.path.join(jax_dir, "tiny", "model.flax.safetensors"))
    jrot = params_from_flax(jrotate_params(jflat, 2, 2))
    prot = rotate_params(dict(load_meta_checkpoint(
        os.path.join(port_dir, "tiny"))), 2, 2)
    return jrot, prot


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units of bf16 spacing at the larger magnitude."""
    mag = torch.maximum(a.abs(), b.abs()).float().clamp_min(2.0 ** -126)
    ulp = 2.0 ** (torch.floor(torch.log2(mag)) - 7)
    return (a.float() - b.float()).abs() / ulp


def check_bf16_leaf(name, got, want):
    diff = got.float() != want.float()
    assert float(diff.float().mean()) <= BF16_DIFF_SHARE, name
    assert float(bf16_ulps(got, want).max()) <= 1.0, name


@pytest.mark.parametrize("mode", ROTATED_MODES)
def test_rotated_leaves_within_bound(meta_ckpt, mode):
    port_dir, jax_dir = meta_ckpt
    _, _, frozen = jax_build(jax_dir, mode)
    want = params_from_flax(drop_none(frozen))
    model = port_build(port_dir, mode)
    got = frozen_leaves(model)
    jsrc, psrc = rotated_sources(port_dir, jax_dir)
    np.testing.assert_allclose(got["qav_rot"].numpy(),
                               want["qav_rot"].numpy(), rtol=QAV_ROT_RTOL,
                               atol=QAV_ROT_RTOL * float(
                                   want["qav_rot"].abs().max()))
    quant = {n: m for n, m in model.named_modules()
             if isinstance(m, Linear) and m.quantized}
    for name, t in got.items():
        if name == "qav_rot":
            continue
        base, leaf = name.rsplit(".", 1)
        if base not in quant:
            check_bf16_leaf(name, t, want[name].to(t.dtype))
            continue
        src_j = jsrc[f"{base}.weight"].to(torch.bfloat16)
        src_p = psrc[f"{base}.weight"]
        check_bf16_leaf(f"{base}.weight", src_p, src_j)
        if leaf == "kernel_q4":     # packed rows j and j + N/2 together
            n = src_p.shape[0]
            same = (src_p == src_j).view(2, n // 2, -1).all(0)
        else:
            same = src_p == src_j
        scale = got[f"{base}.scale"]
        if leaf in ("kernel_q", "kernel_q4"):
            g = t.shape[1] // scale.shape[0] if scale.dim() == 2 else \
                t.shape[1]
            rows = same.view(same.shape[0], -1, g).all(-1)   # (N', G)
            ok = rows.repeat_interleave(g, dim=1)
            assert torch.equal(t[ok], want[name][ok]), name
        elif leaf == "scale":
            g = src_p.shape[1] // (t.shape[0] if t.dim() == 2 else 1)
            rows = (src_p == src_j).view(src_p.shape[0], -1, g).all(-1)
            ok = rows.t() if t.dim() == 2 else rows[:, 0]
            assert torch.equal(t[ok], want[name][ok]), name


@pytest.mark.parametrize("mode", ["none", "w8a8"])
def test_scores_on_the_loaded_model_match_jax(meta_ckpt, mode):
    """JAX's trainables (gate1 opened so the adapter counts) in both
    models, f32 compute over the loaded bf16 backbone: the cached eval
    scores agree within tests/test_torch_eval.py's tolerance and pick the
    same options."""
    port_dir, jax_dir = meta_ckpt
    cfg, trainable, frozen = jax_build(jax_dir, mode)
    for name, sub in trainable.items():
        if name.startswith("layers_"):
            sub["attention"]["gate1"] = np.full(4, 0.4, np.float32)
    f32 = lambda x: (x.astype(jnp.float32) if x is not None and
                     jnp.issubdtype(x.dtype, jnp.floating) else x)
    frozen = jax.tree_util.tree_map(f32, frozen,
                                    is_leaf=lambda x: x is None)
    jmodel = JModel(cfg, dtype=jnp.float32, frozen_dtype=jnp.float32,
                    trainable_dtype=jnp.float32, use_flash=False,
                    **jquant_flags(mode))
    model = port_build(port_dir, mode, dtype=torch.float32)
    sd = params_from_flax(drop_none(trainable))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.requires_grad:
                p.copy_(sd[name])
    items = make_synthetic_items(MockTokenizer(cfg.vocab_size), 3,
                                 max_feats=cfg.max_feats,
                                 max_seq_len=cfg.max_seq_len, split="val",
                                 visual_dim=cfg.visual_dim, seed=4)
    batch = pack_eval_batch(items, cfg.max_feats)
    host = ("answer", "qtype", "gt_answer", "qid", "valid", "span_need",
            "span_exact")
    ref = jmake_eval_step(jmodel, cached=True)(
        trainable, frozen,
        {k: jnp.array(v) for k, v in batch.items() if k not in host})
    out = make_eval_step(model, cached=True)(
        {k: torch.tensor(v) for k, v in batch.items() if k not in host},
        span_info=(int(batch["span_need"]), bool(batch["span_exact"])))
    np.testing.assert_allclose(out["scores"].numpy(),
                               np.asarray(ref["scores"]), **TOL)
    np.testing.assert_array_equal(out["prediction"].numpy(),
                                  np.asarray(ref["prediction"]))


def jax_leaves_port_layout(ref: dict) -> dict:
    """JAX quantize_kernel's leaves of a (K, N) kernel in the port's
    layout: the codes transposed, out_w f32."""
    out = {}
    for leaf, v in ref.items():
        a = np.asarray(v if leaf != "out_w" else np.asarray(v, np.float32))
        out[leaf] = a.T if leaf in ("kernel_q", "kernel_q4") else a
    return out


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 16), bits=st.sampled_from([8, 4]),
       group=st.sampled_from([0, 32, 128, 48]),
       outliers=st.sampled_from([0, 8]), ties=st.booleans(),
       n_half=st.integers(1, 12), k_groups=st.integers(1, 5))
def test_quantize_kernel_equals_jax(seed, bits, group, outliers, ties,
                                    n_half, k_groups):
    """Codes and scales bit for bit JAX's at every bits/group/outliers
    combination, on bf16 weights (what a loaded checkpoint holds), with
    ties among the row absmaxes when `ties` (values from a small set), a
    group that does not divide K (48 for most K) and outlier rows."""
    if bits == 4 and outliers:
        outliers = 0
    rs = np.random.RandomState(seed)
    n, k = 2 * n_half, 32 * k_groups
    w = (rs.randint(-4, 5, (n, k)) / 4.0 if ties
         else rs.randn(n, k) / 8).astype(np.float32)
    w = torch.from_numpy(w).to(torch.bfloat16)
    kernel = w.float().numpy().T.copy()              # JAX's (K, N)
    ref = jax_leaves_port_layout(
        jquantize.quantize_kernel(kernel, group, outliers, bits))
    got = quantize_kernel(w, group, outliers, bits)
    assert set(got) == set(ref)
    for leaf, want in ref.items():
        have = got[leaf].float() if leaf == "out_w" else got[leaf]
        np.testing.assert_array_equal(have.numpy(), want, err_msg=leaf)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_merge_shards_equals_jax(tmp_path, n_shards):
    """Shards written by JAX's exporter merge to the same tensors in both
    packages; the port's loader yields those, cast to bf16; its exporter
    writes shards that merge back to the state, in the dtype given."""
    run_cfg = jax_run_config(jax_parser().parse_args(["--model", "tiny"]))
    model, cfg = jbuild_model(run_cfg)
    params = jax.device_get(jinit_params(model, cfg, 3))
    src = tmp_path / "jax"
    jconvert.export_reference_style(params, n_shards, str(src), META_PARAMS)
    paths = sorted(src.glob("consolidated.*.pth"))
    load = lambda: [torch.load(p, weights_only=True) for p in paths]
    want = jconvert.merge_shards(load(), 2)
    got = merge_shards(load(), 2)
    assert set(got) == set(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name
    loaded = dict(load_meta_checkpoint(src))
    assert set(loaded) == set(want)
    for name, t in want.items():
        assert torch.equal(loaded[name], t.to(torch.bfloat16)), name
    half = {n: t.to(torch.float16) for n, t in want.items()}
    export_meta_checkpoint(half, n_shards, tmp_path / "port", META_PARAMS)
    again = merge_shards([torch.load(p, weights_only=True) for p in sorted(
        (tmp_path / "port").glob("consolidated.*.pth"))], 2)
    for name, t in half.items():
        assert again[name].dtype == torch.float16
        assert torch.equal(again[name], t), name


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ckpt_data")
    make_nextqa(str(root), 16, np.random.RandomState(0))   # 16 train, 4 val
    return str(root)


def train_args(synth_root, out, *extra):
    return cli("--dataset", "nextqa", "--data_root", synth_root,
               "--batch_size", "8", "--warmup_epochs", "1", "--blr", "0.5",
               "--vaq", "--qav", "--output_dir", out, *extra)


def saved_state(out, name="checkpoint_last"):
    return torch.load(os.path.join(out, name, "state.pt"), weights_only=True)


def log_lines(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def straight_run(synth_root, tmp_path_factory):
    """The output dir of a 2-epoch train run (2 updates an epoch)."""
    out = str(tmp_path_factory.mktemp("straight") / "out")
    ttrain.main(train_args(synth_root, out, "--epochs", "2"))
    return out


def test_resume_equals_a_straight_run(synth_root, straight_run, tmp_path):
    """2 epochs straight == 1 epoch, then --resume checkpoint_last to 2:
    trainables, AdamW moments and the update count bit for bit, and two
    log.txt lines each."""
    split = str(tmp_path / "split")
    ttrain.main(train_args(synth_root, split, "--epochs", "1"))
    ttrain.main(train_args(synth_root, split, "--epochs", "2", "--resume",
                           "checkpoint_last"))
    a, b = saved_state(straight_run), saved_state(split)
    assert a["meta"] == b["meta"] and a["meta"]["epoch"] == 1
    assert a["optimizer"]["count"] == b["optimizer"]["count"] == 4
    for name, t in a["trainable"].items():
        assert torch.equal(t, b["trainable"][name]), name
    assert set(a["optimizer"]["params"]) == set(a["trainable"])
    for name, st_a in a["optimizer"]["params"].items():
        for k, v in st_a.items():
            assert torch.equal(v, b["optimizer"]["params"][name][k]), (name, k)
    assert [line["epoch"] for line in log_lines(straight_run)] == [0, 1]
    assert log_lines(split) == log_lines(straight_run)


@pytest.mark.parametrize("name", ["checkpoint_best", "checkpoint_last"])
def test_evaluate_resume_gives_the_logged_val_acc(synth_root, straight_run,
                                                  name):
    with open(os.path.join(straight_run, f"{name}.meta.json")) as f:
        meta = json.load(f)
    logged = next(line for line in log_lines(straight_run)
                  if line["epoch"] == meta["epoch"])
    assert max(line["val_acc"] for line in log_lines(straight_run)) \
        == meta["best_acc"]
    stats = tevaluate.main(cli("--dataset", "nextqa", "--data_root",
                               synth_root, "--batch_size", "8",
                               "--output_dir", straight_run, "--resume",
                               name))
    assert stats["acc"] == logged["val_acc"]
    with pytest.raises(FileNotFoundError):
        tevaluate.main(cli("--data_root", synth_root, "--output_dir",
                           straight_run, "--resume", "nope"))


def test_log_line_has_every_key_of_jax(synth_root, tmp_path):
    """The port's log.txt line carries every key of the JAX CLI's line for
    the same flags (a --debug run of each)."""
    from flipped_tpu.cli import train as jtrain

    flags = ["--model", "tiny", "--dataset", "nextqa", "--data_root",
             synth_root, "--batch_size", "2", "--epochs", "1", "--debug",
             "--vaq", "--qav"]
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    jtrain.main(jax_parser().parse_args(flags + ["--dp", "1",
                                                 "--output_dir", jout]))
    ttrain.main(cli(*flags, "--output_dir", pout))
    (jline,), (pline,) = log_lines(jout), log_lines(pout)
    assert set(jline) <= set(pline), set(jline) - set(pline)
    assert os.path.isfile(os.path.join(pout, "checkpoint_last.meta.json"))
    assert os.path.isfile(os.path.join(pout, "checkpoint_last", "state.pt"))


def test_restore_is_strict(synth_root, straight_run, tmp_path):
    out = str(tmp_path / "out")
    shutil.copytree(os.path.join(straight_run, "checkpoint_last"),
                    os.path.join(out, "checkpoint_last"))
    model, _, _ = build_eval_state(run_config_from_args(cli()), "cpu")
    mgr = CheckpointManager(out)
    assert mgr.exists("checkpoint_last") and not mgr.exists("nope")
    assert mgr.restore("checkpoint_last", model)["epoch"] == 1
    path = os.path.join(out, "checkpoint_last", "state.pt")
    state = torch.load(path, weights_only=True)
    dropped = state["trainable"].pop("temporal_emb.weight")
    torch.save(state, path)
    with pytest.raises(KeyError, match="temporal_emb"):
        mgr.restore("checkpoint_last", model)
    state["trainable"]["temporal_emb.weight"] = dropped
    state["trainable"]["extra.weight"] = dropped
    torch.save(state, path)
    with pytest.raises(KeyError, match="extra"):
        mgr.restore("checkpoint_last", model)
    with pytest.raises(ValueError, match="--output_dir"):
        ttrain.main(train_args(synth_root, "", "--resume",
                               "checkpoint_last"))


def test_safetensors_only_directory_raises(tmp_path):
    (tmp_path / "tiny").mkdir()
    (tmp_path / "tiny" / "model.flax.safetensors").write_bytes(b"")
    with pytest.raises(ValueError, match="safetensors"):
        port_build(str(tmp_path), "none")


def test_missing_leaf_keeps_its_init_and_warns(meta_ckpt, tmp_path, capsys):
    """A frozen leaf the shards lack keeps its random init, with JAX's
    warning; the others load, and a key the model lacks is ignored."""
    port_dir, _ = meta_ckpt
    shutil.copytree(os.path.join(port_dir, "tiny"), tmp_path / "tiny")
    name = "layers.1.feed_forward.w2.weight"
    for p in sorted((tmp_path / "tiny").glob("consolidated.*.pth")):
        s = torch.load(p, weights_only=True)
        del s[name]
        s["layers.9.ffn_norm.weight"] = torch.ones(64)
        torch.save(s, p)
    model = port_build(str(tmp_path), "none")
    assert "missing 1 frozen leaves" in capsys.readouterr().out
    full = dict(load_meta_checkpoint(os.path.join(port_dir, "tiny")))
    params = dict(model.named_parameters())
    assert not torch.equal(params[name], full[name])
    for other, t in full.items():
        if other != name:
            assert torch.equal(params[other], t), other


def test_vocab_size_minus_one_takes_the_tokenizers(tmp_path):
    """Meta's params.json says vocab_size -1: the port takes the
    tokenizer's vocabulary (the reference's llama_vqa.py:61-62), and with
    no tokenizer raises naming both files. The JAX package passes the -1
    through and fails on the same directory (a divergence)."""
    (tmp_path / "tiny").mkdir()
    with open(tmp_path / "tiny" / "params.json", "w") as f:
        json.dump({**META_PARAMS, "vocab_size": -1}, f)
    with pytest.raises(ValueError, match="tokenizer"):
        resolve_model_config(run_config_from_args(port_args(str(tmp_path))))
    subprocess.run([sys.executable, "scripts/make_synthetic_tokenizer.py",
                    "--out", str(tmp_path / "tokenizer.model")], check=True,
                   capture_output=True)
    run_cfg = run_config_from_args(port_args(str(tmp_path)))
    assert resolve_model_config(run_cfg).vocab_size == 32000
    model, cfg, tokenizer = build_eval_state(run_cfg, "cpu")
    assert model.tok_embeddings.weight.shape == (32000, 64)
    assert tokenizer.n_words == 32000
    jcfg = jax_run_config(jax_parser().parse_args(
        ["--model", "tiny", "--llama_model_path", str(tmp_path)]))
    with pytest.raises((ValueError, AssertionError)):
        jbuild_train_state(jcfg)


@pytest.mark.parametrize("dim", [32, 48])
def test_rotate_params_on_a_full_tree(dim):
    """rotate_params on every leaf, trainables included (adapter_query's γ
    division, temporal_emb, visual_proj), against JAX's on the same f32
    tree with real norm weights: each leaf within f32 rounding of the
    different sum order (1e-5 of the leaf's largest); and the rotated
    model scores the options as the original does (tests/test_rotate.py's
    1e-4). dim 32: the FWHT with √32 not a power of two; 48: the QR
    rotation."""
    kw = dict(dim=dim, n_layers=2, n_heads=4, vocab_size=512,
              multiple_of=16, max_seq_len=96, adapter_len=4, adapter_layer=2,
              max_feats=4, visual_dim=16)
    cfg = JModelConfig(**kw)
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
    rs = np.random.RandomState(1)
    for name, sub in params.items():
        if name.startswith("layers_"):
            sub["attention"]["gate1"] = np.full(4, 0.4, np.float32)
            for norm in ("attention_norm", "ffn_norm"):
                sub[norm]["weight"] = (rs.rand(dim) + 0.5).astype(np.float32)
    params["norm"]["weight"] = (rs.rand(dim) + 0.5).astype(np.float32)
    want = params_from_flax(jrotate_params(params, 2, 2))
    state = params_from_flax(params)
    got = rotate_params(state, 2, 2)
    assert set(got) == set(want)
    for name, t in want.items():
        np.testing.assert_allclose(got[name].numpy(), t.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(t.abs().max()),
                                   err_msg=name)
    f32 = dict(dtype=torch.float32, frozen_dtype=torch.float32,
               trainable_dtype=torch.float32)
    scores = []
    for sd, rotated in ((state, False), (got, True)):
        model = FlippedVQAModel(ModelConfig(**kw), rotated=rotated, **f32)
        model.load_state_dict(sd, strict=True)
        host = ("answer", "qtype", "gt_answer", "qid", "valid", "span_need",
                "span_exact")
        with torch.no_grad():
            scores.append(option_scores(model, {
                k: torch.tensor(v) for k, v in batch.items()
                if k not in host}).numpy())
    np.testing.assert_allclose(scores[1], scores[0], rtol=1e-4, atol=1e-4)


def test_fwht_and_rotation_are_orthogonal_and_symmetric():
    """The butterfly is x·H; R is orthogonal; Rᵀdiag(γ)R is exactly
    symmetric (the QAV head applies it from the other side)."""
    rs = np.random.RandomState(0)
    x = rs.randn(3, 64).astype(np.float32)
    h = np.array([[1.0]], np.float32)
    while h.shape[0] < 64:
        h = np.block([[h, h], [h, -h]])
    np.testing.assert_allclose(fwht_(torch.from_numpy(x.copy())).numpy(),
                               x @ h, rtol=1e-5, atol=1e-5)
    for dim in (64, 48):                       # FWHT and QR rotations
        rot = Rotation(dim)
        r = rot.matrix().double()
        np.testing.assert_allclose((r @ r.t()).numpy(), np.eye(dim),
                                   atol=1e-5)
        q = rot.conjugate_diag(torch.from_numpy(
            rs.rand(dim).astype(np.float32)))
        assert torch.equal(q, q.t())
    with pytest.raises(ValueError, match="quantized"):
        rotate_params({"norm.weight": torch.ones(64),
                       "output.kernel_q": torch.zeros(8, 64)}, 2)
