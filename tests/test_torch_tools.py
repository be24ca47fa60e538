"""The port's tools against the JAX package's: the quantization parity study
(synthesis, reports, an end-to-end leg and its cache), the trace analyzer,
the VLEP fixtures, the synthetic tokenizer, the sweep runner, the plots and
the converted safetensors checkpoint.

The study's synthesis is held leaf by leaf against the JAX script's
`_synthesize_frozen` at the `tiny` preset: bf16 weights bit for bit after
the transpose, codes and `out_idx` exactly, scales within one f32 ulp; the
rotated phases within tests/test_torch_ckpt.py's bound for the butterfly
against JAX's matmul rotation: at most 0.1% of a leaf's elements differ,
codes equal wherever their source bf16 row or row group is equal, and each
differing element by one bf16 ulp, or, where the rotation's f32 sums cancel
to a value far below the leaf's scale (2.5e-6 in a leaf of magnitude 0.3
here), by no more than the transform's f32 rounding. A tiny bf16 eval leg scores within 1e-4 relative of
JAX's `run_phase` when the port's parameters are JAX's init.
"""
import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flipped_tpu.ckpt.rotate import Rotation as JRotation
from flipped_tpu.model import FlippedVQAModel as JModel
from flipped_tpu.train import partition_params
from flipped_tpu_torch.ckpt.convert import params_from_flax
from flipped_tpu_torch.ckpt.rotate import Rotation
from flipped_tpu_torch.scripts import int8_parity_study as study

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
BF16_DIFF_SHARE = 1e-3          # tests/test_torch_ckpt.py's bound
SCORE_RTOL = 1e-4


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jstudy():
    return _load_script("int8_parity_study")


def _args(phase, **kw):
    base = dict(phase=phase, preset="tiny", batch=2, steps=1,
                data_seed=1234, weight_seed=0, weights="gaussian", cache="",
                out="", mode="eval", device="cpu", synth_only=False)
    base.update(kw)
    return argparse.Namespace(**base)


_JAX_INIT = {}


def _jax_params(jstudy, args, cfg):
    """JAX's `model.init` params of the phase (the values do not depend on
    the inputs, only on the key and the module paths), on the host."""
    flags = jstudy._flags_for(args)
    key = (repr(sorted(flags.items())), cfg, args.weight_seed, JModel)
    if key not in _JAX_INIT:
        _JAX_INIT[key] = jax.device_get(_init(JModel(cfg, **flags,
                                                     use_flash=False),
                                              args, cfg))
    return _JAX_INIT[key]


def _init(model, args, cfg):
    return jax.jit(model.init)(
        jax.random.PRNGKey(args.weight_seed),
        jnp.zeros((1, 16), jnp.int32),
        jnp.zeros((1, cfg.max_feats, cfg.visual_dim), jnp.float32), None,
        jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, cfg.max_feats), jnp.int32))["params"]


def _drop_none(tree):
    if not isinstance(tree, dict):
        return tree
    out = {k: _drop_none(v) for k, v in tree.items() if v is not None}
    return {k: v for k, v in out.items() if not (isinstance(v, dict)
                                                 and not v)}


def _synth_both(jstudy, phase, dist, n_layers=None):
    """(JAX's synthesized leaves, the port's) in the port's names and
    layout, for one phase and ensemble of the tiny preset."""
    import dataclasses

    args = _args(phase, weights=dist)
    jcfg = jstudy._config(args)
    cfg = study._config(args)
    if n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers,
                                   adapter_layer=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers,
                                  adapter_layer=n_layers)
    jflags = jstudy._flags_for(args)
    model = JModel(jcfg, **jflags, use_flash=False)
    _, frozen = partition_params(jax.eval_shape(
        lambda: _init(model, args, jcfg)))
    jrot = (JRotation(jcfg.dim, seed=jstudy.ROTATION_SEED)
            if jflags.get("rotated") else None)
    jtree = jstudy._synthesize_frozen(
        frozen, seed=args.weight_seed + 1, quantize=jflags["quantized"],
        dist=dist, model_dim=jcfg.dim, group=jflags["quant_group"],
        outliers=jflags["quant_outliers"], rot=jrot)
    want = params_from_flax(_drop_none(jax.tree_util.tree_map(
        lambda v: None if isinstance(v, jax.ShapeDtypeStruct) else v,
        jax.device_get(jtree), is_leaf=lambda v: v is None)))
    flags = study._flags_for(args)
    model = study._model(cfg, flags, "cpu")
    rot = (Rotation(cfg.dim, seed=study.ROTATION_SEED)
           if flags.get("rotated") else None)
    study._synthesize_frozen(model, seed=args.weight_seed + 1,
                             quantize=flags["quantized"], dist=dist,
                             model_dim=cfg.dim, group=flags["quant_group"],
                             outliers=flags["quant_outliers"], rot=rot)
    got = {}
    for name, linear in study.frozen_linears(model):
        for leaf, p in linear.named_parameters():
            got[f"{name}.{leaf}"] = p.detach()
    return want, got


def _check_exact(name, got, want):
    if got.dtype == torch.float32 and name.endswith("scale"):
        np.testing.assert_array_max_ulp(got.numpy(), want.numpy(), maxulp=1)
    else:
        assert torch.equal(got.to(want.dtype), want), name


@pytest.mark.parametrize("dist", study.DISTS)
@pytest.mark.parametrize("phase", ["bf16", "int8", "int8g", "int8o", "int4"])
def test_synthesis_matches_jax(jstudy, phase, dist):
    want, got = _synth_both(jstudy, phase, dist)
    assert got, "no frozen matmul was synthesized"
    for name, t in got.items():
        assert name in want, name
        _check_exact(name, t, want[name])


def test_synthesis_follows_the_flax_key_order(jstudy):
    """12 blocks: JAX's sorted keys put layers_10 and layers_11 before
    layers_2, and the draws follow."""
    want, got = _synth_both(jstudy, "bf16", "gaussian", n_layers=12)
    assert len(got) == 12 * 7 + 1
    for name, t in got.items():
        _check_exact(name, t, want[name])


def _bf16_ulps(a, b):
    mag = torch.maximum(a.abs(), b.abs()).float().clamp_min(2.0 ** -126)
    ulp = 2.0 ** (torch.floor(torch.log2(mag)) - 7)
    return (a.float() - b.float()).abs() / ulp


def _check_bf16_leaf(name, got, want, dim):
    """At most BF16_DIFF_SHARE of the elements differ, each by one bf16 ulp
    or, where the rotation's sums cancel to a value far below the leaf's
    scale, by no more than the transform's f32 rounding (dim terms, 2^-24
    each, of the leaf's largest magnitude) before the bf16 rounding."""
    got, want = got.to(torch.bfloat16).float(), want.to(torch.bfloat16).float()
    assert float((got != want).float().mean()) <= BF16_DIFF_SHARE, name
    f32_sums = dim * 2.0 ** -24 * float(torch.maximum(got.abs(),
                                                      want.abs()).max())
    ok = (_bf16_ulps(got, want) <= 1.0) | ((got - want).abs() <= f32_sums)
    assert bool(ok.all()), name


@pytest.mark.parametrize("dist", study.DISTS)
def test_rotated_synthesis_within_bound(jstudy, dist):
    """bf16r's leaves within the bound; int8r's and int4r's codes and
    scales equal wherever their bf16r source rows (groups) are equal."""
    src_j, src_p = _synth_both(jstudy, "bf16r", dist)
    for name, t in src_p.items():
        _check_bf16_leaf(name, t, src_j[name], study._config(
            _args("bf16r")).dim)
    for phase in ("int8r", "int4r"):
        want, got = _synth_both(jstudy, phase, dist)
        for name, t in got.items():
            base, leaf = name.rsplit(".", 1)
            sp, sj = src_p[f"{base}.weight"], src_j[f"{base}.weight"].to(
                torch.bfloat16)
            same = sp == sj                                      # (N, K)
            if leaf == "kernel_q4":   # packed rows j and j + N/2 together
                same = same.view(2, same.shape[0] // 2, -1).all(0)
            scale = got[f"{base}.scale"]
            if leaf in ("kernel_q", "kernel_q4"):
                g = (t.shape[1] // scale.shape[0] if scale.dim() == 2
                     else t.shape[1])
                rows = same.view(same.shape[0], -1, g).all(-1)
                ok = rows.repeat_interleave(g, dim=1)
                assert torch.equal(t[ok], want[name][ok]), name
            elif leaf == "scale":
                g = sp.shape[1] // (t.shape[0] if t.dim() == 2 else 1)
                rows = same.view(sp.shape[0], -1, g).all(-1)
                ok = rows.t() if t.dim() == 2 else rows[:, 0]
                np.testing.assert_array_max_ulp(
                    t[ok].numpy(), want[name][ok].numpy(), maxulp=1)


def _write_scores(root, rs):
    """Hand-made score and train files for every phase and ensemble."""
    for dist in study.DISTS:
        sfx = "" if dist == "gaussian" else f"_{dist}"
        base = rs.randn(12, 5)
        answers = rs.randint(0, 5, 12)
        for ph in ("bf16",) + study._COMPARED:
            s = base + (0 if ph == "bf16" else rs.randn(12, 5) * 0.3)
            np.savez(root / f"scores_{ph}{sfx}.npz", scores=s,
                     answers=answers, span=8)
            loss = 5 - np.arange(3) * 0.1 + rs.rand(3) * 0.01
            np.savez(root / f"train_{ph}{sfx}.npz", loss=loss,
                     grad_norm=1 + rs.rand(3))


def test_reports_equal_jax(jstudy, tmp_path, capsys):
    _write_scores(tmp_path, np.random.RandomState(3))
    for fn in ("report", "report_train"):
        getattr(jstudy, fn)(argparse.Namespace(out=str(tmp_path)))
        name = "report.json" if fn == "report" else "report_train.json"
        want = (tmp_path / name).read_text()
        getattr(study, fn)(argparse.Namespace(out=str(tmp_path)))
        assert (tmp_path / name).read_text() == want
    capsys.readouterr()
    rs = np.random.RandomState(4)
    a = {"scores": rs.randn(40, 4), "answers": rs.randint(0, 4, 40)}
    b = {"scores": a["scores"] + rs.randn(40, 4) * 0.5,
         "answers": a["answers"]}
    assert study._compare(a, b) == jstudy._compare(a, b)


def test_eval_leg_matches_jax_and_reports(jstudy, tmp_path, monkeypatch,
                                          capsys):
    """The bf16 phase at tiny, one batch of 2, in both packages with the
    port's parameters set to JAX's init: at f32 compute (the repo's parity
    setting: both models' dtypes monkeypatched to f32 over the same bf16
    weights) the scores agree within 1e-4 relative; as the study runs, in
    bf16, within 2^-8 relative (the two packages' bf16 GEMMs sum in other
    orders, and a rounding that flips moves a score by up to one bf16 ulp).
    Then w8a8 and the report."""
    import functools

    import flipped_tpu.model as jmodel_module

    def jax_init(model, seed=0):
        params = params_from_flax(_drop_none(jax.device_get(_jax_params(
            jstudy, _args(current["phase"]), jstudy._config(_args("bf16"))))))
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(params[name].to(p.dtype))

    def scores(out, phase):
        return np.load(out / f"scores_{phase}.npz")["scores"]

    current = {"phase": "bf16"}
    monkeypatch.setattr(study, "init_params", jax_init)
    with monkeypatch.context() as m:
        m.setattr(jmodel_module, "FlippedVQAModel", functools.partial(
            JModel, dtype=jnp.float32, frozen_dtype=jnp.float32))
        m.setattr(sys.modules[__name__], "JModel",
                  jmodel_module.FlippedVQAModel)
        m.setattr(study, "FlippedVQAModel", functools.partial(
            study.FlippedVQAModel, dtype=torch.float32,
            frozen_dtype=torch.float32))
        m.setattr(study, "_model", _f32_model)
        jstudy.run_phase(_args("bf16", out=str(tmp_path / "jax32")))
        study.run_phase(_args("bf16", out=str(tmp_path / "port32")))
    np.testing.assert_allclose(scores(tmp_path / "port32", "bf16"),
                               scores(tmp_path / "jax32", "bf16"),
                               rtol=SCORE_RTOL)
    jout, pout = tmp_path / "jax", tmp_path / "port"
    for phase in ("bf16", "w8a8"):
        current["phase"] = phase
        if phase == "bf16":
            jstudy.run_phase(_args(phase, out=str(jout)))
        study.run_phase(_args(phase, out=str(pout)))
    np.testing.assert_allclose(scores(pout, "bf16"), scores(jout, "bf16"),
                               rtol=2.0 ** -8)
    rep = study.report(argparse.Namespace(out=str(pout)))["gaussian"]["w8a8"]
    assert rep["n_examples"] == 2 and 0.0 <= rep["argmin_flip_rate"] <= 1.0
    assert np.isfinite(list(rep.values())).all()
    capsys.readouterr()


def _f32_model(cfg, flags, device):
    """The study's model computing in f32 over f32 copies of its leaves."""
    from flipped_tpu_torch.model.parallel import materialize
    from flipped_tpu_torch.train.optim import trainable_parameters

    model = study.FlippedVQAModel(cfg, trainable_dtype=torch.float32,
                                  device=torch.device("meta"), **flags)
    materialize(model, torch.device(device))
    trainable_parameters(model)
    return model


def test_train_leg_and_cache_roundtrip(tmp_path, capsys):
    """A bf16 train leg filling the cache, a second one reading it: the
    same trajectory bit for bit; the cache's leaves are the model's."""
    cache = tmp_path / "cache"
    runs = [study.run_train_phase(_args("bf16", out=str(tmp_path / o),
                                        cache=str(cache), mode="train"))
            for o in ("a", "b")]
    assert runs[0]["loss"] == runs[1]["loss"]
    assert runs[0]["grad_norm"] == runs[1]["grad_norm"]
    assert np.isfinite(runs[0]["loss"]).all()
    (tag,) = os.listdir(cache)
    assert tag == "gaussian_s1_bf16"
    c = study._SynthCache(str(cache / tag))
    assert c.loading and c.load("output.weight").dtype == torch.bfloat16
    t = torch.arange(6, dtype=torch.float32).view(2, 3).to(torch.bfloat16)
    c2 = study._SynthCache(str(tmp_path / "c2"))
    c2.save("layers.0.attention.wq.weight", t)
    c2.save("layers.0.attention.wq.out_idx", torch.arange(3,
                                                          dtype=torch.int32))
    c2.finish()
    c3 = study._SynthCache(str(tmp_path / "c2"))
    assert c3.loading and c3.keys_under("layers.0.attention.wq") == [
        "layers.0.attention.wq.out_idx", "layers.0.attention.wq.weight"]
    assert torch.equal(c3.load("layers.0.attention.wq.weight"), t)
    assert c3.load("layers.0.attention.wq.out_idx").dtype == torch.int32
    capsys.readouterr()


def test_synth_only_fills_the_cache_on_the_cpu(tmp_path, capsys):
    args = _args("w4a8", cache=str(tmp_path), synth_only=True)
    study.run_synth(args)
    (tag,) = os.listdir(tmp_path)
    assert tag == "gaussian_s1_q128b4"
    model, _ = study._build(_args("w4a8", cache=str(tmp_path)),
                            study._config(args), study._flags_for(args))
    fresh, _ = study._build(_args("w4a8"), study._config(args),
                            study._flags_for(args))
    for (n, a), (_, b) in zip(study.frozen_linears(model),
                              study.frozen_linears(fresh)):
        for leaf, p in a.named_parameters():
            assert torch.equal(p, getattr(b, leaf)), f"{n}.{leaf}"
    capsys.readouterr()


# ---------------------------------------------------------------- the trace


def _kernel(name, ts, dur, dev=0):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": dev, "tid": 7,
            "ts": ts, "dur": dur, "args": {"device": dev, "stream": 7}}


def _step(i, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": f"train step {i}",
            "pid": 1, "tid": 1, "ts": ts, "dur": dur}


def _write_trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_analyze_trace_device_rollup(tmp_path, capsys):
    """Busy is the union of kernel intervals (two overlapping kernels
    count once), the span the step annotations', the classes
    `cli.profile.kernel_class`'s; host events are not device time."""
    from flipped_tpu_torch.scripts import analyze_trace as at

    ev = [_step(1, 0, 100), _step(2, 100, 100),
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
           "tid": 1, "ts": 0, "dur": 500},
          _kernel("flash_text_fwd_kernel", 10, 30),
          _kernel("flash_text_bwd_dq_kernel", 30, 20),     # overlaps 10
          _kernel("nvjet_tst_128x256", 110, 40),
          _kernel("int8_fwd_wgmma_kernel", 160, 10)]
    path = tmp_path / "train_epoch0.pt.trace.json"
    _write_trace(path, ev)
    (dev, s), = at.analyze(at.load_events(str(path))).items()
    assert dev == "0" and s["kernels"] == 4 and s["steps"] == 2
    assert s["busy_ms"] == pytest.approx(0.090)          # 40 + 40 + 10 µs
    assert s["span_ms"] == pytest.approx(0.200)
    assert s["by_class"] == pytest.approx({"flash (K1/K2)": 0.050,
                                           "gemm": 0.040,
                                           "int8 GEMM (K3/K7)": 0.010})
    assert at.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "flash (K1/K2)" in out and "45.0% busy" in out


def test_analyze_trace_without_device_kernels_exits_nonzero(tmp_path,
                                                            capsys):
    from flipped_tpu_torch.scripts import analyze_trace as at

    path = tmp_path / "profile_train.pt.trace.json"
    _write_trace(path, [_step(1, 0, 100),
                        {"ph": "X", "cat": "cpu_op", "name": "aten::mm",
                         "pid": 1, "tid": 1, "ts": 0, "dur": 500}])
    assert at.main([str(path)]) == 1
    assert "NO DEVICE KERNEL" in capsys.readouterr().out


# ------------------------------------------- fixtures, tokenizer, sweep, plot


def _tree_bytes(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


def test_fixture_writer_matches_script_for_all_three_datasets(tmp_path):
    """NExT-QA, MUSIC-AVQA, then VLEP from one RandomState: every file
    byte for byte the script's."""
    from flipped_tpu_torch.data import synthetic

    synthetic.main(["--root", str(tmp_path / "port"), "--n", "6"])
    script = _load_script("make_synthetic_data")
    rs = np.random.RandomState(0)
    for make in (script.make_nextqa, script.make_musicavqa, script.make_vlep):
        make(str(tmp_path / "jax"), 6, rs)
    ours, ref = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert "vlep/vlep_subtitles.jsonl" in ours
    assert sorted(ours) == sorted(ref)
    for name in ours:
        assert ours[name] == ref[name], name


def test_tokenizer_file_equals_the_scripts(tmp_path, monkeypatch, capsys):
    from flipped_tpu_torch.scripts import make_synthetic_tokenizer as mst
    from flipped_tpu_torch.text import load_tokenizer

    mst.main(["--out", str(tmp_path / "port" / "tokenizer.model")])
    monkeypatch.setattr(sys, "argv", [
        "make_synthetic_tokenizer.py", "--out",
        str(tmp_path / "jax" / "tokenizer.model")])
    _load_script("make_synthetic_tokenizer").main()
    assert (tmp_path / "port" / "tokenizer.model").read_bytes() == \
        (tmp_path / "jax" / "tokenizer.model").read_bytes()
    tok = load_tokenizer(str(tmp_path / "port" / "tokenizer.model"))
    ids = tok.encode("Video:\nQuestion: what?\nAnswer: x", bos=True,
                     eos=False)
    assert {15167, 16492, 22550} <= set(ids) and tok.n_words == 32000
    capsys.readouterr()


def test_sweep_dry_run_equals_jax(monkeypatch, capsys):
    from flipped_tpu_torch.scripts import sweep

    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(sys, "argv", ["sweep.py", "--dry_run", "--", "--x",
                                      "1"])
    _load_script("sweep").main()
    want = capsys.readouterr().out
    sweep.main(["--dry_run", "--", "--x", "1"])
    got = capsys.readouterr().out
    assert got == want.replace("flipped_tpu.cli.train",
                               "flipped_tpu_torch.cli.train")
    assert got.count("run: ") == 30


def test_plot_writes_jax_file_names(tmp_path, capsys):
    from flipped_tpu.cli import plot as jplot
    from flipped_tpu_torch.cli import plot
    from flipped_tpu_torch.utils.logging import write_log_line

    run = tmp_path / "exp1"
    for epoch in range(2):
        write_log_line(str(run), {"train_loss": 2.0 - epoch, "train_lr": 0.1,
                                  "train_vqa_loss": 1.5, "epoch": epoch,
                                  "val_acc": 0.3 + epoch / 10})
    got = plot.create_plots_for_experiment(str(run), str(tmp_path / "p"))
    want = jplot.create_plots_for_experiment(str(run), str(tmp_path / "j"))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == [
            "exp1_loss.png", "exp1_accuracy.png", "exp1_lr.png"]
    assert all(os.path.getsize(p) > 0 for p in got)
    capsys.readouterr()


# ------------------------------------------------------- the safetensors file

META_PARAMS = dict(dim=64, n_layers=2, n_heads=4, multiple_of=32,
                   norm_eps=1e-6, vocab_size=512)     # the tiny preset


@pytest.fixture(scope="module")
def meta_shards(tmp_path_factory):
    """Two fp16 Meta shards of a random tiny backbone, and its state."""
    from flipped_tpu_torch.ckpt.convert import export_meta_checkpoint
    from flipped_tpu_torch.train.builder import init_params

    root = tmp_path_factory.mktemp("st") / "tiny"
    model = study._model(study._config(_args("bf16")), study._flags_for(
        _args("bf16")), "cpu")
    init_params(model, seed=3)
    state = {n: p.detach().to(torch.float16)
             for n, p in model.named_parameters() if not p.requires_grad}
    export_meta_checkpoint(state, 2, str(root), META_PARAMS)
    return root


def test_port_reads_the_jax_converters_file(meta_shards, tmp_path):
    from flipped_tpu.ckpt.convert import convert_meta_checkpoint as jconvert
    from flipped_tpu_torch.ckpt.convert import (load_flax_safetensors,
                                                load_meta_checkpoint,
                                                safetensors_params)

    path = tmp_path / "model.flax.safetensors"
    jconvert(str(meta_shards), str(path))
    got = dict(load_flax_safetensors(path))
    want = dict(load_meta_checkpoint(meta_shards))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.dtype == torch.bfloat16 and torch.equal(t, want[name]), name
    assert safetensors_params(path) == META_PARAMS


def test_jax_reads_the_ports_file(meta_shards, tmp_path):
    from flipped_tpu.ckpt.convert import convert_meta_checkpoint as jconvert
    from flipped_tpu.ckpt.convert import load_frozen_params
    from flipped_tpu_torch.ckpt.convert import convert_meta_checkpoint

    assert convert_meta_checkpoint(meta_shards, tmp_path / "port.st",
                                   device="cpu") == META_PARAMS
    jconvert(str(meta_shards), str(tmp_path / "jax.st"))
    got = jax.tree_util.tree_flatten_with_path(
        load_frozen_params(str(tmp_path / "port.st")))[0]
    want = jax.tree_util.tree_flatten_with_path(
        load_frozen_params(str(tmp_path / "jax.st")))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype == jnp.bfloat16 and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32), str(p))


@pytest.mark.parametrize("mode", ["none", "w8a8"])
def test_build_from_a_safetensors_only_directory(meta_shards, tmp_path,
                                                 mode):
    """A directory holding the converted file, its params.json (vocab_size
    -1) and a tokenizer builds with every frozen leaf the shards' build's,
    bit for bit; the -1 resolves to the tokenizer's vocabulary."""
    from flipped_tpu_torch.ckpt.convert import convert_meta_checkpoint
    from flipped_tpu_torch.core.config import (get_args_parser,
                                               run_config_from_args)
    from flipped_tpu_torch.scripts import make_synthetic_tokenizer as mst
    from flipped_tpu_torch.train.builder import build_eval_state

    def build(path, *extra):
        args = get_args_parser().parse_args([
            "--model", "tiny", "--device", "cpu", "--llama_model_path",
            str(path), "--quantize", mode, *extra])
        model, cfg, _ = build_eval_state(run_config_from_args(args), "cpu")
        return {n: p for n, p in model.named_parameters()
                if not p.requires_grad}, cfg

    (tmp_path / "st" / "tiny").mkdir(parents=True)
    convert_meta_checkpoint(meta_shards, tmp_path / "st" / "tiny"
                            / "model.flax.safetensors", device="cpu")
    want, _ = build(meta_shards.parent)
    got, cfg = build(tmp_path / "st")
    assert cfg.vocab_size == 512 and sorted(got) == sorted(want)
    for name, t in got.items():
        assert torch.equal(t, want[name]), name
    # params.json with Meta's -1 beside a 32000-piece tokenizer: the
    # tokenizer's vocabulary; the tiny model then has a 32000-row table
    mst.write(str(tmp_path / "st" / "tokenizer.model"))
    with open(tmp_path / "st" / "tiny" / "params.json", "w") as f:
        json.dump({**META_PARAMS, "vocab_size": -1}, f)
    if mode == "none":
        from flipped_tpu_torch.train.builder import resolve_model_config

        args = get_args_parser().parse_args([
            "--model", "tiny", "--llama_model_path", str(tmp_path / "st")])
        assert resolve_model_config(
            run_config_from_args(args)).vocab_size == 32000
