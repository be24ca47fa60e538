"""The port's quantized frozen backbone against the JAX package, on the CPU.

One float tree, initialised by the JAX model from a seed (gates non-zero), is
quantized by the JAX `quantize_frozen` for each --quantize mode and carried
into both packages (`params_from_flax`): the forward at the six int8 modes,
the train step at w8a8 and w8a8g, the quantize helpers, the converter and
the CLIs. Two configurations: dim 256 with an FFN hidden of 768 (every K a
multiple of 128, so the grouped modes run grouped everywhere) and dim 256
with hidden 704, the `small` preset's, whose w2 (K 704) falls back to
per-channel scales.

Where the two packages differ: the grouped activation quantize. The port
divides amax by 127 (an IEEE divide, what K7 does on the card); jitted XLA
multiplies by the reciprocal, whose scale can differ in the last ulp and
move a value that sits on a rounding tie by one code (tests/
test_torch_quant.py counts them: none in most draws, a few per 10^4 codes in
bf16). A flip in (row m, group g) moves out[m, n] by at most
xs[m, g]·127·s_g[g, n]. Besides, the two packages' activations differ by f32
rounding (about 1e-7 relative), which can carry a value across a rounding
boundary of the next quantize just the same. The forward test therefore
holds every quantized Linear on the JAX model's own inputs to f32 rounding
plus its counted flips, and the logits to f32 rounding up to the first code
that differs between the two forwards.
"""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from flipped_tpu.ckpt import quantize as jquantize
from flipped_tpu.core.config import ModelConfig as JModelConfig
from flipped_tpu.core.config import TrainConfig as JTrainConfig
from flipped_tpu.core.config import quant_flags as jquant_flags
from flipped_tpu.data import make_synthetic_items, pack_train_batch
from flipped_tpu.model import FlippedVQAModel as JModel
from flipped_tpu.text import MockTokenizer
from flipped_tpu.train import make_optimizer as jmake_optimizer
from flipped_tpu.train import make_train_step as jmake_train_step
from flipped_tpu.train import partition_params
from flipped_tpu.train.optim import lr_schedule as jlr_schedule
from flipped_tpu_torch.ckpt import (dequantize_kernel, flatten_flax,
                                    flax_path_to_torch_name, needs_transpose,
                                    outlier_count, params_from_flax,
                                    quantize_frozen, quantize_kernel,
                                    randomize_quantized)
from flipped_tpu_torch.cli import evaluate as tevaluate
from flipped_tpu_torch.cli import profile as tprofile
from flipped_tpu_torch.cli import train as ttrain
from flipped_tpu_torch.core.config import (QUANTIZE_CHOICES, ModelConfig,
                                           TrainConfig, check_quantize,
                                           get_args_parser, model_quant_kwargs,
                                           quant_flags)
from flipped_tpu_torch.data.synthetic import make_nextqa
from flipped_tpu_torch.model import FlippedVQAModel
from flipped_tpu_torch.model.kernels import quant_matmul as qm
from flipped_tpu_torch.train import (check_dtype_policy, init_params,
                                     is_trainable, make_optimizer,
                                     make_train_step, trainable_parameters)

MODES = ("int8", "int8g", "int8o", "w8a8", "w8a8g", "w8a8o")
B, S, F = 2, 20, 3
CFGS = {
    "aligned": dict(dim=256, n_layers=2, n_heads=2, vocab_size=97,
                    multiple_of=128, max_seq_len=S, adapter_len=4,
                    adapter_layer=2, max_feats=F, visual_dim=16),
    "w2_fallback": dict(dim=256, n_layers=2, n_heads=2, vocab_size=97,
                        multiple_of=32, max_seq_len=S, adapter_len=4,
                        adapter_layer=2, max_feats=F, visual_dim=16),
}
F32 = dict(dtype=jnp.float32, frozen_dtype=jnp.float32,
           trainable_dtype=jnp.float32, use_flash=False)
TF32 = dict(dtype=torch.float32, frozen_dtype=torch.float32,
            trainable_dtype=torch.float32)


def _float_params(kw, seed=7):
    """The JAX model's float tree from a seed, gates non-zero."""
    cfg = JModelConfig(**kw)
    model = JModel(cfg, **F32)
    tokens = jnp.zeros((1, S), jnp.int32)
    params = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(seed), tokens,
        jnp.zeros((1, F, cfg.visual_dim), jnp.float32), None,
        jnp.zeros((1,), jnp.int32), jnp.arange(F, dtype=jnp.int32)[None])
        ["params"])
    heads = np.arange(cfg.n_heads, dtype=np.float32)
    for name, sub in params.items():
        if name.startswith("layers_"):
            sub["attention"]["gate1"] = 0.3 * (1.0 + heads)
            sub["attention"]["gate2"] = -1.5 + 0.2 * heads
    return params


def _quantized(params, mode):
    flags = jquant_flags(mode)
    return jquantize.quantize_frozen(params, flags["quant_group"],
                                     flags["quant_outliers"])


def _pair(kw, mode, params):
    """(JAX model, its quantized tree, the port model loaded from it)."""
    qparams = _quantized(params, mode)
    jmodel = JModel(JModelConfig(**kw), **F32, **jquant_flags(mode))
    tmodel = FlippedVQAModel(ModelConfig(**kw), **TF32,
                             **model_quant_kwargs(mode))
    tmodel.load_state_dict(params_from_flax(qparams), strict=True)
    return jmodel, qparams, tmodel


@pytest.fixture(scope="module", params=sorted(CFGS))
def float_case(request):
    kw = CFGS[request.param]
    rs = np.random.RandomState(11)
    data = dict(tokens=rs.randint(0, kw["vocab_size"], (B, S)).astype(
                    np.int32),
                video=rs.randn(B, F, kw["visual_dim"]).astype(np.float32),
                vs=np.array([5, -1], np.int32),
                splice=np.array([[5, 6, 7], [9, 10, 11]], np.int32))
    return kw, _float_params(kw), data


def _jit_group_codes(x, groups):
    """The grouped quantize's codes as jitted XLA computes them
    (int8.py:255-258, amax/127.0 possibly turned into a reciprocal
    multiply), for (M, K) x → (M, G, K/G)."""
    def codes(x):
        x32 = x.reshape(-1, groups, x.shape[-1] // groups).astype(jnp.float32)
        amax = jnp.max(jnp.abs(x32), axis=-1, keepdims=True)
        return jnp.round(x32 / jnp.maximum(amax / 127.0, 1e-8))
    return np.asarray(jax.jit(codes)(jnp.asarray(x)))


def _jax_forward_with_linears(jmodel, qparams, d):
    """The jitted JAX forward → (lm, qav, [(path, x, out)] for every Linear
    call in order), the inputs caught by flax's method interceptor."""
    paths = []

    def fwd(variables, *args):
        calls = []

        def catch(next_fun, a, kw, ctx):
            out = next_fun(*a, **kw)
            if type(ctx.module).__name__ == "Linear" and \
                    ctx.method_name == "__call__":
                paths.append("/".join(ctx.module.path))
                calls.append((a[0], out))
            return out
        with nn.intercept_methods(catch):
            return jmodel.apply(variables, *args), calls
    (lm, qav), calls = jax.jit(fwd)(
        {"params": qparams}, jnp.array(d["tokens"]), jnp.array(d["video"]),
        None, jnp.array(d["vs"]), jnp.array(d["splice"]))
    return (np.asarray(lm), np.asarray(qav),
            [(p, np.asarray(x), np.asarray(o)) for p, (x, o)
             in zip(paths, calls)])


def _quant_input(lin, x):
    """(M, K) what a grouped w8a8 Linear quantizes: x with the outlier
    columns zeroed."""
    x = x.reshape(-1, x.shape[-1]).copy()
    if lin.quant_outliers:
        x[:, lin.out_idx.long().numpy()] = 0.0
    return x


def _flips(lin, x_port, x_jax):
    """(M, G) count of codes in which the port's quantize of x_port differs
    from the jitted JAX quantize of x_jax, and the port's xs (M, G)."""
    groups = lin.scale.shape[0]
    tq, xs = qm.quantize_groups(torch.from_numpy(_quant_input(lin, x_port)),
                                groups)
    jq = _jit_group_codes(_quant_input(lin, x_jax), groups)
    return (tq.numpy() != jq).sum(-1), xs.numpy()[..., 0]


@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_jax(float_case, mode):
    """The port's forward against the jitted JAX model on the same quantized
    tree, at f32 compute.

    1. Every quantized Linear, run on the input the JAX model gave its
       counterpart, gives the JAX output to f32 rounding (1e-5 of the
       largest output) plus, under w8a8g/w8a8o, the effect bound of each
       counted flip (module docstring); flips number at most 1e-3 of the
       codes (0 measured).
    2. The logits agree to f32 rounding (1e-5 of the largest) while no code
       differs between the two forwards. Once one does (measured: one code
       in layer 0's wo of the `aligned` config under w8a8g, moved by 1e-7
       relative f32 noise in the attention output), every later layer sees
       another input: that first difference must sit where the two inputs
       agree to f32 rounding (1e-6 relative) and number at most 4 codes,
       and the logits are held to 2.5e-3 of the largest, just above the
       largest measured spread (1.8e-3, `w2_fallback` w8a8g)."""
    kw, params, d = float_case
    jmodel, qparams, tmodel = _pair(kw, mode, params)
    lm, qav, jcalls = _jax_forward_with_linears(jmodel, qparams, d)
    tcalls = []
    hooks = [mod.register_forward_hook(
        lambda m, i, o, name=name: tcalls.append((name, i[0].numpy())))
        for name, mod in tmodel.named_modules() if type(mod).__name__
        == "Linear"]
    with torch.no_grad():
        tlm, tqav = tmodel(*(torch.tensor(d[k])
                             for k in ("tokens", "video", "vs", "splice")))
    for h in hooks:
        h.remove()
    assert len(tcalls) == len(jcalls)
    first_diff = None
    for (name, tx), (path, jx, jout) in zip(tcalls, jcalls):
        assert path == name.replace("layers.", "layers_", 1).replace(".", "/")
        lin = tmodel.get_submodule(name)
        with torch.no_grad():
            got = lin(torch.tensor(jx)).numpy().reshape(-1, jout.shape[-1])
        want = jout.reshape(got.shape)
        bound = np.full(got.shape, 1e-5 * np.abs(want).max())
        if lin.quantized and lin.act_quant and lin.grouped:
            flips, xs = _flips(lin, jx, jx)
            assert flips.sum() <= 1e-3 * jx.size, (name, flips.sum())
            bound += (flips * xs) @ (127.0 * lin.scale.numpy()) * (1 + 1e-5)
            between, _ = _flips(lin, tx, jx)
            if between.any() and first_diff is None:
                first_diff = (name, int(between.sum()),
                              np.abs(tx - jx).max() / np.abs(jx).max())
        assert (np.abs(got - want) <= bound).all(), (name, float(
            (np.abs(got - want) / bound).max()))
    rel = 1e-5
    if first_diff is not None:
        name, n, in_rel = first_diff
        assert n <= 4 and in_rel <= 1e-6, first_diff
        rel = 2.5e-3
    for got, want in ((tlm, lm), (tqav, qav)):
        err = np.abs(got.numpy() - want).max()
        assert err <= rel * np.abs(want).max(), (mode, err, first_diff)


def test_quantized_linears_take_the_jax_layout(float_case):
    """Leaf shapes: kernel_q (N, K), per-channel scale (N,) or grouped
    (K/128, N) — per-channel where 128 does not divide K — and the outlier
    leaves, for every quantized Linear; the LM head is weight-only."""
    kw, params, _ = float_case
    _, qparams, tmodel = _pair(kw, "w8a8o", params)
    for path, leaf in flatten_flax(qparams).items():
        name = flax_path_to_torch_name(path)
        got = tmodel.state_dict()[name]
        want = np.asarray(leaf)
        if needs_transpose(path):
            want = want.T
        assert tuple(got.shape) == want.shape, name
    hidden = ModelConfig(**kw).ffn_hidden
    w2 = tmodel.layers["1"].feed_forward.w2
    assert w2.grouped == (hidden % 128 == 0)
    assert tuple(w2.scale.shape) == ((hidden // 128, kw["dim"])
                                     if w2.grouped else (kw["dim"],))
    assert w2.out_idx.shape == (outlier_count(hidden),)
    assert tmodel.output.quantized and not tmodel.output.act_quant
    assert tmodel.layers["1"].attention.wq.act_quant


def test_converter_keeps_int_leaves_exact(float_case):
    """int8 kernel_q and int32 out_idx keep their dtype through
    params_from_flax and load_state_dict, bit for bit (kernel_q
    transposed); scale stays f32."""
    kw, params, _ = float_case
    _, qparams, tmodel = _pair(kw, "w8a8o", params)
    sd = params_from_flax(qparams)
    msd = tmodel.state_dict()
    seen = set()
    for path, leaf in flatten_flax(qparams).items():
        name = flax_path_to_torch_name(path)
        leafname = name.rsplit(".", 1)[-1]
        want = np.asarray(leaf)
        if leafname == "kernel_q":
            want = want.T
        if leafname in ("kernel_q", "out_idx", "scale"):
            seen.add(leafname)
            assert sd[name].dtype == msd[name].dtype == {
                "kernel_q": torch.int8, "out_idx": torch.int32,
                "scale": torch.float32}[leafname]
            np.testing.assert_array_equal(msd[name].numpy(), want)
    assert seen == {"kernel_q", "out_idx", "scale"}
    check_dtype_policy(tmodel, torch.float32)


@pytest.mark.parametrize("group,outliers", [(0, 0), (128, 0), (128, 8),
                                            (0, 8), (96, 0)])
def test_quantize_kernel_matches_jax(group, outliers):
    """The port's quantize_kernel on the (N, K) weight gives the JAX leaves
    of the (K, N) kernel exactly, in the port's layout; dequantize_kernel
    gives the JAX dequantized weight back, transposed. group 96 does not
    divide K 256: per-channel, as in JAX."""
    rs = np.random.RandomState(3)
    w = (rs.randn(256, 72) / 16).astype(np.float32)
    w[7] *= 30.0                                    # an outlier input row
    ref = jquantize.quantize_kernel(w, group, outliers)
    got = quantize_kernel(torch.from_numpy(w.T.copy()), group, outliers)
    assert set(got) == set(ref)
    for leaf, want in ref.items():
        want = np.asarray(want if leaf != "out_w" else
                          np.asarray(want, np.float32))
        have = got[leaf].float().numpy() if leaf == "out_w" else \
            got[leaf].numpy()
        np.testing.assert_array_equal(have.T if leaf == "kernel_q" else have,
                                      want, err_msg=leaf)
    np.testing.assert_array_equal(dequantize_kernel(got).numpy().T,
                                  jquantize.dequantize_kernel(ref))


def test_quantize_frozen_matches_jax(float_case):
    """quantize_frozen on the port's float state_dict gives the leaves the
    JAX quantize_frozen gives on the Flax tree, and keeps the rest."""
    kw, params, _ = float_case
    sd = params_from_flax(params)
    got = quantize_frozen(sd, 128, True)
    want = params_from_flax(jquantize.quantize_frozen(params, 128, True))
    assert set(got) == set(want)
    for name, t in want.items():
        assert torch.equal(got[name].to(t.dtype), t), name


@pytest.mark.parametrize("mode", ["int8", "w8a8g", "w8a8o"])
def test_randomize_quantized_follows_the_jax_laws(mode):
    """Codes uniform in [-127, 127], scale 1/(127·√fan_in) in the leaf's own
    shape, and in the outlier modes distinct sorted rows, zero in kernel_q,
    with out_w ~ randn/√fan_in (JAX: ckpt/quantize.py:141-201)."""
    kw = CFGS["w2_fallback"]
    model = FlippedVQAModel(ModelConfig(**kw), **model_quant_kwargs(mode))
    trainable_parameters(model)
    init_params(model, seed=3)
    check_dtype_policy(model, torch.bfloat16)
    for name, lin in model.named_modules():
        if not getattr(lin, "quantized", False):
            continue
        kq, fan_in = lin.kernel_q, lin.kernel_q.shape[1]
        assert kq.min() >= -127 and kq.max() <= 127 and kq.float().std() > 60
        assert torch.all(lin.scale == np.float32(1 / (127 * fan_in ** 0.5)))
        if mode == "w8a8o":
            idx = lin.out_idx.long()
            assert torch.equal(idx, idx.unique()) and len(idx) == \
                outlier_count(fan_in)
            assert not kq[:, idx].any()
            std = lin.out_w.float().std() * fan_in ** 0.5
            assert 0.8 < std < 1.2, (name, float(std))
    g = torch.Generator().manual_seed(3)
    before = model.layers["1"].attention.wq.kernel_q.clone()
    randomize_quantized(model, g)
    assert not torch.equal(before, model.layers["1"].attention.wq.kernel_q)


def test_quant_flags_and_refusals_match_jax():
    """quant_flags decodes every mode as the JAX package does; check_quantize
    lets every mode through (all run on one card) and refuses only unknown
    ones; model_quant_kwargs passes the model all seven keys."""
    for mode in QUANTIZE_CHOICES:
        assert quant_flags(mode) == jquant_flags(mode), mode
        check_quantize(mode)
        assert model_quant_kwargs(mode) == quant_flags(mode)
    for mode in ("int2", "w8a8gd"):
        with pytest.raises(ValueError):
            model_quant_kwargs(mode)


# --- the train step ---------------------------------------------------------

TKW = dict(dim=128, n_layers=2, n_heads=4, vocab_size=512, multiple_of=128,
           max_seq_len=96, adapter_len=4, adapter_layer=2, max_feats=4,
           visual_dim=16)
TCFG = dict(epochs=8, warmup_epochs=1.0, lr=1e-2, weight_decay=0.1)
STEPS_PER_EPOCH, WORLD_BATCH = 4, 4


@pytest.fixture(scope="module")
def train_case():
    cfg = JModelConfig(**TKW)
    items = make_synthetic_items(MockTokenizer(cfg.vocab_size), 4,
                                 max_feats=cfg.max_feats,
                                 max_seq_len=cfg.max_seq_len,
                                 visual_dim=cfg.visual_dim, seed=5)
    batch = pack_train_batch(items, cfg.max_feats)
    params = jax.device_get(jax.jit(JModel(cfg, **F32).init)(
        jax.random.PRNGKey(1), jnp.array(batch["vqa_tokens"]),
        jnp.array(batch["video"]), None, jnp.array(batch["vqa_video_start"]),
        jnp.array(batch["vqa_splice"]))["params"])
    for name, sub in params.items():
        if name.startswith("layers_"):
            sub["attention"]["gate1"] = np.full(4, 0.3, np.float32)
    return params, batch


@pytest.mark.parametrize("mode", ["w8a8", "w8a8g"])
def test_train_step_matches_jax(train_case, mode):
    """Two updates of the port's train step against JAX make_train_step +
    optax on the same quantized tree and batch. The forward agrees as in
    test_forward_matches_jax; the backward's bf16 dx products sum in f32 in
    other orders (one bf16 ulp, 2^-8 relative, per element of dx). So the
    losses agree to 1e-4 relative (a code flip would show at ~1e-4; measured
    2e-7), grad_norm to 1e-3 (measured 4e-5). AdamW moves each element by
    about the lr whatever the size of its gradient, so an element whose
    gradient is within that disagreement of zero may move the other way: the
    trainables agree within twice the second update's lr (2.5e-3), and 99%
    of their elements within 1e-5 (measured 99.94%). The frozen backbone
    stays bitwise unchanged."""
    params, batch = train_case
    qparams = _quantized(params, mode)
    jmodel = JModel(JModelConfig(**TKW), **F32, **jquant_flags(mode))
    jcfg = JTrainConfig(vaq=True, qav=True, **TCFG)
    tx = jmake_optimizer(jcfg, STEPS_PER_EPOCH, WORLD_BATCH)
    step = jmake_train_step(jmodel, tx, vaq=True, qav=True,
                            lr_fn=jlr_schedule(jcfg, STEPS_PER_EPOCH,
                                               WORLD_BATCH))
    trainable, frozen = partition_params(qparams)
    opt_state = tx.init(trainable)
    jb = {k: jnp.array(v)[None] for k, v in batch.items()}
    ref = []
    for _ in range(2):
        trainable, opt_state, m = step(trainable, opt_state, frozen, jb)
        ref.append([float(x) for x in m])

    model = FlippedVQAModel(ModelConfig(**TKW), **TF32,
                            **model_quant_kwargs(mode))
    model.load_state_dict(params_from_flax(qparams), strict=True)
    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
               if not is_trainable(n)}
    opt = make_optimizer(model, TrainConfig(vaq=True, qav=True, **TCFG),
                         STEPS_PER_EPOCH, WORLD_BATCH)
    tstep = make_train_step(model, opt, vaq=True, qav=True)
    tb = {k: torch.tensor(v)[None] for k, v in batch.items()}
    ours = [[float(x) for x in tstep(tb)] for _ in range(2)]
    ours, ref = np.array(ours), np.array(ref)
    # TrainMetrics fields: loss, vqa, vaq, qav, grad_norm, lr
    np.testing.assert_allclose(ours[:, :4], ref[:, :4], rtol=1e-4)
    np.testing.assert_allclose(ours[:, 4], ref[:, 4], rtol=1e-3)
    np.testing.assert_allclose(ours[:, 5], ref[:, 5], rtol=1e-6)
    sd = model.state_dict()
    diffs = []
    for path, leaf in flatten_flax(jax.device_get(trainable)).items():
        if leaf is None:                     # frozen leaves of the partition
            continue
        want = np.asarray(leaf)
        got = sd[flax_path_to_torch_name(path)].numpy()
        diffs.append(np.abs((got.T if got.shape != want.shape else got)
                            - want).ravel())
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 2 * ref[1, 5], diffs.max()
    assert np.mean(diffs <= 1e-5) >= 0.99
    for n, p in model.named_parameters():
        if n in frozen0:
            assert torch.equal(p, frozen0[n]), n


# --- the CLIs ---------------------------------------------------------------

@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_quant_data")
    make_nextqa(str(root), 8, np.random.RandomState(0))
    return str(root)


def _args(synth_root, *extra):
    return get_args_parser().parse_args(
        ["--model", "tiny", "--dataset", "nextqa", "--data_root", synth_root,
         "--batch_size", "2", "--device", "cpu", "--debug", "--epochs", "1",
         "--output_dir", "", *extra])


@pytest.mark.parametrize("mode", ["w8a8", "w8a8o"])
def test_train_cli_runs_quantized(synth_root, mode):
    """The train CLI at a quantized mode on the CPU (plain versions): one
    update, finite losses, an int8 backbone."""
    model, history = ttrain.main(_args(synth_root, "--quantize", mode))
    assert history[0]["train_steps"] == 1
    assert all(np.isfinite(history[0][f"train_{k}"])
               for k in ("vqa_loss", "vaq_loss", "qav_loss", "grad_norm"))
    assert model.layers["1"].attention.wq.kernel_q.dtype == torch.int8


def test_evaluate_cli_runs_quantized(synth_root):
    stats = tevaluate.main(_args(synth_root, "--quantize", "w8a8g",
                                 "--max_seq_len", "128"))
    assert stats["batches"] == 1 and 0.0 <= stats["acc"] <= 1.0


def test_train_cli_subprocess_w8a8(synth_root):
    """`python -m flipped_tpu_torch.cli.train --quantize w8a8` as a user
    runs it."""
    proc = subprocess.run(
        [sys.executable, "-m", "flipped_tpu_torch.cli.train", "--model",
         "tiny", "--device", "cpu", "--epochs", "1", "--debug",
         "--output_dir", "", "--dataset", "nextqa", "--data_root",
         synth_root, "--batch_size", "2", "--quantize", "w8a8"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(next(line for line in proc.stdout.splitlines()
                            if line.startswith("{")))
    assert stats["train_steps"] == 1 and stats["val_batches"] == 1


def test_profile_classes_the_int8_kernels():
    assert tprofile.kernel_class(
        "void (anonymous namespace)::int8_grouped_wgmma_kernel<false>("
        "CUtensorMap_st, ...)") \
        == "int8 GEMM (K3/K7)"
    assert tprofile.kernel_class(
        "void quant::quantize_rows_kernel<true>(__nv_bfloat16 const*, ...)") \
        == "int8 GEMM (K3/K7)"
    assert tprofile.kernel_class(
        "void (anonymous namespace)::quant_dx_kernel(__nv_bfloat16 const*, "
        "...)") == "quant dx (K4)"
