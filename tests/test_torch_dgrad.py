"""The port's w8a8d backward (K10's plain version, stochastic rounding, the
autograd Function and the train step) against the JAX package, on the CPU;
and the train and evaluate CLIs at every --quantize mode.

K10's plain version and `stochastic_round` must equal JAX bit for bit: the
dither is a murmur hash of each value's float32 bits and its (row, col)
position (JAX: int8.py:154-177), with the row the flattened row modulo the
cotangent's dim -2, and every float step is one IEEE operation on both
sides. JAX's float → int8 conversion saturates; f32(1/127) lies below 1/127,
so a row's absmax entry can divide to 127.00001 and round up to 128, which
both sides must clamp to 127.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flipped_tpu.core.config import ModelConfig as JModelConfig
from flipped_tpu.core.config import TrainConfig as JTrainConfig
from flipped_tpu.core.config import quant_flags as jquant_flags
from flipped_tpu.data import make_synthetic_items, pack_train_batch
from flipped_tpu.model import FlippedVQAModel as JModel
from flipped_tpu.model import int8 as j8
from flipped_tpu.model.pallas.quant_matmul import int8_dgrad_pallas
from flipped_tpu.ckpt import quantize as jquantize
from flipped_tpu.text import MockTokenizer
from flipped_tpu.train import make_optimizer as jmake_optimizer
from flipped_tpu.train import make_train_step as jmake_train_step
from flipped_tpu.train import partition_params
from flipped_tpu.train.optim import lr_schedule as jlr_schedule
from flipped_tpu_torch.ckpt import (flatten_flax, flax_path_to_torch_name,
                                    params_from_flax)
from flipped_tpu_torch.cli import evaluate as tevaluate
from flipped_tpu_torch.cli import train as ttrain
from flipped_tpu_torch.core.config import (QUANTIZE_CHOICES, ModelConfig,
                                           TrainConfig, get_args_parser,
                                           model_quant_kwargs)
from flipped_tpu_torch.data.synthetic import make_nextqa
from flipped_tpu_torch.model import FlippedVQAModel
from flipped_tpu_torch.model import int8 as q8
from flipped_tpu_torch.model.kernels import quant_matmul as qm
from flipped_tpu_torch.train import is_trainable, make_optimizer, \
    make_train_step

INV127 = np.float32(1.0 / 127.0)


def _case(shape, k, seed, dtype=np.float32):
    """g (..., N) with an all-zero row and one large column, kq in JAX's
    (K, N) layout, a per-channel scale (N,)."""
    rs = np.random.RandomState(seed)
    n = shape[-1]
    g = rs.randn(*shape).astype(np.float32)
    g[..., 5] *= 30.0
    g.reshape(-1, n)[1] = 0.0
    kq = rs.randint(-127, 128, (k, n)).astype(np.int8)
    scale = ((rs.rand(n) + 0.5) / (127.0 * np.sqrt(k))).astype(np.float32)
    return g, kq, scale


def _jsr_int8(x):
    """The jitted JAX stochastic_round with the saturating int8 cast the
    dgrad applies to it."""
    return np.asarray(jax.jit(
        lambda v: j8.stochastic_round(v).astype(jnp.int8))(jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(300,), (37, 256), (3, 12, 256)])
def test_stochastic_round_matches_jax(shape):
    """The port's stochastic_round equals JAX's code for code, on 1-D (no
    row term), 2-D and 3-D inputs (row = flattened row % dim -2), values of
    both signs up to the int8 range, including exact integers."""
    rs = np.random.RandomState(len(shape))
    x = (rs.randn(*shape) * 40).astype(np.float32)
    x.reshape(-1)[:7] = [0.0, -0.0, 1.0, -3.0, 126.5, -127.9, 0.5]
    got = q8.stochastic_round(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), _jsr_int8(x))
    # unbiased: over many draws of one value the mean is the value
    v = np.full((64, 512), 3.3, np.float32) + rs.rand(64, 512).astype(
        np.float32) * 1e-3
    mean = q8.stochastic_round(torch.from_numpy(v)).mean().item()
    assert abs(mean - float(v.mean())) < 0.01


def test_stochastic_round_saturates_like_jax():
    """Values in (127, 128) round up to 128 about frac of the time; JAX's
    conversion saturates that to 127, and so does the port (a wrapping
    conversion would give -128)."""
    x = np.full((8, 128), 127.6, np.float32)
    got = q8.stochastic_round(torch.from_numpy(x)).numpy()
    raw = np.asarray(jax.jit(j8.stochastic_round)(jnp.asarray(x)))
    assert (raw == 128.0).sum() > 0.4 * raw.size
    np.testing.assert_array_equal(got, _jsr_int8(x))
    assert (got == 127.0).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,k", [((37, 256), 384), ((3, 12, 256), 128),
                                     ((2, 5, 384), 256)])
def test_int8_dgrad_ref_matches_jax_bitwise(shape, k, dtype):
    """Plain K10 against the jitted `_dgrad_dx_xla` (JAX's default w8a8d dx)
    and `int8_dgrad_pallas` in interpret mode: bit for bit, on 2-D and 3-D
    cotangents (the dither's row is the flattened row % dim -2)."""
    g, kq, scale = _case(shape, k, 1)
    jg = jnp.asarray(g).astype(jnp.bfloat16 if dtype == "bf16"
                               else jnp.float32)
    tg = torch.tensor(np.asarray(jg.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bf16" else torch.float32)
    ref = np.asarray(jax.jit(j8._dgrad_dx_xla)(jg, kq, scale), np.float32)
    pal = np.asarray(int8_dgrad_pallas(jg, kq, scale, interpret=True),
                     np.float32)
    got = qm.int8_dgrad(tg, torch.from_numpy(kq.T.copy()),
                        torch.from_numpy(scale), shape[-2])
    assert got.dtype == tg.dtype and tuple(got.shape) == (*shape[:-1], k)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    np.testing.assert_array_equal(got.float().numpy(), pal)
    assert not got.reshape(-1, k)[1].any()


def _saturating_case(m=512, n=1024, k=64):
    """A cotangent whose row r has its absmax at column c with value v such
    that v / (v·f32(1/127)) is 127 plus one ulp, at a (r, c) whose dither u
    lies below that ulp, so the stochastic rounding reaches 128 there: found
    by trying v, then every position, with the port's own dither."""
    rs = np.random.RandomState(0)
    for v in (rs.rand(4096).astype(np.float32) + 1.0):
        x = v / np.maximum(v * INV127, np.float32(1e-8))
        if x > 127.0:
            break
    u = qm.dither(torch.full((m, n), float(x)), m).numpy()
    hits = np.argwhere(u < np.float32(x) - np.float32(127.0))
    assert len(hits), "no position draws 128: widen the search"
    r, c = hits[0]
    g = (rs.rand(m, n).astype(np.float32) - 0.5) * 0.5      # |g| < v / 2
    g[r, c] = v
    kq = rs.randint(-127, 128, (k, n)).astype(np.int8)
    return g, kq, np.ones(n, np.float32), (int(r), int(c)), x


def test_int8_dgrad_ref_saturates_the_row_absmax():
    """A row whose absmax entry rounds up to 128: the plain K10 clamps it to
    127 and equals the jitted `_dgrad_dx_xla` bit for bit; with the code
    wrapped to -128 instead the result would differ."""
    g, kq, scale, (r, c), x = _saturating_case()
    tg = torch.from_numpy(g)
    gsc = (tg.abs().amax(-1, keepdim=True) * float(INV127))
    xr = tg / gsc
    assert float(xr[r, c]) == x > 127.0
    fl = torch.floor(xr)
    raw = fl + ((xr - fl) > qm.dither(xr, g.shape[0])).float()
    assert float(raw[r, c]) == 128.0
    assert float(qm.sr_codes(xr, g.shape[0])[r, c]) == 127.0
    ref = np.asarray(jax.jit(j8._dgrad_dx_xla)(jnp.asarray(g), kq, scale))
    tkq = torch.from_numpy(kq.T.copy())
    got = qm.int8_dgrad(tg, tkq, torch.from_numpy(scale), g.shape[0])
    np.testing.assert_array_equal(got.numpy(), ref)
    wrapped = torch.clamp(raw, -128, 127)
    wrapped[r, c] = -128.0
    bad = ((wrapped.double() @ tkq.double()).float() * gsc).numpy()
    assert not np.array_equal(bad[r], ref[r])


@pytest.mark.parametrize("lead", [(37,), (3, 12)])
def test_int8_matmul_dgrad_matches_jax_vjp(lead):
    """Int8MatmulDgrad (K3 forward, K10 backward; their plain versions here)
    against jax.vjp of `int8_matmul_dgrad`: the forward and dx bit for bit,
    the row period taken from the cotangent's shape as JAX's iota does."""
    k, n = 384, 256
    rs = np.random.RandomState(4)
    x = rs.randn(*lead, k).astype(np.float32)
    _, kq, scale = _case((2, n), k, 5)                     # kq (K, N)
    g = rs.randn(*lead, n).astype(np.float32)
    y, vjp = jax.vjp(lambda v: j8.int8_matmul_dgrad(v, kq, scale),
                     jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    ty = q8.int8_matmul_dgrad(tx, torch.from_numpy(kq.T.copy()),
                              torch.from_numpy(scale))
    ty.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(y))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(dx_ref))


def test_int8_dgrad_wrapper_counts_nothing_on_the_cpu():
    g, kq, scale = _case((16, 128), 256, 6)
    before = qm.int8_dgrad.launches
    qm.int8_dgrad(torch.from_numpy(g), torch.from_numpy(kq.T.copy()),
                  torch.from_numpy(scale), 16)
    assert qm.int8_dgrad.launches == before


# --- the w8a8d train step ----------------------------------------------------

TKW = dict(dim=128, n_layers=2, n_heads=4, vocab_size=512, multiple_of=128,
           max_seq_len=96, adapter_len=4, adapter_layer=2, max_feats=4,
           visual_dim=16)
TCFG = dict(epochs=8, warmup_epochs=1.0, lr=1e-2, weight_decay=0.1)
STEPS_PER_EPOCH, WORLD_BATCH = 4, 4
F32 = dict(dtype=jnp.float32, frozen_dtype=jnp.float32,
           trainable_dtype=jnp.float32, use_flash=False)
TF32 = dict(dtype=torch.float32, frozen_dtype=torch.float32,
            trainable_dtype=torch.float32)


def _codes(g, scale, s_mod):
    """(x = gs/gsc, SR codes) of a cotangent, the plain K10's first half."""
    gs = torch.from_numpy(np.array(g.reshape(-1, g.shape[-1]))).float() \
        * torch.from_numpy(scale)
    gsc = torch.clamp_min(gs.abs().amax(-1, keepdim=True) * qm.INV127,
                          qm.EPS)
    x = gs / gsc
    return x, qm.sr_codes(x, s_mod)


def test_train_step_w8a8d_matches_jax(monkeypatch):
    """Two updates at w8a8d against JAX make_train_step + optax on the same
    quantized tree and batch, with the cotangent of every quantized Linear
    caught on both sides.

    The forwards are w8a8's (K3's plain version, bit for bit), so the losses
    agree to 1e-4 relative (measured 1e-7). The first update's lr is 0, so
    the second forward sees the same trainables again. The first quantized
    Linear of each backward (the last block's w2) gets cotangents that
    differ in their last f32 ulp (the f32 products above it sum in other
    orders): within 1e-5 of the largest. Wherever x = gs/gsc differs in any
    bit, the dither hashes another value and the draw is independent, so
    that element's code may flip, by exactly one; nowhere else may a code
    differ, and flips number at most half the elements whose x differs (the
    chance of a flip is 2·frac·(1 - frac), 1/3 on average). Every later
    cotangent carries those flips' noise, so it is not compared. Each flip
    moves one dx row by gsc·kq[n, :], a noise of the size SR itself adds,
    so grad_norm
    agrees to 1e-2 relative (measured 2.5e-4, with 5264 flips where x
    differed in 15774 elements, 0.33 of them) and each trainable after
    update 2 within twice its lr (AdamW moves each element by about the
    lr), the frozen backbone bitwise unchanged."""
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
    qparams = jquantize.quantize_frozen(params)
    jcaught, tcaught = [], []
    orig_j = j8._dgrad_dispatch

    def jcatch(g, kq, scale):
        jax.debug.callback(lambda a: jcaught.append(np.asarray(a)), g)
        return orig_j(g, kq, scale)
    monkeypatch.setattr(j8, "_dgrad_dispatch", jcatch)
    orig_t = q8.int8_dgrad

    def tcatch(g, kq, scale, s_mod):
        tcaught.append((g.detach().numpy().copy(), scale.numpy(), s_mod))
        return orig_t(g, kq, scale, s_mod)
    monkeypatch.setattr(q8, "int8_dgrad", tcatch)

    jmodel = JModel(cfg, **F32, **jquant_flags("w8a8d"))
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
    jax.effects_barrier()

    model = FlippedVQAModel(ModelConfig(**TKW), **TF32,
                            **model_quant_kwargs("w8a8d"))
    model.load_state_dict(params_from_flax(qparams), strict=True)
    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
               if not is_trainable(n)}
    opt = make_optimizer(model, TrainConfig(vaq=True, qav=True, **TCFG),
                         STEPS_PER_EPOCH, WORLD_BATCH)
    tstep = make_train_step(model, opt, vaq=True, qav=True)
    tb = {k: torch.tensor(v)[None] for k, v in batch.items()}
    ours = np.array([[float(x) for x in tstep(tb)] for _ in range(2)])
    ref = np.array(ref)

    # 7 stacked-row and 2 adapter Linears per block, 2 blocks, 2 updates
    assert len(tcaught) == len(jcaught) == 9 * 2 * 2
    close = differ = flips = 0
    for g, scale, s_mod in tcaught:
        same = [j for j in jcaught if j.shape == g.shape]
        jg = min(same, key=lambda j: np.abs(j - g).max())
        if np.abs(jg - g).max() > 1e-5 * np.abs(g).max():
            continue            # g carries the SR noise of a dx below it
        close += 1
        xt, ct = _codes(g, scale, s_mod)
        xj, cj = _codes(jg, scale, s_mod)
        moved = (xt.view(torch.int32) != xj.view(torch.int32)).numpy()
        flip = (ct != cj).numpy()
        assert not (flip & ~moved).any()
        assert (ct - cj).abs().max() <= 1
        differ += int(moved.sum())
        flips += int(flip.sum())
    assert close >= 2, close
    assert flips <= 0.5 * differ + 10, (flips, differ)
    np.testing.assert_allclose(ours[:, :4], ref[:, :4], rtol=1e-4)
    np.testing.assert_allclose(ours[:, 4], ref[:, 4], rtol=1e-2)
    np.testing.assert_allclose(ours[:, 5], ref[:, 5], rtol=1e-6)
    sd = model.state_dict()
    diffs = []
    for path, leaf in flatten_flax(jax.device_get(trainable)).items():
        if leaf is None:
            continue
        want = np.asarray(leaf)
        got = sd[flax_path_to_torch_name(path)].numpy()
        diffs.append(np.abs((got.T if got.shape != want.shape else got)
                            - want).ravel())
    assert np.concatenate(diffs).max() <= 2 * ref[1, 5]
    for n, p in model.named_parameters():
        if n in frozen0:
            assert torch.equal(p, frozen0[n]), n


# --- the CLIs at every mode --------------------------------------------------

@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dgrad_data")
    make_nextqa(str(root), 8, np.random.RandomState(0))
    return str(root)


@pytest.mark.parametrize("mode", QUANTIZE_CHOICES)
def test_every_mode_runs_the_train_and_evaluate_clis(synth_root, mode):
    """`cli.train.main` (one update, --vaq --qav) and `cli.evaluate.main`
    run at every --quantize mode on the CPU at the `tiny` preset, with
    finite losses and scores."""
    args = lambda *extra: get_args_parser().parse_args(
        ["--model", "tiny", "--dataset", "nextqa", "--data_root", synth_root,
         "--batch_size", "2", "--device", "cpu", "--debug", "--epochs", "1",
         "--output_dir", "", "--max_seq_len", "128", "--quantize", mode,
         *extra])
    model, history = ttrain.main(args("--vaq", "--qav"))
    assert history[0]["train_steps"] == 1
    assert all(np.isfinite(history[0][f"train_{k}"])
               for k in ("vqa_loss", "vaq_loss", "qav_loss", "grad_norm"))
    flags = model_quant_kwargs(mode)
    wq = model.layers["1"].attention.wq
    assert hasattr(wq, "kernel_q4") == (flags["weight_bits"] == 4)
    assert model.rotated == flags["rotated"]
    assert wq.dgrad_quant == flags["dgrad_quant"]
    stats = tevaluate.main(args())
    assert stats["batches"] == 1 and 0.0 <= stats["acc"] <= 1.0
