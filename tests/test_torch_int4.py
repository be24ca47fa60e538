"""The port's packed int4 path and the rotated modes against the JAX package,
on the CPU.

Kernel level: the split-half packing; the plain K8 (both branches) and K9
(what each wrapper runs for a CPU tensor, and what chip_smoke.py holds the
CUDA kernels to) against `int4_matmul_grouped_pallas` / `int4_dx_pallas` in
interpret mode and against JAX's XLA forms; the autograd Functions against
jax.vjp of `int4_matmul` / `int4_matmul_grouped`; the shape dispatch against
`int4_pallas_supported`.

Model level: one float tree, initialised by the JAX model from a seed, is
quantized by the JAX `quantize_frozen` and carried into both packages
(`params_from_flax`) for the forward at int4, w4a8, int4r, w4a8r, int8r and
w8a8r, and the w4a8 train step against JAX `make_train_step` + optax; then
the quantize helpers and the converter at 4 bits.

Two configurations: dim 256 with 4 heads and an FFN hidden of 768, where
every block matmul passes the kernel guard (N/2 and the group multiples of
128), and dim 64 (the `tiny` preset's widths), where none does and both
packages take the XLA forms. On the CPU JAX lowers the int4 matmuls to their
XLA forms; the weight-only one is x @ bf16-dequantized W, not the kernel's
group-scaled product, so the model forward runs JAX with
`quant_matmul.INTERPRET` set, which sends the same calls through the Pallas
kernels in interpret mode, as the port sends them through K8 and K9.
"""
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
from flipped_tpu.model import int4 as j4
from flipped_tpu.model.int8 import _grouped_matmul_impl
from flipped_tpu.model.pallas import quant_matmul as jqm
from flipped_tpu.text import MockTokenizer
from flipped_tpu.train import make_optimizer as jmake_optimizer
from flipped_tpu.train import make_train_step as jmake_train_step
from flipped_tpu.train import partition_params
from flipped_tpu.train.optim import lr_schedule as jlr_schedule
from flipped_tpu_torch.ckpt import (dequantize_kernel, flatten_flax,
                                    flax_path_to_torch_name, params_from_flax,
                                    quantize_frozen, quantize_kernel,
                                    randomize_quantized)
from flipped_tpu_torch.core.config import (ModelConfig, TrainConfig,
                                           model_quant_kwargs)
from flipped_tpu_torch.model import FlippedVQAModel, Linear
from flipped_tpu_torch.model import int4 as t4
from flipped_tpu_torch.model.kernels import quant_matmul as qm
from flipped_tpu_torch.train import (check_dtype_policy, init_params,
                                     is_trainable, make_optimizer,
                                     make_train_step, trainable_parameters)

# (leading dims, K, N): every one passes the kernel guard
SHAPES = [((2, 12), 256, 256), ((37,), 384, 512), ((3, 5, 4), 1024, 256)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
W4_MAX = 8.0                  # |code| of a signed nibble


def _case(lead, k, n, seed):
    """x with one large column and an all-zero row, codes (K, N) in
    [-8, 7] packed the JAX way (K, N/2), scales as the synthetic model
    draws them times U(0.5, 1.5), a cotangent g."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*lead, k).astype(np.float32)
    x[..., 3] *= 25.0
    x.reshape(-1, k)[1] = 0.0
    codes = rs.randint(-8, 8, (k, n)).astype(np.int8)
    sg = ((rs.rand(k // 128, n) + 0.5) / (7.0 * np.sqrt(k))).astype(
        np.float32)
    g = rs.randn(*lead, n).astype(np.float32)
    return x, codes, j4.pack_int4(codes), sg, g


def _pair(x, jdt, tdt):
    jx = jnp.asarray(x).astype(jdt)
    return jx, torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt)


def _np(t):
    return t.detach().float().numpy()


def _port(packed):
    """JAX (K, N/2) packed → the port's (N/2, K)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(packed).T))


def _mag(x, codes, sg):
    """|x|·|W|ᵀ with W = codes·s_g, f64: the scale of the f32 sums."""
    k, n = codes.shape
    w = (codes.astype(np.float64).reshape(sg.shape[0], -1, n)
         * sg[:, None, :]).reshape(k, n)
    return np.abs(x.reshape(-1, k).astype(np.float64)) @ np.abs(w)


def test_pack_and_unpack_match_jax():
    """The port's (N/2, K) packing is the JAX (K, N/2) transposed, byte for
    byte, and unpacks to the same codes; an odd N is refused."""
    rs = np.random.RandomState(0)
    codes = rs.randint(-8, 8, (96, 40)).astype(np.int8)          # (K, N)
    packed = j4.pack_int4(codes)
    got = t4.pack_int4(torch.from_numpy(codes.T.copy()))
    np.testing.assert_array_equal(got.numpy(), packed.T)
    np.testing.assert_array_equal(t4.unpack_int4(got).numpy(), codes.T)
    np.testing.assert_array_equal(
        t4.unpack_int4(got).numpy(),
        np.asarray(j4.unpack_int4(jnp.asarray(packed))).T)
    np.testing.assert_array_equal(t4.unpack_int4(got).numpy(),
                                  j4.unpack_int4_np(packed).T)
    with pytest.raises(ValueError, match="even"):
        t4.pack_int4(torch.zeros(3, 4, dtype=torch.int8))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("lead,k,n", SHAPES)
def test_int4_matmul_ref_w4a8_matches_jax(lead, k, n, dtype):
    """Plain K8 with act_quant against `int4_matmul_grouped_pallas` in
    interpret mode and the jitted `_grouped_matmul_impl` on the unpacked
    codes (JAX's XLA form, `_w4a8_xla_impl`). All three quantize x per
    (row, 128-group) and sum exact int32 group dots times the two scales.
    The port divides amax by 127; jitted XLA may multiply by the
    reciprocal, which can move a value on a rounding tie by one code: such
    flips are counted (none expected in f32, at most 1e-3 of the codes in
    bf16) and each bounds its own effect, xs·8·s_g. Beyond them the outputs
    differ in the order of the f32 group sum (1e-5 relative) and, in bf16,
    by one final rounding (2^-7)."""
    jdt, tdt = DTYPES[dtype]
    x, codes, packed, sg, _ = _case(lead, k, n, 1)
    jx, tx = _pair(x, jdt, tdt)
    groups = k // 128
    tq, txs = qm.quantize_groups(tx.reshape(-1, k), groups)
    jq = np.asarray(jax.jit(lambda v: jnp.round(
        v.reshape(-1, groups, 128).astype(jnp.float32)
        / jnp.maximum(jnp.max(jnp.abs(v.reshape(-1, groups, 128).astype(
            jnp.float32)), -1, keepdims=True) / 127.0, 1e-8)))(jx))
    flips = (tq.numpy() != jq).sum(-1)
    assert flips.sum() <= 1e-3 * tq.numel(), flips.sum()
    if dtype == "f32":
        assert flips.sum() == 0
    flip_bound = (flips * txs.numpy()[..., 0]) @ (W4_MAX * sg)
    xla = np.asarray(jax.jit(_grouped_matmul_impl)(jx, codes, sg), np.float32)
    pal = np.asarray(jqm.int4_matmul_grouped_pallas(
        jx, jnp.asarray(packed), jnp.asarray(sg), interpret=True,
        act_quant=True), np.float32)
    got = _np(qm.int4_matmul(tx, _port(packed), torch.from_numpy(sg), True))
    assert got.shape == (*lead, n)
    rtol = 1e-5 if dtype == "f32" else 2.0 ** -7
    for want in (xla, pal):
        err = np.abs(got - want).reshape(-1, n)
        bound = (flip_bound * (1 + rtol)
                 + rtol * np.abs(want).reshape(-1, n) + 1e-6)
        assert (err <= bound).all(), float((err / bound).max())
    assert not got.reshape(-1, n)[1].any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("lead,k,n", SHAPES)
def test_int4_matmul_ref_weight_only_matches_jax(lead, k, n, dtype):
    """Plain K8 weight-only against `int4_matmul_grouped_pallas`
    (act_quant=False) in interpret mode and JAX's XLA form `_wo_xla_impl`.

    Against the kernel: both take bf16(x) and the raw codes, whose products
    are exact, and add d_g·s_g over the groups in order; the kernel sums
    each group's 128 products in f32, the port exactly in float64, so they
    differ by at most (K + 2G)·2^-24·(|x|·|W|ᵀ), plus one bf16 rounding in
    bf16 (2^-7 relative). Against the XLA form, x @ bf16(bf16(code)·
    bf16(s)): each weight differs by its bf16 rounding (2^-9 relative) and,
    for f32 x, each x by its bf16 rounding in the port (2^-9), so the two
    are within 2^-8·(|x|·|W|ᵀ) plus the output rounding."""
    jdt, tdt = DTYPES[dtype]
    x, codes, packed, sg, _ = _case(lead, k, n, 2)
    jx, tx = _pair(x, jdt, tdt)
    got = _np(qm.int4_matmul(tx, _port(packed), torch.from_numpy(sg),
                             False)).reshape(-1, n)
    pal = np.asarray(jqm.int4_matmul_grouped_pallas(
        jx, jnp.asarray(packed), jnp.asarray(sg), interpret=True,
        act_quant=False), np.float32).reshape(-1, n)
    xla = np.asarray(jax.jit(j4._wo_xla_impl)(jx, jnp.asarray(packed),
                                              jnp.asarray(sg)),
                     np.float32).reshape(-1, n)
    mag = _mag(np.asarray(jx.astype(jnp.float32)), codes, sg)
    out_rtol = 0.0 if dtype == "f32" else 2.0 ** -7
    groups = k // 128
    bound = (k + 2 * groups) * 2.0 ** -24 * mag \
        + out_rtol * np.abs(pal) + 1e-7
    assert (np.abs(got - pal) <= bound).all()
    bound = 2.0 ** -8 * mag + 2.0 ** -7 * np.abs(xla) + 1e-6
    assert (np.abs(got - xla) <= bound).all()
    assert not got[1].any()


@pytest.mark.parametrize("lead,k,n", SHAPES)
def test_int4_dx_ref_matches_jax(lead, k, n):
    """Plain K9 against `int4_dx_pallas` in interpret mode and JAX's XLA
    form `_int4_dx_xla`: the same bf16(code)·bf16(s) weight and f32 sums in
    another order, within one bf16 ulp (2^-7 relative); the port and the
    kernel round the f32 sum to bf16 once each and are equal for at least
    99% of the elements (as tests/test_torch_quant.py holds K4)."""
    _, codes, packed, sg, g = _case(lead, k, n, 3)
    g[(0,) * len(lead)] = 0.0
    xla = np.asarray(jax.jit(j4._int4_dx_xla)(jnp.asarray(g),
                                              jnp.asarray(packed),
                                              jnp.asarray(sg)))
    pal = np.asarray(jqm.int4_dx_pallas(jnp.asarray(g), jnp.asarray(packed),
                                        jnp.asarray(sg), interpret=True))
    got = _np(qm.int4_dx(torch.from_numpy(g), _port(packed),
                         torch.from_numpy(sg)))
    assert got.shape == (*lead, k)
    for want in (xla, pal):
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)
    assert np.mean(got == pal) > 0.99
    assert not got[(0,) * len(lead)].any()


@pytest.mark.parametrize("kn", [(4096, 4096), (4096, 11008), (11008, 4096),
                                (256, 768), (768, 256), (256, 256),
                                (384, 512), (64, 64), (64, 192), (192, 64),
                                (128, 96), (640, 256)])
def test_kernel_supported_mirrors_jax(kn):
    """The port's shape guard is `int4_pallas_supported` for the scales a
    Linear holds (group 128, one group where 128 does not divide K), and
    every LLaMA-7B block matmul passes it."""
    k, n = kn
    g = k // 128 if k % 128 == 0 else 1
    kq4, sg = np.zeros((k, n // 2), np.int8), np.zeros((g, n), np.float32)
    want = jqm.int4_pallas_supported(None, jnp.asarray(kq4), jnp.asarray(sg))
    assert t4.kernel_supported(_port(kq4), torch.from_numpy(sg)) == want
    if k in (4096, 11008):
        assert want


@pytest.fixture
def interpret(monkeypatch):
    """Send the JAX int4 matmuls through the Pallas kernels in interpret
    mode (read when a call is traced)."""
    monkeypatch.setattr(jqm, "INTERPRET", True)


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("lead,k,n", [((2, 12), 256, 256),
                                      ((3, 7), 64, 192)])
def test_int4_autograd_matches_jax_vjp(interpret, lead, k, n, act_quant):
    """Int4Matmul / Int4MatmulGrouped against jax.vjp of `int4_matmul` /
    `int4_matmul_grouped`, at a shape that takes the kernels and one (K 64,
    one group) that takes the XLA forms in both packages: the forward to f32
    rounding of the group sums (1e-5 of the largest output), dx (the bf16
    dequantized product in all four) within one bf16 ulp."""
    rs = np.random.RandomState(4)
    x = rs.randn(*lead, k).astype(np.float32)
    codes = rs.randint(-7, 8, (k, n)).astype(np.int8)
    groups = k // 128 if k % 128 == 0 else 1
    sg = ((rs.rand(groups, n) + 0.5) / (7.0 * np.sqrt(k))).astype(np.float32)
    g = rs.randn(*lead, n).astype(np.float32)
    packed = j4.pack_int4(codes)
    fn = j4.int4_matmul_grouped if act_quant else j4.int4_matmul
    y, vjp = jax.vjp(lambda v: fn(v, jnp.asarray(packed), jnp.asarray(sg)),
                     jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(g))
    tfn = t4.int4_matmul_grouped if act_quant else t4.int4_matmul
    tx = torch.from_numpy(x).requires_grad_()
    ty = tfn(tx, _port(packed), torch.from_numpy(sg))
    ty.backward(torch.from_numpy(g))
    y = np.asarray(y)
    np.testing.assert_allclose(_np(ty), y, rtol=0,
                               atol=1e-5 * np.abs(y).max())
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx_ref),
                               rtol=2.0 ** -7, atol=1e-6)


def test_wrappers_count_nothing_on_the_cpu():
    """A CPU tensor takes the plain version and launches nothing."""
    x, _, packed, sg, g = _case((8,), 256, 256, 6)
    before = (qm.int4_matmul.launches, qm.int4_dx.launches)
    tq4, tsg = _port(packed), torch.from_numpy(sg)
    qm.int4_matmul(torch.from_numpy(x), tq4, tsg, True)
    qm.int4_matmul(torch.from_numpy(x), tq4, tsg, False)
    qm.int4_dx(torch.from_numpy(g), tq4, tsg)
    assert (qm.int4_matmul.launches, qm.int4_dx.launches) == before


# --- the model ---------------------------------------------------------------

MODES = ("int4", "w4a8", "int4r", "w4a8r", "int8r", "w8a8r")
B, S, F = 2, 20, 3
CFGS = {
    "kernels": dict(dim=256, n_layers=2, n_heads=4, vocab_size=97,
                    multiple_of=256, max_seq_len=S, adapter_len=4,
                    adapter_layer=2, max_feats=F, visual_dim=16),
    "xla_forms": dict(dim=64, n_layers=2, n_heads=4, vocab_size=97,
                      multiple_of=32, max_seq_len=S, adapter_len=4,
                      adapter_layer=2, max_feats=F, visual_dim=16),
}
F32 = dict(dtype=jnp.float32, frozen_dtype=jnp.float32,
           trainable_dtype=jnp.float32, use_flash=False)
TF32 = dict(dtype=torch.float32, frozen_dtype=torch.float32,
            trainable_dtype=torch.float32)


def _float_params(kw, seed=7):
    """The JAX model's float tree from a seed, gates non-zero, and a
    symmetric qav_rot away from the identity (so the rotated modes' restore
    shows)."""
    cfg = JModelConfig(**kw)
    params = jax.device_get(jax.jit(JModel(cfg, **F32).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, S), jnp.int32),
        jnp.zeros((1, F, cfg.visual_dim), jnp.float32), None,
        jnp.zeros((1,), jnp.int32), jnp.arange(F, dtype=jnp.int32)[None])
        ["params"])
    heads = np.arange(cfg.n_heads, dtype=np.float32)
    for name, sub in params.items():
        if name.startswith("layers_"):
            sub["attention"]["gate1"] = 0.3 * (1.0 + heads)
            sub["attention"]["gate2"] = -1.5 + 0.2 * heads
    a = np.random.RandomState(seed).randn(cfg.dim, cfg.dim) / cfg.dim
    params["qav_rot"] = (np.eye(cfg.dim) + a + a.T).astype(np.float32)
    return params


def _quantized(params, mode):
    """The JAX quantize_frozen tree of a mode, qav_rot only where rotated."""
    flags = jquant_flags(mode)
    q = jquantize.quantize_frozen(params, flags["quant_group"],
                                  flags["quant_outliers"],
                                  bits=flags["weight_bits"])
    if not flags["rotated"]:
        q = {k: v for k, v in q.items() if k != "qav_rot"}
    return q


def _pair_models(kw, mode, params):
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
    return request.param, kw, _float_params(kw), data


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


def _jit_codes(x, groups):
    """The grouped quantize's codes as jitted XLA computes them."""
    def codes(v):
        v32 = v.reshape(-1, groups, v.shape[-1] // groups)
        amax = jnp.max(jnp.abs(v32), axis=-1, keepdims=True)
        return jnp.round(v32 / jnp.maximum(amax / 127.0, 1e-8))
    return np.asarray(jax.jit(codes)(jnp.asarray(x)))


def _flips(lin, x_port, x_jax):
    """(M, G) codes in which the port's quantize of x_port differs from the
    jitted JAX quantize of x_jax, and the port's xs (M, G)."""
    groups = lin.scale.shape[0]
    xp = torch.from_numpy(np.array(x_port.reshape(-1, x_port.shape[-1])))
    tq, xs = qm.quantize_groups(xp, groups)
    jq = _jit_codes(x_jax.reshape(-1, x_jax.shape[-1]), groups)
    return (tq.numpy() != jq).sum(-1), xs.numpy()[..., 0]


@pytest.mark.parametrize("mode", MODES)
def test_forward_matches_jax(interpret, float_case, mode):
    """The port's forward against the jitted JAX model (its int4 matmuls
    through the Pallas kernels in interpret mode where the guard passes) on
    the same quantized tree, at f32 compute.

    1. The leaves: kernel_q4 (N/2, K) where the 4-bit modes pack, the LM head
       int8 under them (grouped 128 where 128 divides dim), qav_rot exactly
       where rotated.
    2. Every quantized Linear, on the input the JAX model gave its
       counterpart, gives the JAX output to f32 rounding (1e-5 of the
       largest output) plus, under w4a8, the effect bound xs·8·s_g of each
       code the two quantizes give differently (at most 1e-3 of them).
    3. The logits agree to 1e-5 of the largest while no activation code
       differs between the two forwards; once one does (f32 noise carrying
       a value across a rounding boundary, as tests/test_torch_quant_model.py
       found for w8a8g) the first difference must sit where the two inputs
       agree to 1e-6 relative and number at most 4 codes, and the logits
       are held to 2.5e-3 of the largest (that test's bound)."""
    name_cfg, kw, params, d = float_case
    jmodel, qparams, tmodel = _pair_models(kw, mode, params)
    flags = jquant_flags(mode)
    bits4 = flags["weight_bits"] == 4
    assert tmodel.rotated == flags["rotated"] == ("qav_rot" in qparams)
    assert tmodel.output.weight_bits == 8 and not tmodel.output.act_quant
    wq = tmodel.layers["1"].attention.wq
    assert hasattr(wq, "kernel_q4") == bits4
    if bits4:
        assert tmodel.output.grouped == (kw["dim"] % 128 == 0)
        assert t4.kernel_supported(wq.kernel_q4, wq.scale) == \
            (name_cfg == "kernels")
    lm, qav, jcalls = _jax_forward_with_linears(jmodel, qparams, d)
    tcalls = []
    hooks = [mod.register_forward_hook(
        lambda m, i, o, name=name: tcalls.append((name, i[0].numpy())))
        for name, mod in tmodel.named_modules() if isinstance(mod, Linear)]
    with torch.no_grad():
        tokens, video, vs, splice = (torch.tensor(d[k]) for k in
                                     ("tokens", "video", "vs", "splice"))
        tlm, tqav = tmodel(tokens, video, None, vs, splice)
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
        if lin.quantized and lin.act_quant and lin.weight_bits == 4:
            flips, xs = _flips(lin, jx, jx)
            assert flips.sum() <= 1e-3 * jx.size, (name, flips.sum())
            bound += (flips * xs) @ (W4_MAX * lin.scale.numpy()) * (1 + 1e-5)
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


def test_int4_linear_refuses_outliers():
    """weight_bits=4 with the outlier passthrough raises, as JAX does."""
    with pytest.raises(ValueError, match="outlier"):
        Linear(256, 256, torch.float32, torch.float32, quantized=True,
               quant_group=128, quant_outliers=True, weight_bits=4)


# --- the w4a8 train step -----------------------------------------------------

TKW = dict(dim=256, n_layers=2, n_heads=4, vocab_size=512, multiple_of=256,
           max_seq_len=96, adapter_len=4, adapter_layer=2, max_feats=4,
           visual_dim=16)
TCFG = dict(epochs=8, warmup_epochs=1.0, lr=1e-2, weight_decay=0.1)
STEPS_PER_EPOCH, WORLD_BATCH = 4, 4


def test_train_step_w4a8_matches_jax():
    """Two updates of the port's train step at w4a8 against JAX
    make_train_step + optax on the same quantized tree and batch, at a width
    where every block matmul takes K8 and K9 in the port (their plain
    versions here); JAX on the CPU takes the XLA forms, which compute the
    same function (the grouped product on the unpacked codes, and the bf16
    dequantized dx). Tolerances as tests/test_torch_quant_model.py's train
    test at w8a8g: the losses to 1e-4 relative, grad_norm to 1e-3, each
    trainable within twice the second update's lr and 99% of their
    elements within 1e-5; the frozen backbone stays bitwise unchanged."""
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
    qparams = _quantized(params, "w4a8")
    jmodel = JModel(cfg, **F32, **jquant_flags("w4a8"))
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
                            **model_quant_kwargs("w4a8"))
    model.load_state_dict(params_from_flax(qparams), strict=True)
    assert all(t4.kernel_supported(m.kernel_q4, m.scale)
               for m in model.modules() if hasattr(m, "kernel_q4"))
    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
               if not is_trainable(n)}
    opt = make_optimizer(model, TrainConfig(vaq=True, qav=True, **TCFG),
                         STEPS_PER_EPOCH, WORLD_BATCH)
    tstep = make_train_step(model, opt, vaq=True, qav=True)
    tb = {k: torch.tensor(v)[None] for k, v in batch.items()}
    ours = np.array([[float(x) for x in tstep(tb)] for _ in range(2)])
    ref = np.array(ref)
    np.testing.assert_allclose(ours[:, :4], ref[:, :4], rtol=1e-4)
    np.testing.assert_allclose(ours[:, 4], ref[:, 4], rtol=1e-3)
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
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 2 * ref[1, 5], diffs.max()
    assert np.mean(diffs <= 1e-5) >= 0.99
    for n, p in model.named_parameters():
        if n in frozen0:
            assert torch.equal(p, frozen0[n]), n


# --- quantize helpers and the converter -------------------------------------

@pytest.mark.parametrize("group", [0, 128, 96])
def test_quantize_kernel_int4_matches_jax(group):
    """quantize_kernel(bits=4) on the (N, K) weight gives the JAX leaves of
    the (K, N) kernel exactly, in the port's layout: packed codes and the
    (G, N) scale; group 0 means 128, and 96 (not dividing K 256) one group.
    dequantize_kernel gives the JAX dequantized weight back, transposed.
    The outlier passthrough is refused at 4 bits."""
    rs = np.random.RandomState(3)
    w = (rs.randn(256, 72) / 16).astype(np.float32)
    w[7] *= 30.0
    ref = jquantize.quantize_kernel(w, group, 0, bits=4)
    got = quantize_kernel(torch.from_numpy(w.T.copy()), group, 0, bits=4)
    assert set(got) == set(ref) == {"kernel_q4", "scale"}
    np.testing.assert_array_equal(got["kernel_q4"].numpy(),
                                  np.asarray(ref["kernel_q4"]).T)
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(ref["scale"]))
    assert got["scale"].shape[0] == (1 if group == 96 else 2)
    np.testing.assert_array_equal(dequantize_kernel(got).numpy().T,
                                  jquantize.dequantize_kernel(ref))
    with pytest.raises(ValueError, match="outlier"):
        quantize_kernel(torch.from_numpy(w.T.copy()), group, 8, bits=4)


def test_quantize_frozen_int4_and_converter_match_jax(float_case):
    """quantize_frozen(bits=4) on the port's float state_dict gives the
    leaves the JAX quantize_frozen gives on the Flax tree (the LM head int8
    grouped, every block matmul packed), and params_from_flax carries
    kernel_q4 (transposed, int8) and qav_rot (f32, its own name) exactly
    into a model that loads them strictly."""
    name_cfg, kw, params, _ = float_case
    sd = params_from_flax(params)
    got = quantize_frozen(sd, 128, False, bits=4)
    want = params_from_flax(jquantize.quantize_frozen(params, 128, False,
                                                      bits=4))
    assert set(got) == set(want)
    for name, t in want.items():
        assert torch.equal(got[name].to(t.dtype), t), name
    assert "output.kernel_q" in want and "output.kernel_q4" not in want
    assert want["layers.1.attention.wq.kernel_q4"].dtype == torch.int8
    assert torch.equal(want["qav_rot"], torch.from_numpy(params["qav_rot"]))
    _, qparams, tmodel = _pair_models(kw, "w4a8r", params)
    check_dtype_policy(tmodel, torch.float32)
    packed = qparams["layers_1"]["feed_forward"]["w2"]["kernel_q4"]
    np.testing.assert_array_equal(
        tmodel.layers["1"].feed_forward.w2.kernel_q4.numpy(),
        np.asarray(packed).T)


@pytest.mark.parametrize("mode", ["int4", "w4a8r"])
def test_randomize_quantized_int4_follows_the_jax_laws(mode):
    """Packed codes uniform in [-7, 7] (never -8), scale 1/(7·√fan_in) in
    the (G, N) leaf; the int8 LM head as in the 8-bit modes; qav_rot the
    identity (JAX: ckpt/quantize.py:150-166, llama.py:529-535)."""
    kw = CFGS["kernels"]
    model = FlippedVQAModel(ModelConfig(**kw), **model_quant_kwargs(mode))
    trainable_parameters(model)
    init_params(model, seed=3)
    check_dtype_policy(model, torch.bfloat16)
    for name, lin in model.named_modules():
        if not getattr(lin, "quantized", False):
            continue
        if name == "output":
            assert lin.kernel_q.abs().max() <= 127
            continue
        codes, fan_in = t4.unpack_int4(lin.kernel_q4), lin.kernel_q4.shape[1]
        assert codes.min() == -7 and codes.max() == 7, name
        assert 3.5 < float(codes.float().std()) < 4.5
        assert torch.all(lin.scale == np.float32(1 / (7 * fan_in ** 0.5)))
    if mode.endswith("r"):
        assert torch.equal(model.qav_rot, torch.eye(kw["dim"]))
        assert not model.qav_rot.requires_grad
    before = model.layers["1"].attention.wq.kernel_q4.clone()
    randomize_quantized(model, torch.Generator().manual_seed(4))
    assert not torch.equal(before, model.layers["1"].attention.wq.kernel_q4)
