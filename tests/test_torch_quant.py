"""The port's int8 GEMMs against the JAX package, on the CPU.

The plain versions of K3, K7 and K4 (what each wrapper runs for a CPU
tensor, and what chip_smoke.py holds the CUDA kernels to) against the jitted
XLA formulations of flipped_tpu/model/int8.py and the Pallas kernels in
interpret mode, called directly as tests/test_quant_matmul_pallas.py calls
them; then the dx of both autograd Functions against jax.vjp of the JAX
custom VJPs. Inputs are seeded numpy with leading dims, an all-zero row and
one large column; kq is drawn in JAX's (K, N) layout and handed to the port
transposed, (N, K).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flipped_tpu.model.int8 import (_dx_grouped_xla, _grouped_matmul_impl,
                                    _int8_matmul_fwd_impl, _quantize_act)
from flipped_tpu.model.int8 import int8_matmul as jint8_matmul
from flipped_tpu.model.int8 import int8_matmul_grouped as jint8_matmul_grouped
from flipped_tpu.model.pallas.quant_matmul import (grouped_matmul_pallas,
                                                   int8_fwd_pallas,
                                                   quant_dx_pallas)
from flipped_tpu_torch.model import int8 as q8
from flipped_tpu_torch.model.kernels import quant_matmul as qm

# (leading dims, K, N); quant_dx_pallas takes only N % 128 == 0. The last
# two are the rows of K3's and K7's decode route on the card: one row, and
# the adapter prefix's 10
SHAPES = [((2, 12), 256, 256), ((37,), 384, 136), ((3, 5, 4), 1024, 128),
          ((1,), 512, 256), ((10,), 256, 136)]
DX_SHAPES = [((2, 12), 256, 256), ((37,), 384, 128), ((3, 5, 4), 1024, 128)]
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _case(lead, k, n, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(*lead, k).astype(np.float32)
    x[..., 3] *= 25.0                      # one large column
    if x.size > k:
        x.reshape(-1, k)[1] = 0.0          # an all-zero row
    kq = rs.randint(-127, 128, (k, n)).astype(np.int8)       # JAX (K, N)
    base = 1.0 / (127.0 * np.sqrt(k))
    scale = ((rs.rand(n) + 0.5) * base).astype(np.float32)
    sg = ((rs.rand(k // 128, n) + 0.5) * base).astype(np.float32)
    g = rs.randn(*lead, n).astype(np.float32)
    return x, kq, scale, sg, g


def _pair(x, jdt, tdt):
    """One array for both packages, rounded to the working dtype once."""
    jx = jnp.asarray(x).astype(jdt)
    return jx, torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt)


def _np(t):
    return t.detach().float().numpy()


def _kq_t(kq):
    return torch.from_numpy(np.ascontiguousarray(kq.T))


def test_quantize_act_codes_equal_jax():
    """Per-row codes and scales: the reciprocal multiply, RTN half to even;
    equal to the jitted `_quantize_act` code for code."""
    x, *_ = _case((4, 16), 384, 8, 0)
    jq, js = jax.jit(_quantize_act)(jnp.asarray(x))
    tq, ts = q8.quantize_act(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq, np.float32))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("lead,k,n", SHAPES)
def test_int8_fwd_ref_matches_jax_and_pallas(lead, k, n, dtype):
    """Plain K3 against the jitted `_int8_matmul_fwd_impl` and
    `int8_fwd_pallas` in interpret mode: bit for bit. The three compute the
    same IEEE operations (reciprocal-multiply scale, IEEE divide, exact
    integer dot, (d·xs)·scale, one rounding to the output dtype)."""
    _, jdt, tdt = DTYPES[dtype]
    x, kq, scale, *_ = _case(lead, k, n, 1)
    jx, tx = _pair(x, jdt, tdt)
    ref = np.asarray(jax.jit(_int8_matmul_fwd_impl)(jx, kq, scale),
                     np.float32)
    pal = np.asarray(int8_fwd_pallas(jx, kq, scale, interpret=True),
                     np.float32)
    got = qm.int8_fwd(tx, _kq_t(kq), torch.from_numpy(scale))
    assert got.dtype == tdt and tuple(got.shape) == (*lead, n)
    np.testing.assert_array_equal(_np(got), ref)
    np.testing.assert_array_equal(_np(got), pal)
    if x.size > k:
        assert not _np(got).reshape(-1, n)[1].any()      # the zero row


def _jit_group_codes(x, groups):
    """The codes of the grouped quantize as the jitted JAX model computes
    them (int8.py:255-258): under jit XLA may turn amax/127.0 into a
    multiply by the reciprocal."""
    def codes(x):
        x32 = x.reshape(-1, groups, x.shape[-1] // groups).astype(jnp.float32)
        amax = jnp.max(jnp.abs(x32), axis=-1, keepdims=True)
        return jnp.round(x32 / jnp.maximum(amax / 127.0, 1e-8))
    return np.asarray(jax.jit(codes)(x))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("lead,k,n", SHAPES)
def test_grouped_matmul_ref_matches_jax_and_pallas(lead, k, n, dtype):
    """Plain K7 against the jitted `_grouped_matmul_impl` and
    `grouped_matmul_pallas` in interpret mode.

    The port divides amax by 127 (an IEEE divide, as K7 does on the card);
    under jit XLA turns that division into a multiply by the reciprocal,
    whose scale can differ in the last ulp and move a value that sits on a
    rounding tie by one code. Such flips are counted (a few per 10^4 codes
    in bf16, none here in f32) and each bounds its own effect: a flip in
    (row m, group g) moves out[m, n] by at most xs[m, g]·127·s_g[g, n].
    Beyond the flips the outputs differ in the order of the f32 sum over
    groups and in the last ulp of xs (1e-5 relative), and in bf16 by the
    final rounding (one ulp, 2^-7 relative)."""
    _, jdt, tdt = DTYPES[dtype]
    x, kq, _, sg, _ = _case(lead, k, n, 2)
    jx, tx = _pair(x, jdt, tdt)
    groups = k // 128
    tq, txs = qm.quantize_groups(tx.reshape(-1, k), groups)
    flips = (tq.numpy() != _jit_group_codes(jx, groups)).sum(-1)   # (M, G)
    assert flips.sum() <= 1e-3 * tq.numel(), flips.sum()
    if dtype == "f32":
        assert flips.sum() == 0
    flip_bound = (flips * txs.numpy()[..., 0]) @ (127.0 * sg)      # (M, N)
    ref = np.asarray(jax.jit(_grouped_matmul_impl)(jx, kq, sg), np.float32)
    pal = np.asarray(grouped_matmul_pallas(jx, kq, sg, interpret=True),
                     np.float32)
    got = _np(qm.grouped_matmul(tx, _kq_t(kq), torch.from_numpy(sg)))
    rtol = 1e-5 if dtype == "f32" else 2.0 ** -7
    for want in (ref, pal):
        err = np.abs(got - want).reshape(-1, n)
        bound = (flip_bound * (1 + rtol) + rtol * np.abs(want).reshape(-1, n)
                 + 1e-6)
        assert (err <= bound).all(), float((err / bound).max())
    if x.size > k:
        assert not got.reshape(-1, n)[1].any()


@pytest.mark.parametrize("lead,k,n", DX_SHAPES)
def test_quant_dx_ref_matches_jax_and_pallas(lead, k, n):
    """Plain K4 against `_dx_grouped_xla` and `quant_dx_pallas` in interpret
    mode: the same bf16(kq)·bf16(s) weight and f32 sums in another order.
    All three agree within one bf16 ulp (2^-7 relative). The port and the
    Pallas kernel both round the f32 sum to bf16 once, so they are equal
    for at least 99% of the elements, as tests/test_quant_matmul_pallas.py
    holds the kernel to the XLA form; under jit XLA on the CPU may fold the
    bf16 rounding of the dot's result away (a convert pair), so against the
    jitted form only the one-ulp bound holds."""
    x, kq, _, sg, g = _case(lead, k, n, 3)
    g[(0,) * len(lead)] = 0.0                       # an all-zero row of g
    ref = np.asarray(jax.jit(_dx_grouped_xla)(jnp.asarray(g), kq, sg))
    pal = np.asarray(quant_dx_pallas(jnp.asarray(g), kq, sg, interpret=True))
    got = _np(qm.quant_dx(torch.from_numpy(g), _kq_t(kq),
                          torch.from_numpy(sg)))
    assert got.shape == (*lead, k)
    for want in (ref, pal):
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)
    assert np.mean(got == pal) > 0.99
    assert not got[(0,) * len(lead)].any()


@pytest.mark.parametrize("lead,k,n", SHAPES[:2])
def test_int8_matmul_dx_matches_jax_vjp(lead, k, n):
    """Int8Matmul: forward equal to the JAX custom VJP's, and dx — the exact
    bf16 product g·(bf16(kq)·bf16(s)) in both — within one bf16 ulp (the
    two CPU bf16 products sum in f32 in other orders)."""
    x, kq, scale, _, g = _case(lead, k, n, 4)
    y, vjp = jax.vjp(lambda x: jint8_matmul(x, kq, scale), jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    ty = q8.int8_matmul(tx, _kq_t(kq), torch.from_numpy(scale))
    ty.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(_np(ty), np.asarray(y))
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx_ref),
                               rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("lead,k,n", SHAPES[:2])
def test_int8_matmul_grouped_dx_matches_jax_vjp(lead, k, n):
    """Int8MatmulGrouped (K7 forward, K4 backward on the card; their plain
    versions here) against jax.vjp of `int8_matmul_grouped`: the forward
    within the f32 sum-order tolerance of the grouped test above, dx within
    one bf16 ulp."""
    x, kq, _, sg, g = _case(lead, k, n, 5)
    y, vjp = jax.vjp(lambda x: jint8_matmul_grouped(x, kq, sg),
                     jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    ty = q8.int8_matmul_grouped(tx, _kq_t(kq), torch.from_numpy(sg))
    ty.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_np(ty), np.asarray(y), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx_ref),
                               rtol=2.0 ** -7, atol=1e-6)


def test_wrappers_count_nothing_on_the_cpu():
    """A CPU tensor takes the plain version and launches nothing."""
    x, kq, scale, sg, g = _case((8,), 256, 128, 6)
    counts = lambda: (qm.int8_fwd.launches, qm.int8_fwd.decode_launches,
                      qm.grouped_matmul.launches,
                      qm.grouped_matmul.decode_launches,
                      qm.quant_dx.launches)
    before = counts()
    tkq = _kq_t(kq)
    qm.int8_fwd(torch.from_numpy(x), tkq, torch.from_numpy(scale))
    qm.grouped_matmul(torch.from_numpy(x), tkq, torch.from_numpy(sg))
    qm.quant_dx(torch.from_numpy(g), tkq, torch.from_numpy(sg))
    assert counts() == before


def test_decode_route_choice():
    """K3, K7 and K8 take their decode routes for x of at most DECODE_MAX_M
    (64) rows, K8 only at the model's group of 128."""
    assert qm.DECODE_MAX_M == 64
    assert all(qm.takes_decode_route(m) for m in (1, 10, 32, 63, 64))
    assert not any(qm.takes_decode_route(m) for m in (65, 320, 3072))
    assert qm.takes_decode_route(32, 128)
    assert not qm.takes_decode_route(32, 256)


# (N, K): the 7B block shapes, their tp-2 halves (N 2048; K 2048 and 5504),
# and shapes with few tiles or a contraction of less than one stage
SPLIT_SHAPES = [(4096, 4096), (11008, 4096), (4096, 11008), (2048, 4096),
                (4096, 2048), (4096, 5504), (11008, 2048), (136, 16),
                (264, 4096), (8, 1040)]


@pytest.mark.parametrize("n,k", SPLIT_SHAPES)
def test_int8_decode_splits_fill_the_card(n, k):
    """K3's decode route cuts K into runs of whole 256-deep stages until its
    64-column tiles times the runs reach DECODE_FILL (132) blocks: never
    more runs than stages or than a cluster holds (DECODE_MAX_RUNS, 8), as
    many as fit, and one run where the tiles alone fill the card; at the 7B
    shapes 128 blocks."""
    tiles = -(-n // 64)
    stages = -(-k // qm.DECODE_STAGE)
    runs = qm.int8_decode_splits(n, k)
    assert 1 <= runs <= min(stages, qm.DECODE_MAX_RUNS)
    assert tiles * runs <= max(tiles, qm.DECODE_FILL)
    if tiles >= qm.DECODE_FILL:
        assert runs == 1
    elif runs < min(stages, qm.DECODE_MAX_RUNS):
        assert tiles * (runs + 1) > qm.DECODE_FILL
    if n in (2048, 4096) and k >= 2048:
        assert tiles * runs == 128
