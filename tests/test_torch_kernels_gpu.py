"""The hand-written CUDA kernels (K1-K10) on the card, against their plain
versions; and the checkpoint loader's arithmetic on the card (quantize and
rotate on load) against the same on the CPU.

Marked `gpu`: each test skips without a CUDA device (the kernels have no CPU
mode). This file imports torch and the port only, so it also runs on a
machine without jax:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q
"""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from flipped_tpu_torch.ckpt.quantize import quantize_kernel
from flipped_tpu_torch.ckpt.rotate import Rotation
from flipped_tpu_torch.model.kernels import flash_attention as fa
from flipped_tpu_torch.model.kernels import quant_matmul as qm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,vs", [((2, 130, 4, 128), (-1, 5)),
                                      ((3, 37, 2, 128), (0, 5, -1))])
def test_flash_text_fwd_matches_plain(cuda, shape, vs):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(*shape, device=cuda, generator=g)
               .to(torch.bfloat16) for _ in range(3))
    g2 = torch.randn(shape[2], device=cuda, generator=g)
    video_start = torch.tensor(vs, dtype=torch.int32, device=cuda)
    before = fa.flash_text_attention.launches
    out, lse = fa.flash_text_attention(q, k, v, g2, video_start, 10)
    torch.cuda.synchronize()
    assert fa.flash_text_attention.launches == before + 1
    ref, ref_lse = fa.flash_text_attention_ref(q, k, v, g2, video_start, 10)
    scale, _ = fa.flash_text_attention_ref(q, k, v.abs(), g2, video_start, 10)
    # the kernel rounds unnormalised P to bf16, the plain version normalised
    # P: at most 2^-8·(P@|V|) apart before the final bf16 rounding (one ulp,
    # ≤ 2^-7·|out|); chip_smoke.py states the same bound
    bound = 2.0 ** -7 * (scale.float() + ref.float().abs()) + 2.0 ** -14
    assert bool(((out.float() - ref.float()).abs() <= bound).all())
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


def test_flash_text_fwd_rejects_f32(cuda):
    q = torch.zeros(1, 8, 2, 128, device=cuda)
    with pytest.raises(TypeError):
        fa.flash_text_attention(q, q, q, torch.zeros(2, device=cuda),
                                torch.zeros(1, dtype=torch.int32,
                                            device=cuda), 10)


# K2's cases: the unit shapes, then the edges of its loops' tiles (K6a's
# 128-row q items of two 64-row warpgroups, K6b's 128-key items of two
# 64-key warpgroups against 64-row q steps): S 1, 65 and 129, past a 64- and
# a 128-row tile, S 258 (rows of lse and D not 16 bytes apart), the video
# block across the 64-key edge (vs 60, max_feats 10) and across the 128-key
# edge (vs 120), and S 2048, the longest sequence K2 takes (MAX_SEQ_BWD).
K2_SHAPES = [((2, 130, 4, 128), (-1, 5)), ((3, 37, 2, 128), (0, 5, -1)),
             ((2, 1, 2, 128), (0, -1)), ((2, 65, 2, 128), (3, -1)),
             ((1, 129, 4, 128), (60,)), ((1, 258, 2, 128), (120,)),
             ((1, 2048, 2, 128), (1000,))]


@pytest.mark.parametrize("shape,vs", K2_SHAPES)
def test_flash_text_bwd_matches_plain(cuda, shape, vs):
    """K2 against its plain version (the coarse bound below), dgate2 against
    the float64 sum, and a second run equal bit for bit (one writer an
    element, no atomics on the outputs)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (torch.randn(*shape, device=cuda, generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    g2 = torch.randn(shape[2], device=cuda, generator=g)
    video_start = torch.tensor(vs, dtype=torch.int32, device=cuda)
    out, lse = fa.flash_text_attention(q, k, v, g2, video_start, 10)
    before = fa.flash_text_attention_bwd.launches
    got = fa.flash_text_attention_bwd(q, k, v, g2, video_start, 10, do, out,
                                      lse)
    torch.cuda.synchronize()
    assert fa.flash_text_attention_bwd.launches == before + 1
    again = fa.flash_text_attention_bwd(q, k, v, g2, video_start, 10, do, out,
                                        lse)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    ref = fa.flash_text_attention_bwd_ref(q, k, v, g2, video_start, 10, do)
    # the full bound chip_smoke.py states at K2_CASES (its max_feats is 10)
    import chip_smoke

    bounds, _, _ = chip_smoke.k2_bounds(torch, fa, q, k, v, g2, video_start,
                                        do, out, ref[:3])
    # and its coarse form: a flip of one bf16 ulp in P or dS moves a grad by
    # 2^-7 of one term. It is relative to the largest plain value, which
    # stands for the terms' size where rows see more than one key: at S 1
    # (one key) dS is 0 but for the rounding of dP - D on both sides, so dq
    # and dk are that rounding alone, which the full bound takes
    for name, x, r, bound in zip(("dq", "dk", "dv"), got, ref, bounds):
        assert bool(torch.isfinite(x).all()), name
        err = (x.double() - r.double()).abs()
        assert bool((err <= bound).all()), name
        if shape[1] > 1 or name == "dv":
            tol = 2.0 ** -6 * float(r.float().abs().max())
            assert float(err.max()) <= tol, name
    # dgate2 sums the kernel's f32 dS, whose D reads K1's bf16 out: held
    # against the float64 sum from the same inputs, to f32 rounding of the
    # terms (1e-3 of the sum of |dS| over the block)
    dg2, mag = _dgate2_f64(q, k, v, do, out, g2, video_start, 10)
    assert bool(((got[3].double() - dg2).abs() <= 1e-3 * mag + 1e-6).all())


def _dgate2_f64(q, k, v, do, out, g2, video_start, max_feats):
    """float64 dgate2 = sum over b and the video block of P (dP - D), with
    D = rowsum(dO * out) from K1's out; and the sum of |dS| there."""
    from flipped_tpu_torch.model.attention import video_block_bias

    s, h, dh = q.shape[1:]
    q, k, v, do, out = (x.double() for x in (q, k, v, do, out))
    sc = torch.einsum("bshd,bthd->bhst", q, k) / dh ** 0.5
    sc = sc + video_block_bias(video_start, s, max_feats, g2.double())
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(sc.masked_fill(~causal, float("-inf")), dim=-1)
    dp = torch.einsum("bshd,bthd->bhst", do, v)
    d = (do * out).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - d)
    block = video_block_bias(video_start, s, max_feats,
                             torch.ones(h, dtype=torch.float64,
                                        device=q.device)) > 0
    return (torch.where(block, ds, 0).sum(dim=(0, 2, 3)),
            torch.where(block, ds.abs(), 0).sum(dim=(0, 2, 3)))


def test_flash_autograd_function_on_card(cuda):
    """K1 forward + K2 backward through the autograd.Function: finite grads
    for all seven inputs, one launch of each kernel."""
    g = torch.Generator(device=cuda).manual_seed(2)
    mk = lambda *s: torch.randn(*s, device=cuda, generator=g)
    q, k, v = (mk(2, 40, 4, 128).to(torch.bfloat16).requires_grad_()
               for _ in range(3))
    ak, av = (mk(10, 4, 128).to(torch.bfloat16).requires_grad_()
              for _ in range(2))
    g1, g2 = mk(4).requires_grad_(), mk(4).requires_grad_()
    vs = torch.tensor([3, -1], device=cuda)
    f0, b0 = fa.flash_text_attention.launches, \
        fa.flash_text_attention_bwd.launches
    out = fa.flash_adapter_attention(q, k, v, ak, av, g1, g2, vs, 10)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert fa.flash_text_attention.launches == f0 + 1
    assert fa.flash_text_attention_bwd.launches == b0 + 1
    for x in (q, k, v, ak, av, g1, g2):
        assert bool(torch.isfinite(x.grad).all())


# The Function's output handed straight to autograd.grad in a fresh process:
# the backward kernel's wrapper is then the first CUDA work of autograd's
# worker thread, where PyTorch selects the device without making its context
# current, and the kernel's tensor maps need one (hopper_common.cuh
# `current_context`). MAX_SEQ_BWD 64 takes the streaming regime (K6a, K6b).
_FIRST_BACKWARD = """
import sys
import torch
from flipped_tpu_torch.model.kernels import flash_attention as fa
fa.MAX_SEQ_BWD = int(sys.argv[1])
g = torch.Generator(device="cuda").manual_seed(3)
mk = lambda *s: torch.randn(*s, device="cuda", generator=g)
xs = [mk(2, 130, 4, 128).to(torch.bfloat16) for _ in range(3)] \\
    + [mk(10, 4, 128).to(torch.bfloat16) for _ in range(2)] + [mk(4), mk(4)]
xs = [x.requires_grad_() for x in xs]
vs = torch.tensor([3, -1], dtype=torch.int32, device="cuda")
out = fa.flash_adapter_attention(*xs, vs, 10)
grads = torch.autograd.grad(out, xs, torch.ones_like(out))
torch.cuda.synchronize()
assert all(bool(torch.isfinite(x).all()) for x in grads)
print(fa.flash_text_attention_bwd.launches, fa.flash_streaming_dq.launches)
"""


@pytest.mark.parametrize("max_seq_bwd,launches", [(2048, "1 0"), (64, "0 1")])
def test_flash_backward_first_on_the_autograd_thread(cuda, max_seq_bwd,
                                                     launches):
    """K2 (and K6a + K6b in the streaming regime) as the first CUDA work
    of autograd's worker thread, in a fresh process: finite grads, one
    launch of the backward."""
    proc = subprocess.run(
        [sys.executable, "-c", _FIRST_BACKWARD, str(max_seq_bwd)],
        cwd=Path(__file__).resolve().parents[1], capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == launches.split()


# --- K5, K6a, K6b: the streaming kernels ------------------------------------

# (B, S_q, S_k, H, q_offset, video_start): a ragged S, and a q shard at an
# offset that is no multiple of the tiles against longer K/V
STREAM_CASES = [(2, 300, 300, 4, 0, (-1, 7)), (2, 100, 300, 4, 150, (0, 5))]


def _stream_inputs(cuda, b, s_q, s_k, h, vs, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    mk = lambda s: torch.randn(b, s, h, 128, device=cuda,
                               generator=g).to(torch.bfloat16)
    q, k, v, do = mk(s_q), mk(s_k), mk(s_k), mk(s_q)
    g2 = torch.randn(h, device=cuda, generator=g)
    return q, k, v, do, g2, torch.tensor(vs, dtype=torch.int32, device=cuda)


def _k5_hold(q, k, v, g2, video_start, q_offset, out, lse):
    """K5 against its plain version and its lse against the float64
    log-sum-exp, within the bounds chip_smoke.py states at STREAM_CASES;
    up to S_k 650 the out bound is K1's and the lse also lies within 1e-5
    relative, 1e-4 absolute of the plain one (as `_k1_hold`), past it the
    out bound adds the f32 sums of up to S_k terms and S_k/64 rescales and
    the score errors (2^-16 max_c B, B = scale |q|.|k|)."""
    s_q, s_k, dh = q.shape[1], k.shape[1], q.shape[3]
    ref, ref_lse = fa.flash_streaming_fwd_ref(q, k, v, g2, video_start, 10,
                                              q_offset)
    mag, _ = fa.flash_streaming_fwd_ref(q, k, v.abs(), g2, video_start, 10,
                                        q_offset)
    q64, k64 = q.double(), k.double()
    block = fa._video_block(s_q, s_k, video_start, 10, q.device, q_offset)
    sc = torch.einsum("bshd,bthd->bhst", q64, k64) / dh ** 0.5 \
        + torch.where(block, g2.double()[None, :, None, None], 0.0)
    causal = (torch.arange(s_k, device=q.device)[None, :]
              <= torch.arange(s_q, device=q.device)[:, None] + q_offset)
    lse64 = torch.logsumexp(sc.masked_fill(~causal, float("-inf")), -1)
    bb = torch.einsum("bshd,bthd->bhst", q64.abs(), k64.abs()) / dh ** 0.5
    max_b = bb.masked_fill(~causal, 0).amax(-1)               # (B, H, S_q)
    del sc, bb
    lse_bound = (2.0 ** -16 * max_b + (s_k + s_k / 64 + 64) * 2.0 ** -24
                 + 2.0 ** -23 * lse64.abs())
    assert bool(((lse.double() - lse64).abs() <= lse_bound).all())
    mag = mag.double()
    bound = 2.0 ** -7 * (mag + ref.double().abs()) + 2.0 ** -14
    if s_k <= 650:
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    else:
        bound = bound + (2 * (s_k + s_k / 64) * 2.0 ** -24
                         + 2.0 ** -16 * max_b.transpose(1, 2)[..., None]) \
            * mag
    assert bool(torch.isfinite(out).all())
    assert bool(((out.double() - ref.double()).abs() <= bound).all())


# Edges of K6a's and K6b's tiles (K6a: 128-row q items of two 64-row
# warpgroups against 128-key tiles; K6b: 128-key items of two 64-key
# warpgroups against 64-row q steps): S_q of 1 (at offsets that give its
# row more than one key: with one key, dS is 0 and both sides return only
# the rounding of dP - D), 65 and 129, past a 64-row and a 128-row tile,
# and none of them nor 258 a multiple of 4 (lse and D rows that are not
# 16 bytes apart); S_k > q_offset + S_q at an offset that
# is no multiple of a tile, so that K6b's last key tiles see no row; a
# video block across the 128-key tile edge (vs 120 with max_feats 10) and
# one across the warpgroups' 64-key edge (vs 60); B * H * tiles above the
# card's 132 SMs, so that the persistent grids wrap; and runs of work a
# warpgroup skips: 248 of K6b's 256 key tiles after every row (S_q 64
# against S_k 4096), and a K6a warpgroup whose 64 rows all lie past S_q
# across 25 key tiles (S_q 64 at q_offset 3000).
STREAM_EDGE = [(1, 1, 2, 2, 1, (0,)), (2, 1, 300, 2, 200, (5, -1)),
               (2, 65, 65, 4, 0, (3, -1)), (1, 129, 129, 4, 0, (60,)),
               (1, 258, 258, 2, 0, (120,)), (1, 100, 400, 2, 37, (10,)),
               (3, 520, 520, 32, 0, (5, -1, 40)),
               (1, 64, 4096, 8, 0, (5,)), (2, 64, 3200, 4, 3000, (3000, -1))]


@pytest.mark.parametrize("b,s_q,s_k,h,q_offset,vs",
                         STREAM_CASES + STREAM_EDGE)
def test_flash_stream_fwd_matches_plain(cuda, b, s_q, s_k, h, q_offset, vs):
    """K5: one launch, within `_k5_hold`'s bounds, and a second run equal
    bit for bit (an item's sums run in one order whichever block takes it)."""
    q, k, v, _, g2, video_start = _stream_inputs(cuda, b, s_q, s_k, h, vs, 5)
    before = fa.flash_streaming_fwd.launches
    out, lse = fa.flash_streaming_fwd(q, k, v, g2, video_start, 10, q_offset)
    torch.cuda.synchronize()
    assert fa.flash_streaming_fwd.launches == before + 1
    again = fa.flash_streaming_fwd(q, k, v, g2, video_start, 10, q_offset)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    _k5_hold(q, k, v, g2, video_start, q_offset, out, lse)


@pytest.mark.parametrize("b,s_q,s_k,h,q_offset,vs",
                         STREAM_CASES + STREAM_EDGE)
def test_flash_stream_bwd_matches_plain(cuda, b, s_q, s_k, h, q_offset, vs):
    """K6a and K6b: one launch each, within the coarse bound below of their
    plain versions; keys after every row (c > q_offset + S_q - 1) exactly
    zero in dk and dv; a second run equal bit for bit (one writer an
    element, no atomics on the outputs)."""
    q, k, v, do, g2, video_start = _stream_inputs(cuda, b, s_q, s_k, h, vs, 6)
    out, lse = fa.flash_streaming_fwd(q, k, v, g2, video_start, 10, q_offset)
    delta = fa.stream_delta(do, out)
    args = (q, k, v, g2, video_start, 10, do, lse, delta, q_offset)
    b_dq, b_dkv = fa.flash_streaming_dq.launches, \
        fa.flash_streaming_dkv.launches
    got = fa.flash_streaming_dq(*args) + fa.flash_streaming_dkv(*args)
    torch.cuda.synchronize()
    assert (fa.flash_streaming_dq.launches,
            fa.flash_streaming_dkv.launches) == (b_dq + 1, b_dkv + 1)
    again = fa.flash_streaming_dq(*args) + fa.flash_streaming_dkv(*args)
    refs = fa.flash_streaming_dq_ref(*args) + fa.flash_streaming_dkv_ref(
        *args)
    # the same D and lse on both sides: a flip of one bf16 ulp in P or dS
    # moves a grad by 2^-7 of one term; chip_smoke.py states the full bound,
    # this is its coarse form
    for name, x, y, r in zip(("dq", "dgate2", "dk", "dv"), got, again, refs):
        assert bool(torch.isfinite(x).all()), name
        assert torch.equal(x, y), name
        if name == "dgate2":
            # both sum the same f32 dS over the block, in other orders
            torch.testing.assert_close(x, r, rtol=1e-3, atol=1e-3)
            continue
        tol = 2.0 ** -6 * float(r.float().abs().max())
        assert float((x.float() - r.float()).abs().max()) <= tol, name
    dead = q_offset + s_q                      # the first key no row sees
    if dead < s_k:
        assert not bool(got[2][:, dead:].any()), "dk past every row"
        assert not bool(got[3][:, dead:].any()), "dv past every row"


def test_flash_stream_shards_sum_to_the_full_backward(cuda):
    """Four q shards at offsets 0, 64, 128, 192 against full K/V, each with
    its rows of D: out, lse and dq equal the full run's row slices (the same
    tiles and operations: bit for bit), and the dk, dv, dgate2 partials sum
    to the full result. The terms are the same; each partial and the full
    result round an f32 sum to bf16 once (2^-8 relative each), and each f32
    sum lies within S·2^-24·M of the exact one, M the sum of the terms'
    magnitudes (scale |dS|ᵀ|Q| for dk, Pᵀ|dO| for dv, taken in float64):
    |Σ_i dk_i − dk| <= 2^-8 (Σ_i |dk_i| + |dk|) + 2 S 2^-24 M (as
    chip_smoke.py states it)."""
    q, k, v, do, g2, vs = _stream_inputs(cuda, 1, 256, 256, 4, (9,), 7)
    out, lse = fa.flash_streaming_fwd(q, k, v, g2, vs, 10)
    delta = fa.stream_delta(do, out)
    args = (k, v, g2, vs, 10)
    dq_full, dg2_full = fa.flash_streaming_dq(q, *args, do, lse, delta)
    full = fa.flash_streaming_dkv(q, *args, do, lse, delta)
    sums, mags, dqs = [0.0, 0.0], [0.0, 0.0], []
    dg2_sum = 0.0
    for i in range(4):
        sl = slice(64 * i, 64 * (i + 1))
        o_i, lse_i = fa.flash_streaming_fwd(q[:, sl], *args, 64 * i)
        assert torch.equal(o_i, out[:, sl]) and torch.equal(lse_i,
                                                            lse[:, :, sl])
        shard = (do[:, sl], lse_i, delta[:, :, sl].contiguous(), 64 * i)
        dq, dg2 = fa.flash_streaming_dq(q[:, sl], *args, *shard)
        parts = fa.flash_streaming_dkv(q[:, sl], *args, *shard)
        dqs.append(dq)
        dg2_sum = dg2_sum + dg2
        sums = [a + x.float() for a, x in zip(sums, parts)]
        mags = [a + x.float().abs() for a, x in zip(mags, parts)]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(dqs, 1), dq_full)
    for name, a, m, r, terms in zip(("dk", "dv"), sums, mags, full,
                                    _term_mags(q, k, v, do, g2, vs, lse,
                                               delta)):
        bound = 2.0 ** -8 * (m + r.float().abs()) + 2 * 256 * 2.0 ** -24 \
            * terms.float() + 1e-6
        assert bool(((a - r.float()).abs() <= bound).all()), name
    torch.testing.assert_close(dg2_sum, dg2_full, rtol=1e-4, atol=1e-4)


def _term_mags(q, k, v, do, g2, vs, lse, delta):
    """float64 scale |dS|ᵀ|Q| and Pᵀ|dO|: the magnitudes of K6b's sums at
    q_offset 0, P from the saved lse."""
    dh = q.shape[3]
    q64, v64, do64 = (x.double() for x in (q, v, do))
    sc = fa._masked_scores(q, k, g2, vs, 10).double()
    p = torch.exp(sc - lse.double()[..., None])    # 0 where masked (-1e30)
    dp = torch.einsum("bshd,bthd->bhst", do64, v64)
    ds = p * (dp - delta.double()[..., None])
    return (dh ** -0.5 * torch.einsum("bhst,bshd->bthd", ds.abs(),
                                      q64.abs()),
            torch.einsum("bhst,bshd->bthd", p, do64.abs()))


def test_flash_streaming_regime_on_card(cuda, monkeypatch):
    """A differentiated call above MAX_SEQ_BWD (set low) runs K5 forward and
    K6a + K6b backward through the autograd.Function, and no K1 or K2."""
    monkeypatch.setattr(fa, "MAX_SEQ_BWD", 64)
    g = torch.Generator(device=cuda).manual_seed(8)
    mk = lambda *s: torch.randn(*s, device=cuda, generator=g)
    q, k, v = (mk(2, 130, 4, 128).to(torch.bfloat16).requires_grad_()
               for _ in range(3))
    ak, av = (mk(10, 4, 128).to(torch.bfloat16).requires_grad_()
              for _ in range(2))
    g1, g2 = mk(4).requires_grad_(), mk(4).requires_grad_()
    vs = torch.tensor([3, -1], device=cuda)
    names = ("flash_text_attention", "flash_text_attention_bwd",
             "flash_streaming_fwd", "flash_streaming_dq",
             "flash_streaming_dkv")
    before = [getattr(fa, n).launches for n in names]
    out = fa.flash_adapter_attention(q, k, v, ak, av, g1, g2, vs, 10)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    moved = [getattr(fa, n).launches - b for n, b in zip(names, before)]
    assert moved == [0, 0, 1, 1, 1]
    for x in (q, k, v, ak, av, g1, g2):
        assert bool(torch.isfinite(x.grad).all())


# --- K3, K7, K4: the int8 GEMMs of the quantized backbone -------------------

def _quant_inputs(cuda, m, k, n, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(m, k, device=cuda, generator=g)
    x[:, 1] *= 30.0                  # one large column: group scales differ
    x[m // 2] = 0.0                  # an all-zero row
    kq = torch.randint(-127, 128, (n, k), device=cuda, generator=g,
                       dtype=torch.int8)
    base = 1.0 / (127.0 * k ** 0.5)
    scale = (torch.rand(n, device=cuda, generator=g) + 0.5) * base
    sg = (torch.rand(k // 128, n, device=cuda, generator=g) + 0.5) * base
    dy = torch.randn(m, n, device=cuda, generator=g).to(torch.bfloat16)
    return x.to(torch.bfloat16), kq, scale, sg, dy


def _bits(t):
    return torch.where(t == 0, torch.zeros_like(t), t).view(torch.int16)


@pytest.mark.parametrize("m,k,n", [(10, 256, 136), (37, 384, 256),
                                   (130, 1024, 520)])
def test_int8_fwd_and_grouped_bitwise_equal_plain(cuda, m, k, n):
    """K3 and K7 compute the plain versions' IEEE operations in the same
    order on exact integer dots: bit for bit equal (chip_smoke.py states
    why)."""
    x, kq, scale, sg, _ = _quant_inputs(cuda, m, k, n, 3)
    b3, b7 = qm.int8_fwd.launches, qm.grouped_matmul.launches
    out3 = qm.int8_fwd(x.view(1, m, k), kq, scale)
    out7 = qm.grouped_matmul(x, kq, sg)
    torch.cuda.synchronize()
    assert (qm.int8_fwd.launches, qm.grouped_matmul.launches) == (b3 + 1,
                                                                  b7 + 1)
    assert out3.shape == (1, m, n)
    assert torch.equal(_bits(out3[0]), _bits(qm.int8_fwd_ref(x, kq, scale)))
    assert torch.equal(_bits(out7), _bits(qm.grouped_matmul_ref(x, kq, sg)))
    assert bool((out3[0][m // 2] == 0).all())


@pytest.mark.parametrize("m,k,n", [(10, 256, 136), (130, 1024, 520)])
def test_quant_dx_matches_plain(cuda, monkeypatch, m, k, n):
    """K4 against a cuBLAS bf16 product on the dequantized weight: the two
    f32 sums differ by at most N·2^-24·(|g|·|W|ᵀ), and each rounds to bf16
    once (2^-7 of the value covers both roundings)."""
    _, kq, _, sg, dy = _quant_inputs(cuda, m, k, n, 4)
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    before = qm.quant_dx.launches
    dx = qm.quant_dx(dy, kq, sg)
    torch.cuda.synchronize()
    assert qm.quant_dx.launches == before + 1
    ref = qm.quant_dx_ref(dy, kq, sg).double()
    w = qm.dequant(kq, sg, torch.bfloat16).double()
    bound = 2.0 ** -7 * ref.abs() + n * 2.0 ** -24 * (dy.double().abs()
                                                       @ w.abs())
    assert bool(((dx.double() - ref).abs() <= bound).all())


def test_quant_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, kq, scale, sg, dy = _quant_inputs(cuda, 16, 256, 128, 5)
    with pytest.raises(TypeError):
        qm.int8_fwd(x.float(), kq, scale)
    with pytest.raises(ValueError):
        qm.int8_fwd(x[:, :200], kq[:, :200], scale)       # not contiguous
    with pytest.raises(ValueError):
        qm.grouped_matmul(x[:, :144].contiguous(), kq[:, :144].contiguous(),
                          sg[:1])                         # K % 128 != 0
    with pytest.raises(ValueError):
        qm.quant_dx(dy, kq, scale)                        # per-channel scale


def test_quant_autograd_functions_on_card(cuda):
    """Int8Matmul (K3 forward, exact bf16 dx) and Int8MatmulGrouped (K7
    forward, K4 backward): one launch each, finite grads."""
    from flipped_tpu_torch.model import int8 as q8

    x, kq, scale, sg, dy = _quant_inputs(cuda, 40, 256, 128, 6)
    counts = lambda: (qm.int8_fwd.launches, qm.grouped_matmul.launches,
                      qm.quant_dx.launches)
    before = counts()
    xa, xb = (x.detach().requires_grad_() for _ in range(2))
    q8.int8_matmul(xa, kq, scale).backward(dy)
    q8.int8_matmul_grouped(xb, kq, sg).backward(dy)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 1)
    w = qm.dequant(kq, scale, torch.bfloat16)
    assert torch.equal(xa.grad, dy @ w)
    assert bool(torch.isfinite(xb.grad).all())


# --- K8, K9, K10: the packed int4 GEMMs and the w8a8d dgrad -------------------

def _int4_inputs(cuda, m, k, n, seed):
    """x with a large column and a zero row, int4 codes (N, K) in [-8, 7]
    packed to (N/2, K), group scales (K/128, N), a cotangent (M, N)."""
    from flipped_tpu_torch.model.int4 import pack_int4

    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(m, k, device=cuda, generator=g)
    x[:, 1] *= 30.0
    x[m // 2] = 0.0
    codes = torch.randint(-8, 8, (n, k), device=cuda, generator=g,
                          dtype=torch.int8)
    sg = (torch.rand(k // 128, n, device=cuda, generator=g) + 0.5) \
        / (7.0 * k ** 0.5)
    dy = torch.randn(m, n, device=cuda, generator=g).to(torch.bfloat16)
    return x.to(torch.bfloat16), codes, pack_int4(codes), sg, dy


def _mma_bound(ref, a, w, terms):
    """chip_smoke.py's bound for bf16 tensor-core products against their
    plain versions: (2^-7·|plain| + terms·2^-24·(|a|·|w|ᵀ))·(1 + 2^-8)."""
    return (2.0 ** -7 * ref.double().abs()
            + terms * 2.0 ** -24 * (a.double().abs() @ w.double().abs().t())
            ) * (1 + 2.0 ** -8)


@pytest.mark.parametrize("m,k,n", [(10, 256, 256), (37, 384, 528),
                                   (130, 1024, 1040)])
def test_int4_matmul_matches_plain(cuda, m, k, n):
    """K8: the w4a8 branch bit for bit equal to its plain version (the same
    IEEE operations on exact integer dots), the weight-only branch within
    the bound of its f32 group sums."""
    x, codes, kq4, sg, _ = _int4_inputs(cuda, m, k, n, 7)
    before = qm.int4_matmul.launches
    out8 = qm.int4_matmul(x.view(1, m, k), kq4, sg, True)
    out4 = qm.int4_matmul(x, kq4, sg, False)
    torch.cuda.synchronize()
    assert qm.int4_matmul.launches == before + 2
    assert out8.shape == (1, m, n)
    assert torch.equal(_bits(out8[0]), _bits(qm.int4_matmul_ref(x, kq4, sg,
                                                                True)))
    ref = qm.int4_matmul_ref(x, kq4, sg, False)
    groups = k // 128
    w = (codes.double().view(n, groups, 128) * sg.t().double()[:, :, None]
         ).view(n, k)
    bound = _mma_bound(ref, x, w, k + 2 * groups)
    assert bool(((out4.double() - ref.double()).abs() <= bound).all())
    assert bool((out4[m // 2] == 0).all())


@pytest.mark.parametrize("m,k,n", [(10, 256, 256), (130, 1024, 1040)])
def test_int4_dx_matches_plain(cuda, monkeypatch, m, k, n):
    """K9 against its plain version (a cuBLAS bf16 product on the weight
    dequantized beforehand): within the bound of two f32 sums of N products,
    as K4."""
    _, codes, kq4, sg, dy = _int4_inputs(cuda, m, k, n, 8)
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    before = qm.int4_dx.launches
    dx = qm.int4_dx(dy, kq4, sg)
    torch.cuda.synchronize()
    assert qm.int4_dx.launches == before + 1
    ref = qm.int4_dx_ref(dy, kq4, sg)
    w = qm.dequant(codes, sg, torch.bfloat16)
    bound = _mma_bound(ref, dy, w.t(), n)
    assert bool(((dx.double() - ref.double()).abs() <= bound).all())


@pytest.mark.parametrize("shape,k", [((10, 256), 256), ((2, 37, 528), 384),
                                     ((130, 1040), 1024)])
def test_int8_dgrad_bitwise_equal_plain(cuda, shape, k):
    """K10 computes its plain version's IEEE operations, hash and exact
    int8 dot: bit for bit equal, on 2-D and 3-D cotangents."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    n = shape[-1]
    dy = torch.randn(*shape, device=cuda, generator=gen)
    dy[..., 3] *= 30.0
    dy = dy.to(torch.bfloat16)
    kq = torch.randint(-127, 128, (n, k), device=cuda, generator=gen,
                       dtype=torch.int8)
    scale = (torch.rand(n, device=cuda, generator=gen) + 0.5) \
        / (127.0 * k ** 0.5)
    before = qm.int8_dgrad.launches
    dx = qm.int8_dgrad(dy, kq, scale, shape[-2])
    torch.cuda.synchronize()
    assert qm.int8_dgrad.launches == before + 1
    assert dx.shape == (*shape[:-1], k)
    assert torch.equal(_bits(dx), _bits(qm.int8_dgrad_ref(dy, kq, scale,
                                                          shape[-2])))


def test_int4_and_dgrad_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x, codes, kq4, sg, dy = _int4_inputs(cuda, 16, 256, 256, 10)
    with pytest.raises(TypeError):
        qm.int4_matmul(x.float(), kq4, sg, True)
    with pytest.raises(ValueError):
        qm.int4_matmul(x, kq4, sg[:, :128].contiguous(), True)  # not (G, N)
    with pytest.raises(ValueError):
        qm.int4_dx(dy[:, :200], kq4, sg)                      # not contiguous
    kq = torch.zeros(256, 256, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        qm.int8_dgrad(dy, kq, torch.zeros(256, device=cuda), 0)   # s_mod 0


def test_int4_and_dgrad_autograd_functions_on_card(cuda):
    """Int4Matmul (K8 weight-only, K9), Int4MatmulGrouped (K8 w4a8, K9) and
    Int8MatmulDgrad (K3, K10): one launch of each kernel a direction, the
    dx of the first two equal to K9 on the same cotangent, finite grads."""
    from flipped_tpu_torch.model import int4 as t4
    from flipped_tpu_torch.model import int8 as q8

    x, codes, kq4, sg, dy = _int4_inputs(cuda, 40, 256, 256, 11)
    kq = torch.randint(-127, 128, (256, 256), device=cuda, dtype=torch.int8)
    scale = torch.full((256,), 1e-3, device=cuda)
    counts = lambda: (qm.int4_matmul.launches, qm.int4_dx.launches,
                      qm.int8_fwd.launches, qm.int8_dgrad.launches)
    before = counts()
    xa, xb, xc = (x.detach().requires_grad_() for _ in range(3))
    t4.int4_matmul(xa, kq4, sg).backward(dy)
    t4.int4_matmul_grouped(xb, kq4, sg).backward(dy)
    q8.int8_matmul_dgrad(xc.view(2, 20, 256), kq, scale).backward(
        dy.view(2, 20, 256))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (2, 2, 1, 1)
    dx9 = qm.int4_dx(dy, kq4, sg)
    assert torch.equal(xa.grad, dx9) and torch.equal(xb.grad, dx9)
    assert torch.equal(xc.grad, qm.int8_dgrad_ref(dy.view(2, 20, 256), kq,
                                                  scale, 20).view(40, 256))


# --- edge tiles of the wgmma kernels (K8 weight-only, K10) --------------------
# K8 weight-only tiles 64 x rows by 128 packed rows (64 a warpgroup) over
# 64-deep stages, K10's GEMM 256 rows by 128 output columns over 128-deep
# stages: these shapes end every tile part-way (ragged M; N/2 of 56, 72 and
# 200, below, across and past a warpgroup's 64 packed rows, the nearest to
# 60 and 68 that K8's N % 16 == 0 admits; ragged K and contraction for K10)
# and run one group, several stages a group, and 86 groups.
EDGE_M = (1, 65, 320, 1000)


@pytest.mark.parametrize("m", EDGE_M)
@pytest.mark.parametrize("n,k,group", [(112, 128, 128), (144, 128, 128),
                                       (400, 512, 256), (112, 11008, 128),
                                       (144, 11008, 128)])
def test_int4_weight_only_edge_tiles(cuda, m, n, k, group):
    x, codes, kq4, sg, _ = _int4_inputs(cuda, m, k, n, 12)
    if m == 1:                        # _int4_inputs zeroes row m // 2
        x = torch.randn(1, k, device=cuda).to(torch.bfloat16)
    groups = k // group
    sg = sg[:groups].contiguous()
    before = qm.int4_matmul.launches
    out = qm.int4_matmul(x, kq4, sg, False)
    torch.cuda.synchronize()
    assert qm.int4_matmul.launches == before + 1
    ref = qm.int4_matmul_ref(x, kq4, sg, False)
    w = (codes.double().view(n, groups, group) * sg.t().double()[:, :, None]
         ).view(n, k)
    bound = _mma_bound(ref, x, w, k + 2 * groups)
    assert bool(torch.isfinite(out.float()).all())
    assert bool(((out.double() - ref.double()).abs() <= bound).all())


@pytest.mark.parametrize("m", EDGE_M)
@pytest.mark.parametrize("n,k", [(128, 144), (11008, 144), (272, 11008)])
def test_int8_dgrad_edge_tiles_bitwise(cuda, m, n, k):
    """K10 on a 2-D cotangent (s_mod = M) and on the same rows as 3-D with
    s_mod != M: bit for bit equal to its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    dy = torch.randn(m, n, device=cuda, generator=gen)
    dy[:, 5] *= 30.0
    dy = dy.to(torch.bfloat16)
    kq = torch.randint(-127, 128, (n, k), device=cuda, generator=gen,
                       dtype=torch.int8)
    scale = (torch.rand(n, device=cuda, generator=gen) + 0.5) \
        / (127.0 * k ** 0.5)
    shape3 = (2, m // 2, n) if m % 2 == 0 else (m, 1, n)
    for g in (dy, dy.view(shape3)):
        s_mod = g.shape[-2]
        before = qm.int8_dgrad.launches
        dx = qm.int8_dgrad(g, kq, scale, s_mod)
        torch.cuda.synchronize()
        assert qm.int8_dgrad.launches == before + 1
        assert dx.shape == (*g.shape[:-1], k)
        assert torch.equal(_bits(dx),
                           _bits(qm.int8_dgrad_ref(g, kq, scale, s_mod)))


def test_int8_dgrad_scale_not_16_byte_aligned(cuda):
    """The quantize pass loads scale 16 bytes at a time where it is 16-byte
    aligned and element by element where it is not: both bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    m, n, k = 65, 272, 144
    dy = torch.randn(m, n, device=cuda, generator=gen).to(torch.bfloat16)
    kq = torch.randint(-127, 128, (n, k), device=cuda, generator=gen,
                       dtype=torch.int8)
    base = (torch.rand(n + 1, device=cuda, generator=gen) + 0.5) / 2000.0
    scale = base[1:]                  # contiguous, 4 bytes past alignment
    assert scale.data_ptr() % 16 != 0
    dx = qm.int8_dgrad(dy, kq, scale, m)
    torch.cuda.synchronize()
    assert torch.equal(_bits(dx), _bits(qm.int8_dgrad_ref(dy, kq, scale, m)))


# --- edge tiles of K4 and K9 (dx_wgmma.cuh) ----------------------------------
# A block is 256 g rows by 128 dx columns over 64-deep contraction stages
# (K9: 64 packed rows a stage, their low nibbles, then their high ones):
# these shapes end a row tile part-way (M 65, 257, 1000), a K4 contraction N
# part-way through a stage (136, 400, 1000), a K9 N/2 too (56, 72, 200,
# 520), and take a dx width K of exactly one group (128; K9 also 256 as one
# group of 256). The bound is K4_REL's / K8_WO_REL's (chip_smoke.py).
DX_EDGE_M = (1, 65, 257, 1000)


@pytest.mark.parametrize("m", DX_EDGE_M)
@pytest.mark.parametrize("n,k", [(136, 128), (1000, 256), (400, 11008)])
def test_quant_dx_edge_tiles(cuda, monkeypatch, m, n, k):
    _, kq, _, sg, dy = _quant_inputs(cuda, m, k, n, 15)
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    before = qm.quant_dx.launches
    dx = qm.quant_dx(dy, kq, sg)
    torch.cuda.synchronize()
    assert qm.quant_dx.launches == before + 1
    ref = qm.quant_dx_ref(dy, kq, sg)
    bound = _mma_bound(ref, dy, qm.dequant(kq, sg, torch.bfloat16).t(), n)
    assert bool(torch.isfinite(dx.float()).all())
    assert bool(((dx.double() - ref.double()).abs() <= bound).all())


@pytest.mark.parametrize("m", DX_EDGE_M)
@pytest.mark.parametrize("n,k,group", [(112, 128, 128), (400, 256, 256),
                                       (144, 512, 128), (1040, 11008, 128)])
def test_int4_dx_edge_tiles(cuda, monkeypatch, m, n, k, group):
    _, codes, kq4, sg, dy = _int4_inputs(cuda, m, k, n, 16)
    sg = sg[:k // group].contiguous()
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    before = qm.int4_dx.launches
    dx = qm.int4_dx(dy, kq4, sg)
    torch.cuda.synchronize()
    assert qm.int4_dx.launches == before + 1
    ref = qm.int4_dx_ref(dy, kq4, sg)
    bound = _mma_bound(ref, dy, qm.dequant(codes, sg, torch.bfloat16).t(),
                       n)
    assert bool(torch.isfinite(dx.float()).all())
    assert bool(((dx.double() - ref.double()).abs() <= bound).all())


def test_dx_wrappers_refuse_unaligned_scales(cuda):
    """K4 and K9 bring each stage's scales into shared memory by TMA, which
    needs a 16-byte aligned source: the wrappers refuse other views."""
    _, kq, _, sg, dy = _quant_inputs(cuda, 16, 256, 128, 17)
    flat = torch.empty(sg.numel() + 1, device=cuda)
    off = flat[1:].view(sg.shape)
    off.copy_(sg)
    assert off.data_ptr() % 16 != 0
    with pytest.raises(ValueError):
        qm.quant_dx(dy, kq, off)
    _, _, kq4, sg4, dy4 = _int4_inputs(cuda, 16, 256, 256, 17)
    flat = torch.empty(sg4.numel() + 1, device=cuda)
    off4 = flat[1:].view(sg4.shape)
    off4.copy_(sg4)
    with pytest.raises(ValueError):
        qm.int4_dx(dy4, kq4, off4)


# --- edge tiles of K3 (int8_fwd.cu) and K1 (flash_fwd_wgmma.cuh) -------------
# K3 tiles 128 rows by 256 columns over 128-deep stages: M of one row and
# past a 128- and a 256-row tile, N short of and past a 256-column tile, a
# contraction of one 16-byte step and contractions ending part-way through
# a stage, and one past the 12288 columns the quantize pass keeps in
# registers (it reads the rest of the row twice). Bit for bit its plain
# version (chip_smoke.py states why).
K3_EDGE_M = (1, 129, 257)


@pytest.mark.parametrize("m", K3_EDGE_M)
@pytest.mark.parametrize("n,k", [(136, 16), (264, 144), (136, 400),
                                 (264, 4096), (136, 12304)])
def test_int8_fwd_edge_tiles_bitwise(cuda, m, n, k):
    x, kq, scale, _, _ = _quant_inputs(cuda, m, k, n, 18)
    if m == 1:                        # _quant_inputs zeroes row m // 2
        x = torch.randn(1, k, device=cuda).to(torch.bfloat16)
    before = qm.int8_fwd.launches
    out = qm.int8_fwd(x, kq, scale)
    torch.cuda.synchronize()
    assert qm.int8_fwd.launches == before + 1
    assert torch.equal(_bits(out), _bits(qm.int8_fwd_ref(x, kq, scale)))


def _k1_hold(q, k, v, g2, video_start, out, lse):
    """K1 against its plain version within K1_REL's bound (chip_smoke.py)
    and its lse within 1e-5 relative, 1e-4 absolute of the plain one; past
    S 650 within K5's bounds instead (chip_smoke.py STREAM_CASES), which add
    the f32 sums of S terms and the score errors, the lse against the
    float64 log-sum-exp."""
    from flipped_tpu_torch.model.attention import video_block_bias

    s, dh = q.shape[1], q.shape[3]
    ref, ref_lse = fa.flash_text_attention_ref(q, k, v, g2, video_start, 10)
    mag, _ = fa.flash_text_attention_ref(q, k, v.abs(), g2, video_start, 10)
    mag = mag.double()
    bound = 2.0 ** -7 * (mag + ref.double().abs()) + 2.0 ** -14
    if s <= 650:
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    else:
        causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        bb = torch.einsum("bshd,bthd->bhst", q.double().abs(),
                          k.double().abs()) / dh ** 0.5
        max_b = bb.masked_fill(~causal, 0).amax(-1)          # (B, H, S)
        del bb
        sc = torch.einsum("bshd,bthd->bhst", q.double(), k.double()) \
            / dh ** 0.5 + video_block_bias(video_start, s, 10, g2.double())
        lse64 = torch.logsumexp(sc.masked_fill(~causal, float("-inf")), -1)
        del sc
        lse_bound = (2.0 ** -16 * max_b + (s + s / 64 + 64) * 2.0 ** -24
                     + 2.0 ** -23 * lse64.abs())
        assert bool(((lse.double() - lse64).abs() <= lse_bound).all())
        bound = bound + (2 * (s + s / 64) * 2.0 ** -24
                         + 2.0 ** -16 * max_b.transpose(1, 2)[..., None]) \
            * mag
    assert bool(torch.isfinite(out).all())
    assert bool(((out.double() - ref.double()).abs() <= bound).all())


@pytest.mark.parametrize("s", [1, 64, 65, 127, 129, 255, 2049, 4096])
@pytest.mark.parametrize("strided", [False, True])
def test_flash_text_fwd_lengths_and_strided_views(cuda, s, strided):
    """K1 at the edges of its 128-row q and key tiles and up to
    MAX_SEQ_FWD, on (B, S, H, Dh) tensors and on the three slices of one
    (B, S, 3, H, Dh) tensor."""
    b, h = 2, 2
    g = torch.Generator(device=cuda).manual_seed(19)
    if strided:
        q, k, v = torch.randn(b, s, 3, h, 128, device=cuda, generator=g).to(
            torch.bfloat16).unbind(2)
    else:
        q, k, v = (torch.randn(b, s, h, 128, device=cuda, generator=g)
                   .to(torch.bfloat16) for _ in range(3))
    g2 = torch.randn(h, device=cuda, generator=g)
    video_start = torch.tensor([min(5, s - 1), -1], dtype=torch.int32,
                               device=cuda)
    before = fa.flash_text_attention.launches
    out, lse = fa.flash_text_attention(q, k, v, g2, video_start, 10)
    torch.cuda.synchronize()
    assert fa.flash_text_attention.launches == before + 1
    _k1_hold(q, k, v, g2, video_start, out, lse)


# --- edge tiles of K7 (int8_grouped_fwd.cu) and K8 w4a8 (int4_fwd.cu) -------
# K7 tiles 128 rows by 128 columns over 128-deep stages, one group a stage,
# its accumulators alternating between groups; K8's w4a8 branch tiles 128 x
# rows by 64 packed rows (output columns j0 + p and N/2 + j0 + p). M of one
# row, short of and past a 64-row warpgroup (63, 65), past a 128- and a
# 256-row tile (129, 257); N past and short of a tile (K7 N 136 and 264;
# K8 N/2 72 and 200); a contraction of one group (128), an odd group count
# (1152: 9 groups; K8 at group 256: 2304) and 86 groups (11008), whose
# even count takes the kernels' other instantiation. Bit for bit their
# plain versions (chip_smoke.py states why).
GROUPED_EDGE_M = (1, 63, 65, 129, 257)


def _edge_rows(x, m):
    """x with a random first row where `_quant_inputs` / `_grouped_int4`
    zeroed the only one."""
    if m == 1:
        x = torch.randn(1, x.shape[1], device=x.device).to(torch.bfloat16)
    return x


@pytest.mark.parametrize("m", GROUPED_EDGE_M)
@pytest.mark.parametrize("n,k", [(136, 128), (264, 1152), (136, 11008)])
def test_grouped_fwd_edge_tiles_bitwise(cuda, m, n, k):
    x, kq, _, sg, _ = _quant_inputs(cuda, m, k, n, 21)
    x = _edge_rows(x, m)
    before = qm.grouped_matmul.launches
    out = qm.grouped_matmul(x, kq, sg)
    torch.cuda.synchronize()
    assert qm.grouped_matmul.launches == before + 1
    assert torch.equal(_bits(out), _bits(qm.grouped_matmul_ref(x, kq, sg)))


def _grouped_int4(cuda, m, k, n, group, seed):
    """x as `_int4_inputs`, int4 codes packed to (N/2, K), scales (K /
    group, N)."""
    from flipped_tpu_torch.model.int4 import pack_int4

    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(m, k, device=cuda, generator=g)
    x[:, 1] *= 30.0
    x[m // 2] = 0.0
    codes = torch.randint(-8, 8, (n, k), device=cuda, generator=g,
                          dtype=torch.int8)
    sg = (torch.rand(k // group, n, device=cuda, generator=g) + 0.5) \
        / (7.0 * k ** 0.5)
    return x.to(torch.bfloat16), pack_int4(codes), sg


@pytest.mark.parametrize("m", GROUPED_EDGE_M)
@pytest.mark.parametrize("nh,k,group", [(72, 128, 128), (200, 1152, 128),
                                        (72, 11008, 128), (200, 2304, 256)])
def test_int4_w4a8_edge_tiles_bitwise(cuda, m, nh, k, group):
    x, kq4, sg = _grouped_int4(cuda, m, k, 2 * nh, group, 22)
    x = _edge_rows(x, m)
    before = qm.int4_matmul.launches
    out = qm.int4_matmul(x, kq4, sg, True)
    torch.cuda.synchronize()
    assert qm.int4_matmul.launches == before + 1
    assert torch.equal(_bits(out),
                       _bits(qm.int4_matmul_ref(x, kq4, sg, True)))


@pytest.mark.parametrize("m,k,group", [(65, 8192, 8192), (130, 16384, 8192)])
def test_int4_w4a8_wide_groups_bitwise(cuda, m, k, group):
    """Groups of 8192, 64 stages each (the fold once every 64 stages, the
    int32 dots up to 2^23), still bit for bit."""
    x, kq4, sg = _grouped_int4(cuda, m, k, 144, group, 23)
    out = qm.int4_matmul(x, kq4, sg, True)
    assert torch.equal(_bits(out),
                       _bits(qm.int4_matmul_ref(x, kq4, sg, True)))


def test_flash_stream_fwd_two_streams_at_once(cuda):
    """K5 launched on two streams at once, the two joined by events, at the
    long training shape: both outputs bit for bit one single-stream call's.
    The persistent grid takes its items from a counter; each stream has its
    own (model/kernels/flash_attention.py `_item_counter`), so neither
    launch takes the other's items and leaves rows unwritten."""
    q, k, v, _, g2, vs = _stream_inputs(cuda, 3, 4096, 4096, 32, (7, 3, -1),
                                        24)
    ref, ref_lse = fa.flash_streaming_fwd(q, k, v, g2, vs, 10)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for _ in range(3):
        start = torch.cuda.Event()
        start.record()
        outs = []
        for s in streams:
            s.wait_event(start)
            with torch.cuda.stream(s):
                outs.append(fa.flash_streaming_fwd(q, k, v, g2, vs, 10))
        for s in streams:
            done = torch.cuda.Event()
            done.record(s)
            torch.cuda.current_stream().wait_event(done)
        torch.cuda.synchronize()
        for out, lse in outs:
            assert torch.equal(_bits(out), _bits(ref))
            assert torch.equal(lse, ref_lse)


def test_grouped_forwards_refuse_unaligned_scales(cuda):
    """K7 and K8's w4a8 branch bring each group's scales into shared memory
    by TMA, which needs a 16-byte aligned source: the wrappers refuse other
    views; K8's weight-only branch, which reads them directly, takes them."""
    x, kq, _, sg, _ = _quant_inputs(cuda, 16, 256, 128, 25)
    flat = torch.empty(sg.numel() + 1, device=cuda)
    off = flat[1:].view(sg.shape)
    off.copy_(sg)
    assert off.data_ptr() % 16 != 0
    with pytest.raises(ValueError):
        qm.grouped_matmul(x, kq, off)
    x4, _, kq4, sg4, _ = _int4_inputs(cuda, 16, 256, 256, 25)
    flat = torch.empty(sg4.numel() + 1, device=cuda)
    off4 = flat[1:].view(sg4.shape)
    off4.copy_(sg4)
    with pytest.raises(ValueError):
        qm.int4_matmul(x4, kq4, off4, True)
    out = qm.int4_matmul(x4, kq4, off4, False)
    assert torch.equal(out, qm.int4_matmul(x4, kq4, sg4, False))


@pytest.mark.parametrize("bits,group,outliers", [(8, 0, 0), (8, 128, 0),
                                                 (8, 128, 32), (4, 128, 0)])
def test_card_quantize_equals_cpu(cuda, bits, group, outliers):
    """quantize_kernel on the card gives the CPU's codes and scales bit for
    bit (the JAX arithmetic, tests/test_torch_ckpt.py), at w1's 7B shape."""
    torch.manual_seed(0)
    w = (torch.randn(11008, 4096) / 64).to(torch.bfloat16)
    cpu = quantize_kernel(w, group, outliers, bits)
    card = quantize_kernel(w.to(cuda), group, outliers, bits)
    assert set(card) == set(cpu)
    for leaf, t in cpu.items():
        assert torch.equal(card[leaf].cpu(), t), leaf


def test_card_rotation_within_bound_of_cpu(cuda):
    """The rotation fold of w1 at 7B on the card against the CPU's: the
    same butterfly, so bit for bit is expected; the bound held is the one
    tests/test_torch_ckpt.py holds the port to against JAX (at most 0.1%
    of the bf16 elements differ, each by one ulp). qav_rot is exactly
    symmetric."""
    torch.manual_seed(0)
    w = (torch.randn(11008, 4096) / 64).to(torch.bfloat16)
    gamma = (torch.rand(4096) + 0.5).to(torch.bfloat16)
    cpu = Rotation(4096).rotate(w, -1, gamma).to(torch.bfloat16)
    card = Rotation(4096, device=cuda).rotate(
        w.to(cuda), -1, gamma.to(cuda)).to(torch.bfloat16).cpu()
    diff = card != cpu
    assert float(diff.float().mean()) <= 1e-3
    mag = torch.maximum(card.abs(), cpu.abs()).float().clamp_min(2.0 ** -126)
    ulp = 2.0 ** (torch.floor(torch.log2(mag)) - 7)
    assert float(((card.float() - cpu.float()).abs() / ulp).max()) <= 1.0
    q = Rotation(4096, device=cuda).conjugate_diag(gamma.to(cuda))
    assert torch.equal(q, q.t())
