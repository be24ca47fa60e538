"""K1 (flash_text_fwd) and K2 (flash_text_bwd): the plain versions against
the JAX package, the autograd.Function's grads, the wrappers' routing,
their input checks, and the build's failure mode.

The CUDA kernel itself runs only on the card: tests/test_torch_kernels_gpu.py
(marked `gpu`) and chip_smoke.py hold it against the plain version there.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flipped_tpu.model.attention import adapter_gated_attention
from flipped_tpu.model.pallas.flash_attention import flash_text_attention as jflash
from flipped_tpu.model.pallas.flash_attention import \
    flash_text_attention_bwd as jflash_bwd
from flipped_tpu_torch.model.kernels import build as kbuild
from flipped_tpu_torch.model.kernels import flash_attention as fa

# Both sides take f32 scores from the same bf16 operands, an f32 softmax,
# P rounded to bf16 and an f32 value product, then round to bf16; only the
# f32 summation order differs, which can move the result by one bf16 ulp
# (2^-8 relative, to either side of the rounding boundary).
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -12


def _case(b, s, h, dh, seed):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, s, h, dh).astype(np.float32) for _ in range(3))
    return q, k, v, rs.randn(h).astype(np.float32)


@pytest.mark.parametrize("s", [37, 130])
def test_plain_matches_pallas_interpret_bf16(s):
    q, k, v, g2 = _case(3, s, 2, 16, seed=s)
    vs = np.array([-1, 0, 5], np.int32)
    ref = jflash(*(jnp.array(x, jnp.bfloat16) for x in (q, k, v)),
                 jnp.array(g2), jnp.array(vs), 10, interpret=True)
    out, _ = fa.flash_text_attention_ref(
        *(torch.tensor(x).to(torch.bfloat16) for x in (q, k, v)),
        torch.tensor(g2), torch.tensor(vs), 10)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("vs", [[4, 7], [-1, 0]])
def test_plain_f32_matches_einsum_with_gate1_zero(vs):
    """With gate1 = 0 the adapter segment vanishes, so the JAX einsum
    attention is the text segment alone."""
    q, k, v, g2 = _case(2, 24, 4, 8, seed=3)
    rs = np.random.RandomState(4)
    ak, av = (rs.randn(5, 4, 8).astype(np.float32) for _ in range(2))
    ref = adapter_gated_attention(
        *map(jnp.array, (q, k, v, ak, av)), jnp.zeros(4), jnp.array(g2),
        jnp.array(vs, jnp.int32), 3)
    out, _ = fa.flash_text_attention_ref(
        *map(torch.tensor, (q, k, v, g2)), torch.tensor(vs), 3)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.reshape(2, 24, 32).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_plain_lse_matches_float64():
    q, k, v, g2 = _case(2, 19, 3, 8, seed=5)
    vs = torch.tensor([2, -1])
    _, lse = fa.flash_text_attention_ref(*map(torch.tensor, (q, k, v, g2)),
                                         vs, 4)
    q64, k64 = (torch.tensor(x, dtype=torch.float64) for x in (q, k))
    sc = torch.einsum("bshd,bthd->bhst", q64, k64) / np.sqrt(8)
    # example 0: video frames at columns 2..5, gate2 on rows ≥ 6
    sc[0, :, 6:, 2:6] += torch.tensor(g2, dtype=torch.float64)[:, None, None]
    sc = sc.masked_fill(~torch.ones(19, 19, dtype=torch.bool).tril(), -np.inf)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(sc, -1).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_cpu_tensor_takes_plain_path_without_launch():
    q, k, v, g2 = _case(1, 10, 2, 8, seed=6)
    args = (*map(torch.tensor, (q, k, v, g2)), torch.tensor([1], dtype=torch.int32))
    before = fa.flash_text_attention.launches
    out, lse = fa.flash_text_attention(*args, 3)
    ref_out, ref_lse = fa.flash_text_attention_ref(*args, 3)
    assert fa.flash_text_attention.launches == before
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)


def _cuda_checkable(dtype=torch.bfloat16, dh=128, b=2, s=5, h=3):
    q = torch.zeros(b, s, h, dh, dtype=dtype)
    return (q, q.clone(), q.clone(), torch.zeros(h),
            torch.zeros(b, dtype=torch.int32))


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "gate2", "video_start",
                                 "layout", "rank"])
def test_cuda_input_checks_reject(bad):
    q, k, v, g2, vs = _cuda_checkable()
    if bad == "dtype":
        q, k, v = (x.float() for x in (q, k, v))
    elif bad == "head_dim":
        q, k, v, g2, vs = _cuda_checkable(dh=64)
    elif bad == "rank":
        q, k, v = (x[0] for x in (q, k, v))
    elif bad == "gate2":
        g2 = g2.double()
    elif bad == "video_start":
        vs = vs.long()
    else:
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        fa._check_cuda_inputs(q, k, v, g2, vs)


def test_cuda_input_checks_accept_eval_shapes():
    fa._check_cuda_inputs(*_cuda_checkable())
    fa._check_cuda_inputs(*_cuda_checkable(b=40, s=128, h=32))


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(kbuild.shutil, "which", lambda *a, **kw: None)
    with pytest.raises(kbuild.KernelBuildError, match="nvcc not found"):
        kbuild.build(force=True)


def test_sources_hash_is_stable():
    assert kbuild.source_hash() == kbuild.source_hash()
    assert (kbuild.CSRC / "flash_text_fwd.cu").exists()


# --- K2 (flash_text_bwd) ----------------------------------------------------

def _k2_case(b, s, h, dh, seed):
    q, k, v, g2 = _case(b, s, h, dh, seed)
    do = np.random.RandomState(seed + 100).randn(b, s, h, dh).astype(
        np.float32)
    return q, k, v, g2, do


def _bf16_tol(ref):
    """One bf16 ulp of a flip in P or dS moves a grad by at most 2^-7 of
    one of its terms: 2^-6 relative, with an absolute floor of 2^-7 of the
    largest grad for elements that cancel to near zero."""
    return dict(rtol=2.0 ** -6, atol=2.0 ** -7 * float(np.abs(ref).max()))


@pytest.mark.parametrize("s", [37, 64])
def test_bwd_plain_matches_pallas_interpret_bf16(s):
    """video_start -1, 0 and > 0 in one batch; S 37 is not a multiple of
    16, so the Pallas kernel pads and masks."""
    q, k, v, g2, do = _k2_case(3, s, 2, 16, seed=s)
    vs = np.array([-1, 0, 5], np.int32)
    ref = jflash_bwd(*(jnp.array(x, jnp.bfloat16) for x in (q, k, v)),
                     jnp.array(g2), jnp.array(vs), 10,
                     jnp.array(do, jnp.bfloat16), interpret=True)
    got = fa.flash_text_attention_bwd_ref(
        *(torch.tensor(x).to(torch.bfloat16) for x in (q, k, v)),
        torch.tensor(g2), torch.tensor(vs), 10,
        torch.tensor(do).to(torch.bfloat16))
    for name, g, r in zip(("dq", "dk", "dv"), got[:3], ref[:3]):
        assert g.dtype == torch.bfloat16
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), r, err_msg=name,
                                   **_bf16_tol(r))
    # dgate2 sums f32 dS on both sides: only the summation order differs
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("vs", [[4, 7], [-1, 0]])
def test_bwd_plain_f32_matches_jax_grad(vs):
    """At f32 the plain K2 is the exact gradient of the text segment: with
    gate1 = 0 the adapter segment adds nothing to dq, so jax.grad through
    the JAX einsum attention gives dq, dk, dv, dgate2 of the text alone."""
    q, k, v, g2, do = _k2_case(2, 24, 4, 8, seed=11)
    rs = np.random.RandomState(12)
    ak, av = (rs.randn(5, 4, 8).astype(np.float32) for _ in range(2))
    vsj = jnp.array(vs, jnp.int32)

    def loss(q_, k_, v_, g2_):
        out = adapter_gated_attention(q_, k_, v_, jnp.array(ak), jnp.array(av),
                                      jnp.zeros(4), g2_, vsj, 3)
        return jnp.sum(out * jnp.array(do).reshape(2, 24, 32))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.array, (q, k, v, g2)))
    got = fa.flash_text_attention_bwd_ref(
        *map(torch.tensor, (q, k, v, g2)), torch.tensor(vs), 3,
        torch.tensor(do))
    for name, g, r in zip(("dq", "dk", "dv", "dgate2"), got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def _attn_case(seed, dtype):
    rs = np.random.RandomState(seed)
    b, s, h, dh, al = 2, 21, 2, 16, 3
    arrs = dict(q=rs.randn(b, s, h, dh), k=rs.randn(b, s, h, dh),
                v=rs.randn(b, s, h, dh), ak=rs.randn(al, h, dh),
                av=rs.randn(al, h, dh), g1=rs.randn(h), g2=rs.randn(h))
    arrs = {n: x.astype(np.float32) for n, x in arrs.items()}
    w = rs.randn(b, s, h * dh).astype(np.float32)
    vs = np.array([4, -1], np.int32)
    return arrs, w, vs


GRAD_NAMES = ("q", "k", "v", "ak", "av", "g1", "g2")


def _torch_grads(fn, arrs, w, vs, dtype):
    leaves = [torch.tensor(arrs[n]).to(dtype if n not in ("g1", "g2")
                                       else torch.float32).requires_grad_()
              for n in GRAD_NAMES]
    out = fn(*leaves, torch.tensor(vs), 3)
    (out.float() * torch.tensor(w)).sum().backward()
    return [x.grad.float().numpy() for x in leaves]


def test_autograd_function_matches_jax_custom_vjp_bf16():
    """All seven grads of the port's autograd.Function (plain K1/K2 inside
    on the CPU) against jax.grad of the JAX custom VJP with its Pallas
    kernels in interpret mode, both in bf16."""
    import flipped_tpu.model.pallas.flash_attention as jfa

    arrs, w, vs = _attn_case(21, torch.bfloat16)
    vsj = jnp.array(vs)

    def loss(q_, k_, v_, ak_, av_, g1_, g2_):
        out = jfa._flash_adapter_attention(q_, k_, v_, ak_, av_, g1_, g2_,
                                           vsj, 3)
        return jnp.sum(out.astype(jnp.float32) * jnp.array(w))

    args = [jnp.array(arrs[n], jnp.float32 if n in ("g1", "g2")
                      else jnp.bfloat16) for n in GRAD_NAMES]
    old = jfa.INTERPRET
    jfa.INTERPRET = True
    try:
        ref = jax.grad(loss, argnums=tuple(range(7)))(*args)
    finally:
        jfa.INTERPRET = old
    got = _torch_grads(fa.flash_adapter_attention, arrs, w, vs,
                       torch.bfloat16)
    for name, g, r in zip(GRAD_NAMES, got, ref):
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(g, r, err_msg=name, **_bf16_tol(r))


def test_autograd_function_matches_plain_autograd_f32():
    """At f32 the Function's seven grads equal autograd through the port's
    all-plain `adapter_gated_attention` (same math, f32 summation order)."""
    from flipped_tpu_torch.model.attention import \
        adapter_gated_attention as plain

    arrs, w, vs = _attn_case(22, torch.float32)
    got = _torch_grads(fa.flash_adapter_attention, arrs, w, vs,
                       torch.float32)
    ref = _torch_grads(plain, arrs, w, vs, torch.float32)
    for name, g, r in zip(GRAD_NAMES, got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5, err_msg=name)


def test_bwd_cpu_tensor_takes_plain_path_without_launch():
    q, k, v, g2, do = (torch.tensor(x) for x in _k2_case(1, 10, 2, 8, 6))
    vs = torch.tensor([1], dtype=torch.int32)
    out, lse = fa.flash_text_attention(q, k, v, g2, vs, 3)
    before = fa.flash_text_attention_bwd.launches
    got = fa.flash_text_attention_bwd(q, k, v, g2, vs, 3, do, out, lse)
    ref = fa.flash_text_attention_bwd_ref(q, k, v, g2, vs, 3, do)
    assert fa.flash_text_attention_bwd.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_sources_include_k2():
    assert (kbuild.CSRC / "flash_text_bwd.cu").exists()
    assert (kbuild.CSRC / "flash_common.cuh").exists()
