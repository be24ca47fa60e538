"""K1 (flash_text_fwd): the plain version against the JAX package, the
wrapper's routing, its input checks, and the build's failure mode.

The CUDA kernel itself runs only on the card: tests/test_torch_kernels_gpu.py
(marked `gpu`) and chip_smoke.py hold it against the plain version there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flipped_tpu.model.attention import adapter_gated_attention
from flipped_tpu.model.pallas.flash_attention import flash_text_attention as jflash
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
