"""The hand-written CUDA kernels on the card, against their plain versions.

Marked `gpu`: each test skips without a CUDA device (the kernels have no CPU
mode). This file imports torch and the port only, so it also runs on a
machine without jax:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q
"""
import pytest
import torch

from flipped_tpu_torch.model.kernels import flash_attention as fa

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


@pytest.mark.parametrize("shape,vs", [((2, 130, 4, 128), (-1, 5)),
                                      ((3, 37, 2, 128), (0, 5, -1))])
def test_flash_text_bwd_matches_plain(cuda, shape, vs):
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
    ref = fa.flash_text_attention_bwd_ref(q, k, v, g2, video_start, 10, do)
    # a flip of one bf16 ulp in P or dS moves a grad by 2^-7 of one term;
    # chip_smoke.py states the full bound, this is its coarse form
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        assert bool(torch.isfinite(x).all()), name
        tol = 2.0 ** -6 * float(r.float().abs().max())
        assert float((x.float() - r.float()).abs().max()) <= tol, name
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
