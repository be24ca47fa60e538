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
