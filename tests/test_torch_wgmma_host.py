"""Host-side facts of the TMA + wgmma kernels (K8 weight-only, K10's GEMM,
K4 and K9) that hold without a card: the profiler files their kernels under
their classes, their main loops are wgmma fed by TMA through an mbarrier
ring, with no mma.sync left in them, and the integer tricks by which K4 and
K9 dequantize into wgmma's register operand are exact (the CUDA sources
themselves run only on the card: tests/test_torch_kernels_gpu.py)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from flipped_tpu_torch.cli import profile as tprofile
from flipped_tpu_torch.model.kernels import build

CSRC = Path(build.CSRC)


def _function(src: str, name: str) -> str:
    """The text of the first definition of `name` in src, to its closing
    brace at column 0."""
    start = re.search(rf"\b{name}\(", src).start()
    end = src.index("\n}\n", start)
    return src[start:end]


@pytest.mark.parametrize("name,cls", [
    ("void wgmma_int8::kn_gemm_row_kernel(CUtensorMap_st, CUtensorMap_st, "
     "float const*, __nv_bfloat16*, int, int, int)", "int8 dgrad (K10)"),
    ("void (anonymous namespace)::int8_dgrad_quantize_kernel("
     "__nv_bfloat16 const*, ...)", "int8 dgrad (K10)"),
    ("void (anonymous namespace)::int4_wo_kernel(CUtensorMap_st, ...)",
     "int4 GEMM (K8)"),
    ("void (anonymous namespace)::quant_dx_kernel(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, int, int, int, int)",
     "quant dx (K4)"),
    ("void (anonymous namespace)::int4_dx_kernel(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, int, int, int, int)",
     "int4 dx (K9)")])
def test_profile_classes_the_wgmma_kernels(name, cls):
    assert tprofile.kernel_class(name) == cls


@pytest.mark.parametrize("source,loop,wgmma", [
    ("int4_fwd.cu", "consume", "wgmma_m64n128k16_bf16_rs"),
    ("wgmma_int8.cuh", "consume", "wgmma_m64n128k32_s8_rs"),
    ("dx_wgmma.cuh", "consume", "wgmma_m64n256k16_bf16_rs")])
def test_main_loops_are_tma_fed_wgmma(source, loop, wgmma):
    src = (CSRC / source).read_text()
    body = _function(src, loop)
    assert wgmma in body and "mbar_wait(&full" in body
    assert "mma_16816" not in body and "mma_s8_16832" not in body
    assert "tma_load_2d" in src and "regs_alloc<232>" in src
    common = (CSRC / "hopper_common.cuh").read_text()
    assert "cp.async.bulk.tensor.2d" in common
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in common
    assert "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8" in common
    assert "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16" in common


def test_dgrad_quantize_pass_loads_16_bytes():
    src = (CSRC / "int8_dgrad.cu").read_text()
    body = _function(src, "scaled8")
    assert "uint4" in body and "load_scale8" in body
    assert "float4" in _function(src, "load_scale8")


@pytest.mark.parametrize("source,packed", [("quant_dx.cu", "false"),
                                           ("int4_dx.cu", "true")])
def test_dx_kernels_run_the_shared_wgmma_body(source, packed):
    """K4 and K9 are dx_wgmma.cuh's body, and no mma.sync tile is left."""
    src = (CSRC / source).read_text()
    assert '#include "dx_wgmma.cuh"' in src
    assert f"dxw::dx_body<{packed}>" in src
    assert f"dxw::launch<{packed}>" in src
    assert not (CSRC / "dx_common.cuh").exists()
    for text in (src, (CSRC / "dx_wgmma.cuh").read_text()):
        assert "mma_16816" not in text and "mma.sync" not in text


def _f32_bits(u):
    return np.asarray(u, dtype=np.uint32).view(np.float32)


def _bf16(bits):
    """bf16 values from their 16-bit patterns, as float32."""
    return (np.asarray(bits, dtype=np.uint32) << 16).view(np.float32)


def test_k4_code_conversion_is_exact():
    """dx_wgmma.cuh's biased_code_f32: the byte c + 128 of each int8 code c
    (the ^ 0x80 of its bits) under 0x4B000000 is the float 2^23 + c + 128,
    and subtracting 2^23 + 128 leaves float(c), which bf16 holds exactly."""
    c = np.arange(-128, 128, dtype=np.int32)
    biased = (c.astype(np.int8).view(np.uint8) ^ 0x80).astype(np.uint32)
    f = _f32_bits(0x4B000000 | biased) - np.float32(8388736.0)
    assert np.array_equal(f, c.astype(np.float32))
    assert np.array_equal(torch.from_numpy(f).to(torch.bfloat16).float()
                          .numpy(), f)


def test_k9_nibble_conversion_is_exact():
    """hopper_common.cuh's nibbles_bf16x2: the nibble x of a code c in
    [-8, 7], ^ 8, under 0x4300 is bf16(136 + c), and subtracting bf16(136)
    leaves c; the same for the high nibble after a shift by 4."""
    c = np.arange(-8, 8, dtype=np.int32)
    nib = (c & 0xF).astype(np.uint32)
    for byte, shift in ((nib, 0), (nib << 4, 4)):
        x = ((byte >> shift) & 0xF) ^ 0x8
        v = _bf16(0x4300 | x) - _bf16(0x4308)
        assert np.array_equal(v, c.astype(np.float32))


def test_dx_dequantize_is_one_bf16_product():
    """W = bf16(bf16(code) * bf16(scale)): a bf16 multiply of the two
    (exact product, one rounding, as mul.bf16x2 does) gives the plain
    version's weight bit for bit, the f32 scale rounded to bf16 first."""
    from flipped_tpu_torch.model.kernels import quant_matmul as qm

    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(-127, 128, (64, 256),
                                          dtype=np.int8))
    sg = torch.from_numpy(((rng.random((2, 64)) + 0.5) / (127 * 16))
                          .astype(np.float32))
    ref = qm.dequant(codes, sg, torch.bfloat16)
    exact = (codes.double().view(64, 2, 128)
             * sg.to(torch.bfloat16).double().t()[:, :, None]).view(64, 256)
    assert torch.equal(ref, exact.to(torch.bfloat16))
