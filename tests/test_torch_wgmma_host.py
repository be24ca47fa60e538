"""Host-side facts of the TMA + wgmma kernels (K3, K1, K6a, K6b, K8
weight-only, K10's GEMM, K4 and K9) that hold without a card: the profiler
files their kernels under their classes, their main loops are wgmma fed by
TMA through an mbarrier ring, with no mma.sync left in them, and the
integer tricks by which K4 and K9 dequantize into wgmma's register operand
are exact (the CUDA sources themselves run only on the card:
tests/test_torch_kernels_gpu.py)."""
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
     "int4 dx (K9)"),
    ("void (anonymous namespace)::int8_fwd_wgmma_kernel(CUtensorMap_st, "
     "CUtensorMap_st, float const*, float const*, __nv_bfloat16*, int, int, "
     "int)", "int8 GEMM (K3/K7)"),
    ("void (anonymous namespace)::int8_fwd_quantize_kernel("
     "__nv_bfloat16 const*, signed char*, float*, int)", "int8 GEMM (K3/K7)"),
    ("void quant::int8_gemm_kernel(signed char const*, ...)",
     "int8 GEMM (K3/K7)"),
    ("void (anonymous namespace)::flash_text_fwd_kernel(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, flashw::Args)", "flash (K1/K2)"),
    ("void (anonymous namespace)::flash_stream_dq_kernel(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, flashbw::Args)",
     "flash stream (K5/K6)"),
    ("void (anonymous namespace)::flash_stream_dkv_kernel(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, flashbw::Args)",
     "flash stream (K5/K6)"),
    ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_TNN", "gemm")])
def test_profile_classes_the_wgmma_kernels(name, cls):
    assert tprofile.kernel_class(name) == cls


@pytest.mark.parametrize("source,loop,wgmma,tma,regs", [
    ("int4_fwd.cu", "consume", "wgmma_m64n128k16_bf16_rs", "tma_load_2d",
     "regs_alloc<232>"),
    ("wgmma_int8.cuh", "consume", "wgmma_m64n128k32_s8_rs", "tma_load_2d",
     "regs_alloc<232>"),
    ("dx_wgmma.cuh", "consume", "wgmma_m64n256k16_bf16_rs", "tma_load_2d",
     "regs_alloc<232>"),
    ("int8_fwd.cu", "consume", "wgmma_m64n256k32_s8_ss", "tma_load_2d",
     "regs_alloc<232>"),
    # K1: one producer warp, no setmaxnreg (288 threads fit 224 registers)
    ("flash_fwd_wgmma.cuh", "consume", "wgmma_m64n128k16_bf16_ss",
     "tma_load_4d", "__launch_bounds__")])
def test_main_loops_are_tma_fed_wgmma(source, loop, wgmma, tma, regs):
    src = (CSRC / source).read_text()
    body = _with_callees(src, loop)
    assert wgmma in body and "mbar_wait(&full" in _function(src, loop)
    assert "mma_16816" not in body and "mma_s8_16832" not in body
    assert tma in src and regs in src + _kernel_file_text(source)
    common = (CSRC / "hopper_common.cuh").read_text()
    assert "cp.async.bulk.tensor.2d" in common
    assert "cp.async.bulk.tensor.4d" in common
    for form in ("m64n128k16.f32.bf16.bf16", "m64n128k32.s32.s8.s8",
                 "m64n256k16.f32.bf16.bf16", "m64n256k32.s32.s8.s8"):
        assert "wgmma.mma_async.sync.aligned." + form in common


def _with_callees(src: str, name: str) -> str:
    """The text of `name` and of the device functions of src it calls."""
    body = _function(src, name)
    called = [f for f in re.findall(
        r"__device__ __forceinline__ \w+ (\w+)\(", src)
        if f != name and re.search(rf"\b{f}\b", body)]
    return body + "".join(_function(src, f) for f in called)


def _kernel_file_text(source: str) -> str:
    """The .cu files that include `source` (a header), joined."""
    return "".join(p.read_text() for p in sorted(CSRC.glob("*.cu"))
                   if f'#include "{source}"' in p.read_text())


def test_k1_products_are_wgmma():
    """K1's S = Q K^T is the SS bf16 form, O += P V the RS form with B
    transposed (V MN-major, its descriptor from desc_sw128_mn); K1 runs the
    new loop, K5 stays on flash_fwd.cuh's."""
    src = (CSRC / "flash_fwd_wgmma.cuh").read_text()
    assert "wgmma_m64n128k16_bf16_ss" in _function(src, "qk")
    pv = _function(src, "pv")
    assert "wgmma_m64n128k16_bf16_rs_tb" in pv and "desc_sw128_mn" in pv
    assert "mma.sync" not in src and "mma_16816" not in src
    assert '#include "flash_fwd_wgmma.cuh"' in (
        CSRC / "flash_text_fwd.cu").read_text()
    assert '#include "flash_fwd.cuh"' in (
        CSRC / "flash_stream_fwd.cu").read_text()
    common = (CSRC / "hopper_common.cuh").read_text()
    # the transposed-B form: scale-a 1, scale-b 1, tnspB 1
    assert "p, 1, 1, 1;" in _function(common, "wgmma_m64n128k16_bf16_rs_tb")


@pytest.mark.parametrize("loop,produce,forms", [
    ("dq_consume", "dq_produce", ("wgmma_m64n128k16_bf16_ss",)),
    ("dkv_consume", "dkv_produce", ("wgmma_m64n64k16_bf16_ss",))])
def test_k6_loops_are_tma_fed_wgmma(loop, produce, forms):
    """K6a's and K6b's loops (flash_bwd_wgmma.cuh) wait on the TMA ring's
    barriers and run their products as wgmma: S and dP (K6b: S^T and dP^T)
    SS through `ss_dh`, dq (K6b: dv and dk) RS with B MN-major through
    `rs_mn`; their producers load by 4-D TMA; no mma.sync is left, and the
    consumers take 232 registers from the producer warpgroup."""
    src = (CSRC / "flash_bwd_wgmma.cuh").read_text()
    body = _function(src, loop)
    assert "ss_dh(" in body and "rs_mn(" in body and "mbar_wait(" in body
    ss_forms = src[src.index("void ss("):src.index("void ss_dh(")]
    for form in forms:
        assert f"hopper::{form}_zero" in ss_forms and f"hopper::{form}(" \
            in ss_forms
    rs = _function(src, "rs_mn")
    assert "wgmma_m64n128k16_bf16_rs_tb" in rs and "desc_sw128_mn" in rs
    assert "tma_load_4d" in _function(src, produce)
    assert "mma_16816" not in src and "mma.sync" not in src
    assert "regs_alloc<232>" in src and "regs_dealloc<40>" in src
    common = (CSRC / "hopper_common.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in common


def test_k6_every_consumer_warp_releases_a_stage():
    """Every empty barrier of K6a and K6b counts the 8 consumer warps and is
    arrived on by lane 0 of each: with one arrival a warpgroup, a warp that
    trails its warpgroup through skipped work (no wgmma ties the four
    together) can see a stage refilled twice and wait forever on a parity
    that has come round again."""
    src = (CSRC / "flash_bwd_wgmma.cuh").read_text()
    assert "constexpr int CONSUMER_WARPS = 8;" in src
    inits = re.findall(r"mbar_init\((&?bar\.empty\w*(?:\[s\])?), (\w+)\)",
                       src)
    assert len(inits) == 4 and all(n == "CONSUMER_WARPS" for _, n in inits)
    for loop in ("dq_consume", "dkv_consume"):
        body = _function(src, loop)
        arrives = [m.start() for m in re.finditer(
            r"hopper::mbar_arrive\(&?bar\.empty", body)]
        assert len(arrives) >= 3
        for at in arrives:        # the condition that guards the arrival
            cond = body[body.rindex("if (", 0, at):at]
            assert "lane == 0" in cond and "leader" not in cond, cond


def test_k6_runs_the_new_loops_and_k2_keeps_flash_bwd():
    """flash_stream_bwd.cu (K6a, K6b) runs flash_bwd_wgmma.cuh's loops and
    no longer includes flash_bwd.cuh, which serves K2 (flash_text_bwd.cu)
    alone; the __global__ names keep "flash_stream", by which the profiler
    files them."""
    k6 = (CSRC / "flash_stream_bwd.cu").read_text()
    assert '#include "flash_bwd_wgmma.cuh"' in k6
    assert '#include "flash_bwd.cuh"' not in k6
    assert "flashbw::dq_body" in k6 and "flashbw::dkv_body" in k6
    assert "flash_stream_dq_kernel" in k6 and "flash_stream_dkv_kernel" in k6
    k2 = (CSRC / "flash_text_bwd.cu").read_text()
    assert '#include "flash_bwd.cuh"' in k2
    assert "flash::dq_tile" in k2 and "flash::dkdv_tile" in k2


def test_k3_epilogue_keeps_the_jax_order_and_no_mma_sync():
    """K3 rounds (float(d) * xs[m]) * scale[n] with two __fmul_rn, then once
    to bf16, as the plain version does; quant_common.cuh keeps no K3 path
    (per-channel epilogue, reciprocal-scale quantize)."""
    src = (CSRC / "int8_fwd.cu").read_text()
    assert "__fmul_rn(__fmul_rn(__int2float_rn(d[4 * i]), xs0), s0)" in src
    assert "mma_s8_16832" not in src and "quant::launch_gemm" not in src
    quantize = _function(src, "int8_fwd_quantize_kernel")
    assert "quant::INV127" in quantize and "__fdiv_rn" in _function(
        src, "store_codes8")
    common = (CSRC / "quant_common.cuh").read_text()
    assert "EPI_CHANNEL" not in common and "DIVIDE" not in common


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
