"""Host-side facts of the TMA + wgmma kernels (K8 weight-only, K10's GEMM)
that hold without a card: the profiler files K10's new GEMM kernel under
K10, and the main loops of both are wgmma fed by TMA through an mbarrier
ring, with no mma.sync left in them (the CUDA sources themselves run only
on the card: tests/test_torch_kernels_gpu.py)."""
import re
from pathlib import Path

import pytest

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
     "int4 GEMM (K8)")])
def test_profile_classes_the_wgmma_kernels(name, cls):
    assert tprofile.kernel_class(name) == cls


@pytest.mark.parametrize("source,loop,wgmma", [
    ("int4_fwd.cu", "consume", "wgmma_m64n128k16_bf16_rs"),
    ("wgmma_int8.cuh", "consume", "wgmma_m64n128k32_s8_rs")])
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


def test_dgrad_quantize_pass_loads_16_bytes():
    src = (CSRC / "int8_dgrad.cu").read_text()
    body = _function(src, "scaled8")
    assert "uint4" in body and "load_scale8" in body
    assert "float4" in _function(src, "load_scale8")
