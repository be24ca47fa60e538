"""Host-side facts of the TMA + wgmma kernels (K3, K7, K1, K5, K2, K6a,
K6b, K8 both branches, K10's GEMM, K4 and K9) that hold without a card: the
profiler files their kernels under their classes, their main loops are
wgmma fed by TMA through an mbarrier ring, with no mma.sync left in any
source, the forward's item order groups heads, K7's and K8's group folds
keep the plain versions' order, the integer tricks by which K4, K8 and K9
feed wgmma's register operand and K7 and K8 convert their group dots are
exact, the shared-memory opt-in is made per device and the build log's
wgmma-serialisation warnings are found (the CUDA sources themselves run
only on the card: tests/test_torch_kernels_gpu.py)."""
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
    ("void (anonymous namespace)::int4_decode_kernel<32, true, true>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "__nv_bfloat16*, float*, int, int, int, int)", "int4 GEMM (K8)"),
    ("void (anonymous namespace)::int4_decode_kernel<64, false, false>("
     "CUtensorMap_st, ...)", "int4 GEMM (K8)"),
    ("void (anonymous namespace)::int4_decode_sum_kernel(float const*, "
     "__nv_bfloat16*, int, long long)", "int4 GEMM (K8)"),
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
    ("void (anonymous namespace)::int8_grouped_wgmma_kernel<true>("
     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, "
     "__nv_bfloat16*, int, int, int)", "int8 GEMM (K3/K7)"),
    ("void (anonymous namespace)::int8_decode_kernel<32, true>("
     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, "
     "__nv_bfloat16*, int, int, int)", "int8 GEMM (K3/K7)"),
    ("void (anonymous namespace)::int8_decode_quantize_kernel("
     "__nv_bfloat16 const*, signed char*, float*, int)", "int8 GEMM (K3/K7)"),
    ("void (anonymous namespace)::int8_grouped_decode_kernel<64, false>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "__nv_bfloat16*, int, int, int)", "int8 GEMM (K3/K7)"),
    ("void (anonymous namespace)::int4_w4a8_wgmma_kernel<false, true>("
     "CUtensorMap_st, CUtensorMap_st, float const*, float const*, "
     "__nv_bfloat16*, int, int, int, int)", "int4 GEMM (K8)"),
    ("void (anonymous namespace)::flash_text_fwd_kernel(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, flashw::Args)", "flash (K1/K2)"),
    ("void (anonymous namespace)::flash_stream_dq_kernel(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, flashbw::Args)",
     "flash stream (K5/K6)"),
    ("void (anonymous namespace)::flash_stream_dkv_kernel(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, flashbw::Args)",
     "flash stream (K5/K6)"),
    ("void (anonymous namespace)::flash_stream_fwd_kernel(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, flashw::Args)", "flash stream (K5/K6)"),
    ("void (anonymous namespace)::flash_text_dq_kernel(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, flashbw::Args)",
     "flash (K1/K2)"),
    ("void (anonymous namespace)::flash_text_dkv_kernel(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, flashbw::Args)",
     "flash (K1/K2)"),
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
    # K1 and K5: the kernels' __launch_bounds__ of 384 threads, the
    # consumers at setmaxnreg 232 (test_k1_products_are_wgmma)
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
    """K1's and K5's S = Q K^T is the SS bf16 form, O += P V the RS form
    with B transposed (V MN-major, its descriptor from desc_sw128_mn); both
    flash_text_fwd.cu (K1) and flash_stream_fwd.cu (K5) run that loop
    (`flashw::fwd_body`), the consumers at 232 registers from a producer
    warpgroup at 40, and flash_fwd.cuh's mma.sync loop is gone."""
    src = (CSRC / "flash_fwd_wgmma.cuh").read_text()
    assert "wgmma_m64n128k16_bf16_ss" in _function(src, "qk")
    pv = _function(src, "pv")
    assert "wgmma_m64n128k16_bf16_rs_tb" in pv and "desc_sw128_mn" in pv
    assert "mma.sync" not in src and "mma_16816" not in src
    assert "regs_alloc<232>" in src and "regs_dealloc<40>" in src
    for kernel in ("flash_text_fwd.cu", "flash_stream_fwd.cu"):
        text = (CSRC / kernel).read_text()
        assert '#include "flash_fwd_wgmma.cuh"' in text, kernel
        assert "flashw::fwd_body" in text and "flashw::launch" in text
        assert '#include "flash_fwd.cuh"' not in text, kernel
    assert not (CSRC / "flash_fwd.cuh").exists()
    common = (CSRC / "hopper_common.cuh").read_text()
    # the transposed-B form: scale-a 1, scale-b 1, tnspB 1
    assert "p, 1, 1, 1;" in _function(common, "wgmma_m64n128k16_bf16_rs_tb")


def test_fwd_overlaps_softmax_with_pv():
    """For each key tile after the first, the forward loop issues S_j =
    Q K_j^T, rescales O and issues O += P_{j-1} V_{j-1}, waits for the
    first group only (wgmma_wait<1>), and takes S_j's softmax while P V
    runs, before it waits for P V (wgmma_wait<0>) and packs P_j. Without
    MULTI (every item one K/V tile) the loop is compiled out."""
    src = (CSRC / "flash_fwd_wgmma.cuh").read_text()
    body = _function(src, "consume")
    loop = body[body.index("for (int j = 1; MULTI && j < n_kt;"):]
    loop = loop[:loop.index("the item's last P V")]
    order = ["qk(sc", "rescale(o, alpha)", "pv(o, p", "wgmma_wait<1>",
             "softmax_tile(", "wgmma_wait<0>", "pack_p(p, sc)"]
    pos = 0
    for x in order:                   # each after the one before
        pos = loop.index(x, pos) + 1
    assert "__expf(sc[4 * i]" in _function(src, "softmax_tile")
    for kernel in ("flash_text_fwd.cu", "flash_stream_fwd.cu"):
        text = (CSRC / kernel).read_text()
        assert "flashw::multi_tile(a)" in text and "<true>" in text \
            and "<false>" in text


def test_fwd_every_consumer_warp_releases_a_stage():
    """The forward's empty barriers (Q slots, K and V stages) count the 8
    consumer warps, and lane 0 of each warp arrives, as in K6a and K6b."""
    src = (CSRC / "flash_fwd_wgmma.cuh").read_text()
    assert "constexpr int CONSUMER_WARPS = 8;" in src
    inits = re.findall(r"mbar_init\(&bar\.(empty_\w)\[i\], (\w+)\)", src)
    assert sorted(n for n, _ in inits) == ["empty_k", "empty_q", "empty_v"]
    assert all(c == "CONSUMER_WARPS" for _, c in inits)
    body = _function(src, "consume")
    arrives = [m.start() for m in re.finditer(
        r"hopper::mbar_arrive\(&bar\.empty", body)]
    assert len(arrives) == 6          # tile 0 (K, Q), the loop (K, Q, V),
    for at in arrives:                # the last P V (V)
        cond = body[body.rindex("if (lane == 0)", 0, at):at]
        assert "\n    }" not in cond, cond


def _fwd_decode():
    """flash_fwd_wgmma.cuh's `decode` run as Python: its statements are
    integer arithmetic on non-negative ints (C's / is then //)."""
    src = (CSRC / "flash_fwd_wgmma.cuh").read_text()
    group = int(re.search(r"constexpr int GROUP = (\d+);", src).group(1))
    bq = int(re.search(r"constexpr int BQ = (\d+);", src).group(1))
    body = _function(src, "decode")
    stmts = [" ".join(st.split()).replace("const int ", "").replace("/", "//")
             for st in body[body.index("{") + 1:].split(";")]
    code = "\n".join(st for st in stmts if st and st != "}")

    def decode(a, item):
        env = {"a": a, "item": item, "GROUP": group, "min": min,
               "n_qtiles": lambda a: -(-a.S_q // bq)}
        exec(code, env)
        return env["qt"], env["h"], env["b"]
    return decode, group


@pytest.mark.parametrize("b,s,h", [(3, 4096, 32), (1, 8192, 32),
                                   (24, 128, 32), (2, 300, 5)])
def test_fwd_item_order_groups_heads(b, s, h):
    """K5's (and K1's) items: every (b, h, q tile) once; items come in
    groups of GROUP (b, h) pairs, the q tiles with the most K/V tiles first
    within a group, so that any 132 consecutive items (the card's SMs) touch
    at most 2 GROUP heads at S 4096 and 8192; at S 128 (one q tile a head)
    the order is the (b, h) order."""
    from types import SimpleNamespace

    decode, group = _fwd_decode()
    a = SimpleNamespace(B=b, H=h, S_q=s)
    tiles = -(-s // 128)
    items = [decode(a, i) for i in range(b * h * tiles)]
    assert sorted(items) == sorted((qt, hh, bb) for qt in range(tiles)
                                   for hh in range(h) for bb in range(b))
    heads = [bb * h + hh for _, hh, bb in items]
    for g0 in range(0, len(items), group * tiles):
        chunk = items[g0:g0 + group * tiles]
        assert len({heads[g0 + i] for i in range(len(chunk))}) <= group
        qts = [qt for qt, _, _ in chunk]
        assert qts == sorted(qts, reverse=True)
    if tiles == 1:
        assert heads == list(range(b * h))
    if tiles >= 32:
        assert max(len(set(heads[i:i + 132]))
                   for i in range(0, len(heads) - 132, 7)) <= 2 * group


# every CUDA source of the port
SOURCES = sorted(p.name for p in CSRC.glob("*.cu*"))


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("word", ["mma_16816", "mma.sync", "mma_s8_16832",
                                  "gemm_tile"])
def test_no_flash_source_has_mma_sync(source, word):
    """Every kernel is on TMA + wgmma: no source names the mma.sync product
    or the int8 mma.sync tile quant_common.cuh had, and the flash sources
    are the seven the attention family has."""
    assert sorted(p.name for p in CSRC.glob("flash_*")) == sorted(
        ["flash_common.cuh", "flash_fwd_wgmma.cuh", "flash_bwd_wgmma.cuh",
         "flash_text_fwd.cu", "flash_text_bwd.cu", "flash_stream_fwd.cu",
         "flash_stream_bwd.cu"])
    assert len(SOURCES) >= 17
    assert word not in (CSRC / source).read_text()


@pytest.mark.parametrize("source,kernel,cls", [
    ("flash_stream_fwd.cu", "flash_stream_fwd_kernel", "flash stream (K5/K6)"),
    ("flash_text_fwd.cu", "flash_text_fwd_kernel", "flash (K1/K2)"),
    ("flash_text_bwd.cu", "flash_text_dq_kernel", "flash (K1/K2)"),
    ("flash_text_bwd.cu", "flash_text_dkv_kernel", "flash (K1/K2)")])
def test_flash_globals_keep_the_profile_names(source, kernel, cls):
    """Each __global__ of the K1, K2 and K5 sources is named as the
    profiler files it (cli/profile.py `kernel_class`)."""
    src = (CSRC / source).read_text()
    assert re.search(rf"__global__ void(?: __launch_bounds__\(.*\))?\s+"
                     rf"{kernel}\(", src), kernel
    assert tprofile.kernel_class(f"void (anonymous namespace)::{kernel}(...)") \
        == cls


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
    """flash_stream_bwd.cu (K6a, K6b) and flash_text_bwd.cu (K2) both run
    flash_bwd_wgmma.cuh's loops, each launch with the item counter of the
    caller's stream (K2's dq pass also sums D, which K6 gets from its
    caller), and
    flash_bwd.cuh's mma.sync loops are gone; the __global__ names keep
    "flash_stream" (K6) and "flash_text" (K2), by which the profiler files
    them."""
    k6 = (CSRC / "flash_stream_bwd.cu").read_text()
    assert '#include "flash_bwd_wgmma.cuh"' in k6
    assert "flashbw::dq_body" in k6 and "flashbw::dkv_body" in k6
    assert "flash_stream_dq_kernel" in k6 and "flash_stream_dkv_kernel" in k6
    k2 = (CSRC / "flash_text_bwd.cu").read_text()
    assert '#include "flash_bwd_wgmma.cuh"' in k2
    assert "flashbw::dq_body" in k2 and "flashbw::dkv_body" in k2
    # K2's dq pass sums D = rowsum(dO * O) itself (no delta kernel); K6
    # takes D from the caller
    assert "dq_body<true>" in k2 and "dq_body<false>" in k6
    assert "delta_kernel" not in k2 and "DQ_SMEM_OWN_D" in k2
    assert "flash_text_dq_kernel" in k2 and "flash_text_dkv_kernel" in k2
    for text in (k6, k2):
        assert '#include "flash_bwd.cuh"' not in text
        assert "flash::dq_tile" not in text and "flash::dkdv_tile" not in text
    # the item counters are the caller's stream's (`sched`), no globals
    for text in (k6, k2):
        assert "__device__ unsigned int" not in text
        assert "cudaGetSymbolAddress" not in text
    assert not (CSRC / "flash_bwd.cuh").exists()


def test_k2_row_dots_read_every_column_once():
    """flash_bwd_wgmma.cuh's `row_dots` (K2's D = rowsum(dO * O) from shared
    memory): its offset expression, evaluated for every lane and step,
    reads each 16-byte chunk of each of a warpgroup's 64 rows exactly once
    through the 128-byte swizzle that TMA wrote (logical chunk c of row r at
    chunk c ^ (r % 8) of its 128-byte row), the quad's 4 lanes between
    them, and stays within the rows' two 64-column boxes."""
    src = (CSRC / "flash_bwd_wgmma.cuh").read_text()
    body = _function(src, "row_dots")
    expr = re.search(r"const int off = ([^;]+);", body).group(1)
    rows, box = 64, 128 * 128          # the boxes of a 128-row tile
    for w in range(4):
        for g in range(8):
            for r in range(2):
                row = 16 * w + g + 8 * r
                seen = []
                for t in range(4):
                    for x in range(2):
                        for k in range(2):
                            off = eval(expr, {"x": x, "box": box, "row": row,
                                              "ROW": 128, "t": t, "k": k})
                            assert off % 16 == 0 and 0 <= off < 2 * box
                            bx, rest = divmod(off, box)
                            assert rest // 128 == row < rows
                            seen.append(bx * 8 + ((rest % 128) // 16
                                                  ^ (row % 8)))
                assert sorted(seen) == list(range(16)), (row, seen)


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



@pytest.mark.parametrize("source,loop,stage,form", [
    ("int8_grouped_fwd.cu", "consume", "issue", "wgmma_m64n128k32_s8_ss"),
    ("int4_fwd.cu", "a8_consume", "a8_stage", "wgmma_m64n128k32_s8_rs")])
def test_grouped_forwards_are_tma_fed_wgmma(source, loop, stage, form):
    """K7 (SS: xq and kq both K-major from shared memory) and K8's w4a8
    branch (RS: the packed weight's nibbles in registers, xq from shared
    memory) wait on a TMA ring's full barriers, issue a group's first wgmma
    with scale-d 0 (the _zero form) and the rest adding, and take the
    producer warpgroup's registers (setmaxnreg 40 / 232); the producer
    brings the fold's scales by TMA too, and every consumer warp releases
    a stage."""
    src = (CSRC / source).read_text()
    st = _function(src, stage)
    assert "mbar_wait(&ring.full[" in st
    assert f"hopper::{form}_zero(d" in st and f"hopper::{form}(d" in st
    assert "hopper::wgmma_commit()" in st
    assert src.count("hopper::tma_load_2d(") >= 4
    assert "regs_alloc<232>" in src and "regs_dealloc<40>" in src
    assert re.search(r"mbar_init\(&empty\[s\], (A8_)?CONSUMER_WARPS\)", src)
    assert "float acc[64];" in _with_callees(src, loop)
    common = (CSRC / "hopper_common.cuh").read_text()
    for f in (form, form + "_zero"):
        assert re.search(rf"void {f}\(", common), f
    assert "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8" in common


def test_k7_alternates_two_accumulators():
    """K7 alternates two int32 accumulators between groups, each group
    folded while the next group's wgmmas run (issued once its own are
    done: wgmma_wait<0>, then the issue, then the fold); the kernel is
    instantiated for even and odd group counts, so no branch picks an
    accumulator at run time."""
    src = (CSRC / "int8_grouped_fwd.cu").read_text()
    body = _with_callees(src, "consume")
    assert "int d0[64], d1[64];" in body
    pair = body[body.index("for (; gi + 1 < groups; gi += 2)"):]
    pair = pair[pair.index("{") + 1:pair.index("}")]
    first, second = (re.search(r"\(ring, p, (d[01]), (d[01]),", c).groups()
                     for c in pair.split(";")[:2])
    assert first == ("d1", "d0") and second == ("d0", "d1")
    step = " ".join(_function(src, "step").split())
    assert step.index("wgmma_wait<0>()") < step.index("issue(") \
        < step.index("fold(")
    assert "if constexpr (EVEN)" in body
    assert "int8_grouped_wgmma_kernel<true>" in src
    assert "int8_grouped_wgmma_kernel<false>" in src


def _fold_terms(src: str, fold: str):
    """The accumulate statement of a group fold, whitespace squeezed."""
    body = " ".join(_function(src, fold).split())
    return re.findall(r"acc\[r\] = (__fadd_rn\(.*?\));", body)


@pytest.mark.parametrize("source,fold,xv,sv", [
    ("int8_grouped_fwd.cu", "fold", "xv[e >> 1]", "sv[e & 1]"),
    ("int4_fwd.cu", "a8_fold", "xv[e & 1]", "sv[e >> 1]")])
def test_group_fold_keeps_the_plain_order(source, fold, xv, sv):
    """K7's and K8 w4a8's fold is acc + ((float(d_g) * xs[m]) * s_g[n]),
    each step rounded (__int2float_rn, __fmul_rn, __fmul_rn, __fadd_rn),
    the groups in order into one f32 sum: grouped_matmul_ref's order, so the
    result is the plain version's bit for bit. (K7's accumulator rows are
    output rows, K8's output columns: the row scale and the column scale
    take the other index bits.)"""
    src = (CSRC / source).read_text()
    assert _fold_terms(src, fold) == [
        f"__fadd_rn( acc[r], __fmul_rn(__fmul_rn(__int2float_rn(d[r]), "
        f"{xv}), {sv}))"]


def _nibbles_np(p, hi):
    """quant_common.cuh's nibbles_lo / nibbles_hi on uint32 words p."""
    p = np.asarray(p, dtype=np.uint32)
    if hi:
        p = p >> np.uint32(4)
    x = (p & np.uint32(0x0F0F0F0F)) ^ np.uint32(0x08080808)
    return (x + np.uint32(0x78787878)) ^ np.uint32(0x80808080)


def test_nibbles_equal_jax_sign_extending_shifts():
    """quant_common.cuh's nibbles_lo / nibbles_hi, emulated in numpy on
    every byte value in each byte of a word, equal the JAX kernel's
    sign-extending shifts (quant_matmul.py:172-174, run by jax.numpy on the
    same bytes) and unpack_int4."""
    import jax.numpy as jnp

    from flipped_tpu_torch.model.kernels import quant_matmul as qm

    src = (CSRC / "quant_common.cuh").read_text()
    assert ("(((p & 0x0F0F0F0Fu) ^ 0x08080808u) + 0x78787878u) ^ "
            "0x80808080u" in " ".join(_function(src, "nibbles_lo").split()))
    assert "return nibbles_lo(p >> 4);" in _function(src, "nibbles_hi")
    b = np.arange(256, dtype=np.uint32)
    p32 = jnp.asarray(b.astype(np.int8)).astype(jnp.int32)
    jax_lo = np.asarray(jnp.right_shift(jnp.left_shift(p32, 28), 28)
                        .astype(jnp.int8))
    jax_hi = np.asarray(jnp.right_shift(jnp.left_shift(p32, 24), 28)
                        .astype(jnp.int8))
    port = qm.unpack_int4(torch.from_numpy(b.astype(np.int8)[None, :]))
    assert np.array_equal(port[0].numpy(), jax_lo)
    assert np.array_equal(port[1].numpy(), jax_hi)
    for shift in (0, 8, 16, 24):                 # each byte of the word
        words = (b << np.uint32(shift)) | (np.uint32(0x5A) << np.uint32(
            (shift + 8) % 32))
        for hi, ref in ((False, jax_lo), (True, jax_hi)):
            got = ((_nibbles_np(words, hi) >> np.uint32(shift))
                   & np.uint32(0xFF)).astype(np.uint8).view(np.int8)
            assert np.array_equal(got, ref), (shift, hi)


def test_shared_memory_opt_in_is_per_device():
    """No source keeps a `static bool attr_set`: every kernel's opt-in to
    more than 48 KB of shared memory goes through hopper_common.cuh's
    smem_opt_in, which keeps one flag per (kernel, device) by
    cudaGetDevice."""
    for p in sorted(CSRC.glob("*.cu*")):
        text = p.read_text()
        assert "static bool attr_set" not in text, p.name
        assert "attr_set" not in text, p.name
        if p.name != "hopper_common.cuh":
            assert "cudaFuncSetAttribute" not in text, p.name
    common = (CSRC / "hopper_common.cuh").read_text()
    body = _function(common, "smem_opt_in_fn")
    assert "cudaGetDevice(&dev)" in body and "{kernel, dev}" in body
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in body
    users = [p.name for p in sorted(CSRC.glob("*.cu*"))
             if "hopper::smem_opt_in(" in p.read_text()]
    assert users == ["dx_wgmma.cuh", "flash_bwd_wgmma.cuh",
                     "flash_fwd_wgmma.cuh", "int4_decode.cu", "int4_fwd.cu",
                     "int8_decode.cu", "int8_fwd.cu", "int8_grouped_fwd.cu",
                     "wgmma_int8.cuh"], users


@pytest.mark.parametrize("source,fn", [
    ("flash_text_fwd.cu", "flash_text_fwd"),
    ("flash_stream_fwd.cu", "flash_stream_fwd"),
    ("flash_text_bwd.cu", "flash_text_bwd"),
    ("flash_stream_bwd.cu", "flash_stream_dq"),
    ("flash_stream_bwd.cu", "flash_stream_dkv")])
def test_flash_item_counters_are_the_callers(source, fn):
    """Each flash entry point takes its item counter (`sched`) from the
    caller, which hands it the counter of the stream it launches on
    (flash_attention.py `_item_counter`, in the argument list the library
    declares): no `__device__` counter is left for launches on two streams
    to share."""
    text = (CSRC / source).read_text()
    assert "__device__ unsigned int" not in text
    sig = text[text.index(f'extern "C" int {fn}('):]
    sig = " ".join(sig[:sig.index("{")].split())
    assert sig.endswith("void* sched, void* stream)"), sig
    lib = (Path(build.__file__)).read_text()
    decl = lib[lib.index(f"self.lib.{fn}.argtypes"):]
    decl = decl[:decl.index("restype")]
    assert "[ctypes.c_void_p] * 2)" in decl
    from flipped_tpu_torch.model.kernels import flash_attention as fa_mod
    wrappers = Path(fa_mod.__file__).read_text()
    assert wrappers.count("_item_counter(q.device, stream)") == 4


@pytest.mark.parametrize("line,found", [
    ("ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async "
     "instructions are serialized due to non wgmma instructions defining "
     "accumulator registers of a wgmma between start and end of the "
     "pipeline stage in the function '_Z1kv'", True),
    ("ptxas info    : (C7510) Potential Performance Loss: wgmma.mma_async "
     "instructions are serialized due to wgmma pipeline crossing function "
     "boundary at a function call in the function '_Z1kv'", True),
    ("ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async "
     "instructions are serialized due to ...", True),
    ("ptxas info    : Used 168 registers, used 1 barriers, 16 bytes "
     "cumulative stack size", False),
    ("ptxas info    : (C7519) warpgroup.arrive is injected in around line "
     "998 by compiler to allow use of registers in GMMA", False)])
def test_build_log_scan_names_the_source(line, found):
    """build.wgmma_serialisation_warnings finds ptxas's C7510-C7520 lines
    that report serialised wgmmas in a build log (not the injected
    warpgroup.arrive of C7519, which serialises nothing) and names the
    source whose `# nvcc` line heads them; chip_smoke.py's build phase fails
    on any."""
    log = ("# nvcc int8_fwd.cu\nptxas info    : Used 168 registers\n"
           f"# nvcc int4_fwd.cu\n{line}\n# nvcc quant_dx.cu\n")
    hits = build.wgmma_serialisation_warnings(log)
    assert hits == ([("int4_fwd.cu", line)] if found else [])
    smoke = (Path(build.__file__).parents[3] / "chip_smoke.py").read_text()
    assert "wgmma_serialisation_warnings(lib.log)" in smoke


# --- K8's decode route (csrc/int4_decode.cu) ----------------------------------

def _decode_a_rows(packed, hi_form):
    """Host emulation of the decode kernel's A operand for one step: its
    warpgroup's 64 A rows from the 32 packed rows of `packed` (32, 128
    bytes), every thread's fragments (warp w, lane 4g + t: packed rows p0 =
    16 (w & 1) + g and p0 + 8, the high nibbles in warps 2 and 3) put back
    at the (row, k) the wgmma's fragment layout gives them. `hi_form` is
    "s8" (w4a8: each byte's nibble moved to its top, the signed byte 16 c,
    4 bytes a register, m64nNk32) or "bf16" (weight-only: nibble_pair_bf16
    after the shift by 4 for the high nibbles, m64nNk16)."""
    a = np.zeros((64, 128), dtype=np.float64)
    for w in range(4):
        sh = 4 if w >= 2 else 0
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            p0 = 16 * (w & 1) + g
            for j in range(4):
                row = p0 + 8 * (j & 1)
                arow = 16 * w + g + 8 * (j & 1)
                if hi_form == "s8":
                    for ks in range(4):
                        c = 32 * ks + 16 * (j >> 1) + 4 * t
                        word = int.from_bytes(bytes(packed[row, c:c + 4]),
                                              "little")
                        word = ((word << (4 - sh)) & 0xF0F0F0F0)
                        vals = np.frombuffer(word.to_bytes(4, "little"),
                                             dtype=np.int8)
                        a[arow, c:c + 4] = vals
                else:
                    for ks in range(8):
                        c = 16 * ks + 8 * (j >> 1) + 2 * t
                        v = int(packed[row, c]) | (int(packed[row, c + 1])
                                                   << 8)
                        u = (v & 0xFF) | ((v >> 8) << 16)   # byte_perm 0x4140
                        u = ((u >> sh) & 0x000F000F) ^ 0x43084308
                        pair = (_bf16([u & 0xFFFF, u >> 16])
                                - _bf16(0x4308))
                        a[arow, c:c + 2] = pair
    return a


@pytest.mark.parametrize("hi_form,scale", [("s8", 16.0), ("bf16", 1.0)])
def test_decode_a_rows_are_both_nibbles_of_32_packed_rows(hi_form, scale):
    """int4_decode.cu's A operand: a warpgroup's 64 A rows come from both
    nibbles of 32 packed rows, the low nibbles first (output columns j0 ..
    j0 + 31), then the high ones (N/2 + j0 ..), equal to unpack_int4's
    rows; the w4a8 form's bytes are 16 times the codes (exact: the fold
    takes xs / 16)."""
    from flipped_tpu_torch.model.kernels import quant_matmul as qm

    rng = np.random.default_rng(5)
    nh, k, j0 = 96, 128, 32
    packed = rng.integers(-128, 128, (nh, k), dtype=np.int8)
    codes = qm.unpack_int4(torch.from_numpy(packed)).numpy()
    a = _decode_a_rows(packed[j0:j0 + 32].view(np.uint8), hi_form)
    want = np.concatenate([codes[j0:j0 + 32], codes[nh + j0:nh + j0 + 32]])
    assert np.array_equal(a, scale * want.astype(np.float64))


def test_decode_fold_of_16d_equals_the_plain_fold():
    """The w4a8 fold on 16 d: float(16 d) by the integer-add-and-subtract
    conversion (0x4B400000 + 16 d, minus 1.5 * 2^23: exact while |16 d| <
    2^22, up to groups of 256), times xs / 16, times s, each rounded in f32,
    equals (float(d) * xs) * s bit for bit: scaling by 16 commutes with
    every rounding, and xs / 16 is exact (xs >= 1e-8)."""
    rng = np.random.default_rng(6)
    lim = 127 * 8 * 256
    d = np.concatenate([rng.integers(-lim, lim + 1, 200000),
                        [lim, -lim, 0, 1, -1]]).astype(np.int64)
    xs = np.concatenate([
        (rng.random(200000) * 0.1).astype(np.float32), np.float32([
            1e-8, 1e-8, 1e-8, 3e-3, 1.0])]).astype(np.float32)
    xs = np.maximum(xs, np.float32(1e-8))
    s = (rng.random(d.size).astype(np.float32) + np.float32(0.5)) \
        / np.float32(7 * 64)
    f16 = (_f32_bits((0x4B400000 + 16 * d).astype(np.uint32))
           - np.float32(12582912.0))
    assert np.array_equal(f16, (16 * d).astype(np.float32))
    got = (f16 * (xs * np.float32(0.0625))) * s
    want = (d.astype(np.float32) * xs) * s
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_decode_loop_is_tma_fed_wgmma_in_k7s_order():
    """int4_decode.cu: RS wgmmas m64nNk32 (s8) and m64nNk16 (bf16) for N =
    8, 16, 32 and 64, a step's first with scale-d 0; a producer lane's TMA
    boxes (x or xq, the packed weight, the scales) into an mbarrier ring;
    each step waits for the previous step's wgmmas (wgmma_wait<0>) before
    it issues its own, then folds the previous step while they run (K7's
    order, which keeps ptxas from serialising the wgmmas); the w4a8 fold
    is (float(d) * xs) * s added to acc, and block-level groups are added
    in order across the two warpgroups."""
    src = (CSRC / "int4_decode.cu").read_text()
    for n in (8, 16, 32, 64):
        for form in (f"m64n{n}k32.s32.s8.s8", f"m64n{n}k16.f32.bf16.bf16"):
            assert f"wgmma.mma_async.sync.aligned.{form}" in src, form
    issue = " ".join(src[src.index("auto issue = [&]"):].split())
    issue = issue[:issue.index("};")]
    assert issue.index("dec_s8_rs_zero(d, a[0], desc)") \
        < issue.index("dec_s8_rs(d, a[ks]")
    assert "dec_bf16_rs_zero(d, a[0], desc)" in issue
    step = " ".join(src[src.index("auto step = [&]"):].split())
    step = step[:step.index("};")]
    assert step.index("wgmma_wait<0>()") < step.index("issue(") \
        < step.index("absorb(")
    assert "wgmma_wait<1>" not in src
    fold = " ".join(src[src.index("auto fold = [&]"):].split())
    assert ("term[r] = __fmul_rn(__fmul_rn(f, xv[e & 1]), sv[e >> 1]);"
            in fold)
    assert "acc[r] = __fadd_rn(acc[r], term[r]);" in fold
    assert "acc[r] = __fadd_rn(acc[r], xch[" in fold
    assert src.count("hopper::tma_load_3d(") >= 3
    common = (CSRC / "hopper_common.cuh").read_text()
    assert "cp.async.bulk.tensor.3d" in _function(common, "tma_load_3d")
    assert "mbar_wait(&empty[s]" in src and "mma.sync" not in src


def test_int8_decode_loops_are_tma_fed_ss_wgmma():
    """int8_decode.cu, the decode routes of K3 and K7: SS wgmmas m64nNk32
    (s8) for N = 8, 16, 32 and 64, both operands K-major int8 tiles in
    shared memory (no register conversion of the weight), a run's first
    with scale-d 0; a producer lane's TMA boxes into an mbarrier ring. K3's
    GEMM is a programmatic dependent launch of its quantize pass (which
    signals at once): it loads its first stages' weight before
    griddepcontrol.wait and xq after; each 128-deep chunk's wgmmas are a
    group of their own, and a stage goes back once its second chunk's
    wgmmas are done (wgmma_wait<1>, as int8_fwd.cu); a tile's runs meet in
    a cluster's shared memory, and the deep ring is taken where the runtime
    says its clusters fit at once. K7 waits for the previous group's wgmmas
    before it issues the next and folds the previous one while they run."""
    src = (CSRC / "int8_decode.cu").read_text()
    for n in (8, 16, 32, 64):
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8" in src
    assert "mma.sync" not in src and "_rs(" not in src
    k3 = " ".join(_function(src, "int8_decode_kernel").split())
    assert k3.index("for (int i = 0; i < pre; ++i) weights(i);") \
        < k3.index("grid_wait();") \
        < k3.index("hopper::tma_load_2d(st + c * C::X_CHUNK, &x_map")
    issue = k3[k3.index("auto issue = [&]"):k3.index("issue(0, true);")]
    assert issue.index("wgmma_fence()") < issue.index("ss_s8_zero(d, da, db)")
    assert issue.index("ss_s8(d, da + 2 * ks") < issue.index(
        "wgmma_commit()")
    loop = k3[k3.index("issue(0, true);"):]
    assert loop.index("issue(c, false);") < loop.index("wgmma_wait<1>();") \
        < loop.index("hopper::mbar_arrive(&empty[")
    assert loop.index("cluster_sync();") < loop.index("ld_cluster(") \
        < loop.rindex("cluster_sync();") < loop.index("store_pairs(")
    quantize = _function(src, "int8_decode_quantize_kernel")
    assert "launch_dependents();" in quantize and "quant::INV127" in quantize
    launch = src[src.index("struct K3Launch"):src.index("cudaError_t k3_deep")]
    assert "cudaLaunchAttributeProgrammaticStreamSerialization" in launch
    assert "cudaLaunchAttributeClusterDimension" in launch
    assert "cudaOccupancyMaxActiveClusters" in _function(src, "k3_deep")
    step = " ".join(src[src.index("auto step = [&]"):].split())
    step = step[:step.index("};")]
    assert step.index("wgmma_wait<0>()") < step.index("issue(") \
        < step.index("absorb(")
    assert "tma_load_3d(st, &x_map" in _function(
        src, "int8_grouped_decode_kernel")


def test_k7_decode_fold_keeps_the_plain_order():
    """K7's decode fold is acc + ((float(d_g) * xs[m]) * s_g[n]), each step
    rounded (__int2float_rn, __fmul_rn, __fmul_rn, __fadd_rn), the groups
    in order into one f32 sum: warpgroup 0 adds its even group's term, then
    the odd group's term that warpgroup 1 handed over (the accumulator's
    rows are output columns: the row scale takes e & 1, the column scale
    e >> 1). K3's epilogue keeps JAX's (float(d) * xs) * scale on the full
    int32 sum, its runs' partials added first."""
    src = (CSRC / "int8_decode.cu").read_text()
    fold = " ".join(src[src.index("auto fold = [&]"):].split())
    fold = fold[:fold.index("auto absorb")]
    assert ("term[r] = __fmul_rn(__fmul_rn(__int2float_rn(d[r]), xv[e & 1]),"
            " sv[e >> 1]);" in fold)
    own = fold.index("acc[r] = __fadd_rn(acc[r], term[r]);")
    assert own < fold.index("acc[r] = __fadd_rn(acc[r], xch[")
    k3 = " ".join(_function(src, "int8_decode_kernel").split())
    epilogue = ("v[r] = __fmul_rn(__fmul_rn(__int2float_rn(d[r]), xv), "
                "sc[(r >> 1) & 1]);")
    assert k3.index("d[r] += ld_cluster(") < k3.index(epilogue)


@pytest.mark.parametrize("k", [16, 144, 400, 4096, 5504, 11008, 12304])
@pytest.mark.parametrize("runs", [1, 2, 3, 4, 16])
def test_int8_decode_runs_cover_k_once(k, runs):
    """K3's decode route: run y of `runs` takes stages [all y / runs, all
    (y + 1) / runs) of the ceil(K / 256) stages (int8_decode_kernel), each
    at least one, and its 128-deep chunks up to K (a stage's second only
    where it starts before K); together the runs' chunks cover [0, K) once,
    so the runs' int32 partials add to the full dot."""
    from flipped_tpu_torch.model.kernels import quant_matmul as qm

    stage = qm.DECODE_STAGE
    all_ = -(-k // stage)
    if runs > all_:
        return
    starts = []
    for y in range(runs):
        s_begin = all_ * y // runs
        nst = all_ * (y + 1) // runs - s_begin
        assert nst >= 1
        k_begin = s_begin * stage
        nch = -(-(min(k, k_begin + nst * stage) - k_begin) // 128)
        for i in range(nst):
            for c in range(min(2, nch - 2 * i)):
                starts.append(k_begin + i * stage + c * 128)
    covered = sorted(starts)
    assert covered == list(range(0, k, 128))
