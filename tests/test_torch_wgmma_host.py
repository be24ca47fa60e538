"""Host-side facts of the TMA + wgmma kernels (K3, K1, K5, K2, K6a, K6b,
K8 weight-only, K10's GEMM, K4 and K9) that hold without a card: the
profiler files their kernels under their classes, their main loops are
wgmma fed by TMA through an mbarrier ring, with no mma.sync left in them or
in any flash source, the forward's item order groups heads, and the integer
tricks by which K4 and K9 dequantize into wgmma's register operand are
exact (the CUDA sources themselves run only on the card:
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


@pytest.mark.parametrize("source", [
    "flash_common.cuh", "flash_fwd_wgmma.cuh", "flash_bwd_wgmma.cuh",
    "flash_text_fwd.cu", "flash_text_bwd.cu", "flash_stream_fwd.cu",
    "flash_stream_bwd.cu"])
@pytest.mark.parametrize("word", ["mma_16816", "mma.sync"])
def test_no_flash_source_has_mma_sync(source, word):
    """The whole attention family (K1, K2, K5, K6a, K6b) is on TMA + wgmma:
    no flash source names the mma.sync product, and the list above is every
    flash source there is."""
    assert sorted(p.name for p in CSRC.glob("flash_*")) == sorted(
        ["flash_common.cuh", "flash_fwd_wgmma.cuh", "flash_bwd_wgmma.cuh",
         "flash_text_fwd.cu", "flash_text_bwd.cu", "flash_stream_fwd.cu",
         "flash_stream_bwd.cu"])
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
    flash_bwd_wgmma.cuh's loops, each with item counters of its own (K2's
    dq pass also sums D, which K6 gets from its caller), and
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
    counters = [set(re.findall(r"__device__ unsigned int (\w+)\[2\];", t))
                for t in (k6, k2)]
    assert len(counters[0]) == len(counters[1]) == 2
    assert not counters[0] & counters[1]
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
