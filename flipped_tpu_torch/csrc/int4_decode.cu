// K8's decode route: the packed-int4 forward of --quantize int4 / w4a8
// (and int4r / w4a8r) for x of at most 64 rows, the shapes of generation's
// decode steps (32 rows, one a sequence) and of the adapter prefix (10
// rows). int4_fwd.cu keeps the calls of more rows.
//
// Replaces, for those shapes, the TPU kernel int4_matmul_grouped_pallas ->
// _int4_kernel (flipped_tpu/model/pallas/quant_matmul.py:160-275), and
// computes what int4_fwd.cu does, for x (M, K) bf16, kq4 (N/2, K) int8
// packed (byte [j, k]: W[j, k] in its low nibble, W[j + N/2, k] in its high
// nibble), scale_g (G, N) f32, group = K / G = 128 (the model's; other
// groups take int4_fwd.cu):
//   w4a8 (act_quant): K7's grouped quantize of x (quant_common.cuh's pass:
//     amax / 127 as a division, rint half to even, the 1e-8 floor), exact
//     int32 group dots d_g, out = bf16(sum_g (float(d_g) * xs_g) * s_g),
//     the groups in order, each step rounded: bit for bit the plain
//     version's.
//   weight-only: bf16 products on the raw codes, each group's f32 partial
//     (the tensor core's sums) times s_g and added to an f32 sum in group
//     order; within chip_smoke.py's K8_WO_REL of the plain version. The
//     groups may be cut into runs (two consumer warpgroups' even and odd
//     groups, and `splits` blocks' contiguous shares), each run's f32 sum
//     added to the others' in a fixed order (a second kernel for the
//     blocks' runs: no float atomics) and rounded once to bf16.
//
// What bounds it on an H100: a decode call is memory-bound by its bytes
// (8.4 or 22.5 MB of packed weight at 32 rows and the 7B shapes: 2.8 us and
// 7.4 us at 3.35 TB/s; 1-3 G multiply-adds), but a tile's contraction is a
// chain of 32 or 86 group folds, and on the card each warp's walk down
// that chain sets the time: at 32 rows a step (128-deep) is a few hundred
// instructions a warp (the A fragments' loads and nibble conversions, the
// fold's conversions, multiplies and adds, the hand-over) beside 4 or 8
// small wgmmas; timed with clock64 in a throwaway build, the fold was the
// largest part of a step, and the waits for the wgmmas the smallest.
// int4_fwd.cu's tiles (128 x rows, 64 packed rows) wasted three quarters of
// every wgmma at 32 rows and gave 32 blocks at N 4096. The design here:
//   - the packed weight is wgmma's register A operand (out^T = W . x^T),
//     and a warpgroup forms its 64 A rows from both nibbles of 32 packed
//     rows: warps 0 and 1 the low nibbles of packed rows 0-15 and 16-31
//     (output columns j0 + p), warps 2 and 3 the high nibbles of the same
//     bytes (columns N/2 + j0 + p). A tile is 64 output columns: 64 blocks
//     at N 4096, 172 at N 11008 (each byte crosses HBM once).
//   - wgmma's N is M rounded up to 8, 16, 32 or 64 (m64nNk32 s8 for w4a8,
//     m64nNk16 bf16 for weight-only), x the K-major B operand in shared
//     memory; rows past M come in as zeros.
//   - a producer lane keeps a ring of 256-deep stages full by TMA, four
//     boxes a stage (3-D tensor maps: x's or xq's two 128-deep steps in
//     128-byte chunks of MP rows, the 32 packed rows' two steps, both
//     halves' column scales of the stage's two groups, and for w4a8 their
//     MP row scales, the quantize pass's transposed xs): the TMA unit's
//     cost is about per box, and 128-deep stages of five boxes each held
//     the ring back. The scales come with the stage (scale_g
//     16-byte aligned); loading them in the fold put an L2 round trip on
//     every group's chain, and cp.async copies from the producer's lanes
//     slowed the ring more than the boxes they saved.
//   - up to 32 rows, two consumer warpgroups share a tile's steps (a stage
//     holds one of each: the even groups, the odd ones), so
//     that each SM sub-partition has two warps to issue from; w4a8's fold
//     stays in group order across them (warpgroup 1 hands each group's
//     term, (float(d) * xs) * s, to warpgroup 0 through shared memory and
//     named barriers; warpgroup 0 adds it after its own group's), the
//     weight-only branch adds the two sums at the end. At 64 rows one
//     warpgroup takes every step: two would not have the registers.
//   - each warpgroup alternates two accumulators and two A-fragment
//     buffers: once step i-1's wgmmas are done, step i's are issued, and
//     while they run the warpgroup folds step i-1 and converts step i+1's
//     nibbles (K7's order: a step issued before the previous one's wait
//     made ptxas serialise the wgmmas).
//   - w4a8's A fragments are the nibbles moved to each byte's top (a shift
//     for the low ones, then one mask): signed bytes 16 c, so d is 16 times
//     the group's dot, exactly; the fold takes xs / 16 (exact, xs >= 1e-8),
//     and float(16 d) * (xs / 16) is float(d) * xs to the last bit. float(16
//     d) adds 1.5 * 2^23 to the integer's bits and subtracts it as a float
//     (exact while |16 d| < 2^22: |16 d| <= 16 * 127 * 8 * 128).
//   - the weight-only branch also splits the groups over `splits` blocks
//     where the tiles alone do not fill the card (the wrapper picks it).
// The w4a8 branch keeps K7's quantize pass ahead of the GEMM (two
// launches): every block needs all of x's rows, so a quantize inside the
// GEMM would repeat M x K divisions (or a reciprocal multiply and a tie
// check) in each of the 64-172 blocks, more instructions a block than its
// chain of folds at 32 rows. Tried and dropped (throwaway builds):
// splitting a tile's groups between the two blocks of a cluster (w4a8's
// in-order hand-over of each group's term through distributed shared
// memory made it slower), and tiles of 16 packed rows over the same warps
// (twice the blocks, each warp's chain as long: little gain).
// Not done (later work): fewer instructions a fold, more warps a tile's
// chain, and overlapping the quantize pass with the GEMM's start
// (programmatic dependent launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "hopper_common.cuh"
#include "quant_common.cuh"

namespace {

using flash::bf16;

constexpr int DEC_P = 32;           // packed rows a block: 64 output columns
constexpr int DEC_STEP = 128;       // contraction a step: one group
constexpr int DEC_STAGES = 4;       // stages of two steps
constexpr int DEC_W_BYTES = DEC_P * DEC_STEP;  // 4 KB a step, 128B swizzle

// MP: wgmma's N, M rounded up; A8: the w4a8 branch
template <int MP, bool A8>
struct DecCfg {
  typedef typename std::conditional<A8, int, float>::type Acc;
  // a stage: two steps of x (xq: a 128-byte chunk of MP rows a step;
  // bf16 x: two), of the weight (32 rows x 128 bytes a step), then the
  // scales of two groups (32 + 32 column scales each, then, for w4a8, MP
  // row scales each)
  static constexpr int X_BYTES = 2 * (A8 ? 1 : 2) * MP * 128;
  static constexpr int AUX = X_BYTES + 2 * DEC_W_BYTES;
  static constexpr int STAGE = AUX + 1024;                 // 1 KB multiple
  static constexpr int TX_BYTES = AUX + 4 * (128 + (A8 ? 2 * MP : 0));
  static constexpr int STEPS = A8 ? 4 : 8;    // wgmmas a step (k32 / k16)
  static constexpr int NR = MP / 2;           // accumulator registers
  // the ring, its barriers, and (two consumer warpgroups) their exchange
  // slots: 2 x NR x 128 floats
  static constexpr int SMEM =
      DEC_STAGES * STAGE + 2 * DEC_STAGES * 8 + 2 * NR * 128 * 4 + 1024;
  // two consumer warpgroups up to 32 rows (at 64 rows their registers do
  // not fit beside each other)
  static constexpr bool DUAL = MP <= 32;
  static constexpr int THREADS = DUAL ? 288 : 160;
};

// RS wgmma m64nNk16 (bf16, f32 sums) and m64nNk32 (s8, s32 sums) for N =
// 8, 16, 32, 64, one overload a size of d (N / 2 registers): A from
// registers (the m16n8k16 / m16n8k32 fragment layout, warp w holding rows
// 16w..16w+15), B a K-major tile in shared memory (`desc`). D: d[4i + e]
// at (row 16w + g + 8 (e >> 1), column 8i + 2t + (e & 1)), lane = 4g + t.
// The _zero forms write d (scale-d 0): a stage's first wgmma defines its
// accumulator registers, so no ordinary instruction writes them.

__device__ __forceinline__ void dec_bf16_rs(
    float (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void dec_bf16_rs_zero(
    float (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

__device__ __forceinline__ void dec_bf16_rs(
    float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void dec_bf16_rs_zero(
    float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

__device__ __forceinline__ void dec_bf16_rs(
    float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void dec_bf16_rs_zero(
    float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

__device__ __forceinline__ void dec_bf16_rs(
    float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void dec_bf16_rs_zero(
    float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

__device__ __forceinline__ void dec_s8_rs(
    int (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void dec_s8_rs_zero(
    int (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p;\n"
      "}\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

__device__ __forceinline__ void dec_s8_rs(
    int (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void dec_s8_rs_zero(
    int (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n"
      "}\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]),
        "=r"(d[4]), "=r"(d[5]), "=r"(d[6]), "=r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

__device__ __forceinline__ void dec_s8_rs(
    int (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void dec_s8_rs_zero(
    int (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n"
      "}\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]),
        "=r"(d[4]), "=r"(d[5]), "=r"(d[6]), "=r"(d[7]),
        "=r"(d[8]), "=r"(d[9]), "=r"(d[10]), "=r"(d[11]),
        "=r"(d[12]), "=r"(d[13]), "=r"(d[14]), "=r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}

__device__ __forceinline__ void dec_s8_rs(
    int (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void dec_s8_rs_zero(
    int (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]),
        "=r"(d[4]), "=r"(d[5]), "=r"(d[6]), "=r"(d[7]),
        "=r"(d[8]), "=r"(d[9]), "=r"(d[10]), "=r"(d[11]),
        "=r"(d[12]), "=r"(d[13]), "=r"(d[14]), "=r"(d[15]),
        "=r"(d[16]), "=r"(d[17]), "=r"(d[18]), "=r"(d[19]),
        "=r"(d[20]), "=r"(d[21]), "=r"(d[22]), "=r"(d[23]),
        "=r"(d[24]), "=r"(d[25]), "=r"(d[26]), "=r"(d[27]),
        "=r"(d[28]), "=r"(d[29]), "=r"(d[30]), "=r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(0));
}


// 2 bytes at (row r, byte b) of a 128-byte-row tile written by TMA with the
// 128-byte swizzle (b even, b % 16 < 15)
__device__ __forceinline__ uint32_t sw128_u16(const uint8_t* tile, int r,
                                              int b) {
  return *reinterpret_cast<const uint16_t*>(
      tile + r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15));
}

// float(d) for |d| < 2^22, exact: 0x4B400000 is 1.5 * 2^23, whose unit in
// the last place is 1
__device__ __forceinline__ float small_i2f(int d) {
  return __fsub_rn(__int_as_float(0x4B400000 + d), 12582912.f);
}

// named barrier ids: 1 + b (exchange slot b full), 3 + b (slot b empty)
constexpr int BAR_FULL = 1, BAR_EMPTY = 3;

// A consumer warpgroup (wg) of the steps (groups) [g_begin, g_end) of the
// block's 32 packed rows from j0: its fold into acc, then the epilogue
// (bf16 out, or the f32 sums of run blockIdx.y into part). Up to 32 rows
// two warpgroups share the steps: step i (group g_begin + i) goes to
// warpgroup i % 2, as its local step i / 2, and each stage (two steps)
// holds one step of each. At 64 rows one warpgroup takes every step, two
// a stage.
template <int MP, bool A8>
__device__ __forceinline__ void dec_consume(
    const uint8_t* smem, uint64_t* full, uint64_t* empty, float* xch,
    bf16* __restrict__ out, float* __restrict__ part, int M, int N, int j0,
    int g_begin, int g_end) {
  typedef DecCfg<MP, A8> C;
  typedef typename C::Acc Acc;
  constexpr int NR = C::NR;
  constexpr int NS = C::STEPS;
  constexpr bool DUAL = C::DUAL;
  const int wg = DUAL ? threadIdx.x / 128 : 0;
  const int tid = threadIdx.x % 128;
  const int w = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool hi = w >= 2;            // warps 2, 3: the high nibbles
  const int sh = hi ? 4 : 0;
  const int p0 = 16 * (w & 1) + g;   // the thread's packed rows p0, p0 + 8
  const int nh = N / 2;
  const int col0 = (hi ? nh : 0) + j0 + p0;   // output column of row p0
  const bool ok0 = j0 + p0 < nh, ok1 = j0 + p0 + 8 < nh;
  const int nk = g_end - g_begin;             // the run's steps (groups)
  const int n1 = nk / 2;                      // warpgroup 1's (DUAL)
  const int nl = DUAL ? (wg ? n1 : nk - n1) : nk;  // this warpgroup's

  float acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.f;
  // local step l: the run's step i(l), in stage stage(l), its x and weight
  // slices the half(l)-th of the stage
  auto step_of = [&](int l) { return DUAL ? 2 * l + wg : l; };
  auto stage = [&](int l) {
    return smem + ((DUAL ? l : l / 2) % DEC_STAGES) * C::STAGE;
  };
  auto half = [&](int l) { return DUAL ? wg : l & 1; };
  // acc += (float(d) * xs[row]) * s[col] (w4a8) or d * s[col]
  // (weight-only), the plain versions' order, with the scales that came
  // with local step l's stage (its two groups). With two warpgroups, w4a8
  // keeps the order across them: warpgroup 1 hands each group's term to
  // warpgroup 0 through xch (two slots of NR x 128 floats), which adds it
  // after its own group's.
  auto fold = [&](const Acc (&d)[NR], int l) {
    const int i = step_of(l);
    const int j = i & 1;                      // the stage's first or second
    const float* aux =
        reinterpret_cast<const float*>(stage(l) + C::AUX) + 64 * j;
    const float sv[2] = {aux[(hi ? 32 : 0) + p0],
                         aux[(hi ? 32 : 0) + p0 + 8]};
    const float* xr =
        reinterpret_cast<const float*>(stage(l) + C::AUX) + 128 + MP * j;
    float term[NR];
#pragma unroll
    for (int q = 0; q < MP / 8; ++q) {
      float xv[2] = {0.f, 0.f};
      if constexpr (A8) {
        // xs / 16, exact (xs >= 1e-8): (float(16 d) * xs / 16) is
        // float(d) * xs to the last bit
        const float2 x = *reinterpret_cast<const float2*>(xr + 8 * q + 2 * t);
        xv[0] = __fmul_rn(x.x, 0.0625f);
        xv[1] = __fmul_rn(x.y, 0.0625f);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * q + e;
        if constexpr (A8) {
          // d is 16 times the group's dot: |16 d| <= 16 * 127 * 8 * 128
          // < 2^22
          const float f = small_i2f(d[r]);
          term[r] = __fmul_rn(__fmul_rn(f, xv[e & 1]), sv[e >> 1]);
        } else {
          term[r] = __fmul_rn(d[r], sv[e >> 1]);
        }
      }
    }
    if (DUAL && A8 && wg == 1) {
      const int b = l & 1;
      if (l >= 2) hopper::bar_sync(BAR_EMPTY + b);
#pragma unroll
      for (int r = 0; r < NR; ++r) xch[(b * NR + r) * 128 + tid] = term[r];
      hopper::bar_arrive(BAR_FULL + b);
      return;
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[r] = __fadd_rn(acc[r], term[r]);
    if (DUAL && A8 && i + 1 < nk) {
      const int b = l & 1;
      hopper::bar_sync(BAR_FULL + b);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        acc[r] = __fadd_rn(acc[r], xch[(b * NR + r) * 128 + tid]);
      }
      if (l + 2 < n1) hopper::bar_arrive(BAR_EMPTY + b);
    }
  };
  auto absorb = [&](Acc (&d)[NR], int l) {
#pragma unroll
    for (int r = 0; r < NR; ++r) hopper::fence_operand(d[r]);
    fold(d, l);
  };

  // local step l's A fragments, after (WAIT) its stage's full barrier:
  // w4a8 a[ks][j] = rows p0 + 8 (j & 1), bytes 32ks + 16 (j >> 1) + 4t
  // .. + 3, sign-extended nibbles; weight-only a[ks] = the bf16 pairs of
  // rows p0 / p0 + 8 at bytes 16ks + 2t (+ 8)
  auto load_a = [&](int l, bool wait, uint32_t (&a)[NS][4]) {
    if (wait) {
      const int sl = DUAL ? l : l / 2;
      hopper::mbar_wait(&full[sl % DEC_STAGES], (sl / DEC_STAGES) & 1);
    }
    const uint8_t* wt = stage(l) + C::X_BYTES + half(l) * DEC_W_BYTES;
#pragma unroll
    for (int ks = 0; ks < NS; ++ks) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (A8) {
          // each byte's nibble moved to its top (the low one shifted up):
          // the signed byte is 16 c, one LOP3 and for the low nibbles a
          // shift
          a[ks][j] = (hopper::sw128_u32(wt, p0 + 8 * (j & 1),
                                        32 * ks + 16 * (j >> 1) + 4 * t)
                      << (4 - sh)) & 0xF0F0F0F0u;
        } else {
          const uint32_t v = sw128_u16(wt, p0 + 8 * (j & 1),
                                       16 * ks + 8 * (j >> 1) + 2 * t);
          a[ks][j] = hopper::nibbles_bf16x2<false>(
              __byte_perm(v, 0u, 0x4140) >> sh);
        }
      }
    }
  };
  // each consumer warp gives a stage back once the wgmmas of its last
  // step there are done and it has read the stage's fragments and scales
  // with ordinary loads
  auto release = [&](int l) {
    __syncwarp();
    if (lane == 0) {
      hopper::mbar_arrive(&empty[(DUAL ? l : l / 2) % DEC_STAGES]);
    }
  };
  // x's slices of local step l: MP 128-byte rows a 64-deep (bf16) or
  // 128-deep (xq) chunk, the chunks one after another
  auto issue = [&](int l, const uint32_t (&a)[NS][4], Acc (&d)[NR]) {
    const uint64_t desc = hopper::desc_sw128(
        stage(l) + half(l) * (C::X_BYTES / 2));
    hopper::wgmma_fence();
    if constexpr (A8) {
      dec_s8_rs_zero(d, a[0], desc);
#pragma unroll
      for (int ks = 1; ks < NS; ++ks) dec_s8_rs(d, a[ks], desc + 2 * ks);
    } else {
      // the step's second chunk: +MP * 128 bytes, MP * 8 in 16-byte units
      dec_bf16_rs_zero(d, a[0], desc);
#pragma unroll
      for (int ks = 1; ks < NS; ++ks) {
        dec_bf16_rs(d, a[ks], desc + (ks / 4) * MP * 8 + 2 * (ks % 4));
      }
    }
    hopper::wgmma_commit();
  };

  Acc d0[NR], d1[NR];
  uint32_t a0[NS][4], a1[NS][4];
  // Local step l (its fragments in ac, loaded the step before) once step
  // l - 1's wgmmas are done: its wgmmas into dc, then, while they run, step
  // l - 1's dp absorbed (and its stage released when the warpgroup is done
  // there: REL), and, at the call, step l + 1's fragments loaded. As K7's
  // loop (int8_grouped_fwd.cu): every read of an accumulator follows a
  // wgmma_wait<0> in straight-line code, the loop is unrolled by two so
  // that each step's parity (and with it each accumulator, each barrier
  // wait and each release) is known where it is written, and the tail is
  // picked before the wait (issuing a step before the previous one's wait
  // made ptxas serialise the wgmmas, C7514).
  auto step = [&](int l, const uint32_t (&ac)[NS][4], Acc (&dc)[NR],
                  Acc (&dp)[NR], bool rel) {
    hopper::wgmma_wait<0>();
    issue(l, ac, dc);
    absorb(dp, l - 1);
    if (rel) release(l - 1);
  };
  if (nl == 0) return;
  load_a(0, true, a0);
  if (nl == 1) {
    issue(0, a0, d0);
    hopper::wgmma_wait<0>();
    absorb(d0, 0);
    release(0);
  } else {
    issue(0, a0, d0);
    load_a(1, DUAL, a1);
    // step l in d[l % 2], a[l % 2]; l odd at the tail. Without DUAL a
    // stage holds local steps 2m and 2m + 1: the even ones wait, the odd
    // ones release
    int l = 1;
    for (; l + 2 < nl; l += 2) {
      step(l, a1, d1, d0, DUAL);
      load_a(l + 1, true, a0);
      step(l + 1, a0, d0, d1, true);
      load_a(l + 2, DUAL, a1);
    }
    if (nl - l == 2) {
      step(l, a1, d1, d0, DUAL);
      load_a(l + 1, true, a0);
      step(l + 1, a0, d0, d1, true);
      hopper::wgmma_wait<0>();
      absorb(d0, nl - 1);
      release(nl - 1);
    } else {
      step(l, a1, d1, d0, DUAL);
      hopper::wgmma_wait<0>();
      absorb(d1, nl - 1);
      release(nl - 1);
    }
  }

  if constexpr (DUAL) {
    // weight-only: warpgroup 1's sum (the odd groups) added to warpgroup
    // 0's (the even ones); w4a8's terms went across in the fold
    if constexpr (!A8) {
      if (wg == 1) {
#pragma unroll
        for (int r = 0; r < NR; ++r) xch[r * 128 + tid] = acc[r];
        hopper::bar_arrive(BAR_FULL);
      } else if (n1 > 0) {
        hopper::bar_sync(BAR_FULL);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          acc[r] = __fadd_rn(acc[r], xch[r * 128 + tid]);
        }
      }
    }
    if (wg == 1) return;
  }
  if (part != nullptr) {
    // run blockIdx.y's f32 sums: acc[4q + e] is row 8q + 2t + (e & 1),
    // column col0 + 8 (e >> 1)
    float* pr = part + static_cast<long long>(blockIdx.y) * M * N;
#pragma unroll
    for (int q = 0; q < MP / 8; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 8 * q + 2 * t + (e & 1);
        if (row < M && ((e >> 1) ? ok1 : ok0)) {
          pr[static_cast<long long>(row) * N + col0 + 8 * (e >> 1)] =
              acc[4 * q + e];
        }
      }
    }
    return;
  }
  // threads g and g ^ 1 swap one value, so that each holds two adjacent
  // columns of one row (int4_fwd.cu's epilogue)
  const bool odd = g & 1;
#pragma unroll
  for (int q = 0; q < MP / 8; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 8 * q + 2 * t + (odd ? 1 : 0);
      const int j = j0 + p0 - (odd ? 1 : 0) + 8 * h;   // even
      const float v0 = acc[4 * q + 2 * h], v1 = acc[4 * q + 2 * h + 1];
      const float recv = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
      if (row < M && j < nh) {
        const float lo = odd ? recv : v0, hi_v = odd ? v1 : recv;
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * N +
                                     (hi ? nh : 0) + j) =
            flash::pack_f32(lo, hi_v);
      }
    }
  }
}

// Grid (ceil(N/2 / 32) tiles, runs); THREADS: warps 0-3 (and 4-7 up to 32
// rows) the consumer warpgroups, then the producer warp, one lane of which
// issues the loads.
template <int MP, bool A8>
__global__ void __launch_bounds__(DecCfg<MP, A8>::THREADS, 1)
int4_decode_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ CUtensorMap s_map,
                   const __grid_constant__ CUtensorMap xs_map,
                   bf16* __restrict__ out, float* __restrict__ part, int M,
                   int N, int K) {
  typedef DecCfg<MP, A8> C;
  constexpr int CONSUMERS = C::DUAL ? 256 : 128;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment for the swizzled tiles
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) &
                              1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DEC_STAGES * C::STAGE);
  uint64_t* empty = full + DEC_STAGES;
  float* xch = reinterpret_cast<float*>(empty + DEC_STAGES);
  const int j0 = blockIdx.x * DEC_P;
  const int groups = K / DEC_STEP;
  // run blockIdx.y of gridDim.y: a contiguous share of the groups
  const int g_begin = static_cast<int>(
      static_cast<long long>(groups) * blockIdx.y / gridDim.y);
  const int g_end = static_cast<int>(
      static_cast<long long>(groups) * (blockIdx.y + 1) / gridDim.y);
  const int stages = (g_end - g_begin + 1) / 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DEC_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      // one arrive a consumer warp (the last stage of an odd step count
      // with two warpgroups gets only warpgroup 0's: it is never reused)
      hopper::mbar_init(&empty[s], CONSUMERS / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // the producer warp: one lane issues each stage's TMA loads (x, the
    // weight, the scales of the stage's first group and the next, and for
    // w4a8 their row scales); a stage is two 128-deep steps
    if (threadIdx.x == CONSUMERS) {
      for (int i = 0; i < stages; ++i) {
        const int s = i % DEC_STAGES;
        if (i >= DEC_STAGES) {
          hopper::mbar_wait(&empty[s], (i / DEC_STAGES - 1) & 1);
        }
        uint8_t* st = smem + s * C::STAGE;
        const int kb = g_begin + 2 * i;              // the first step
        float* aux = reinterpret_cast<float*>(st + C::AUX);
        hopper::mbar_arrive_expect_tx(&full[s], C::TX_BYTES);
        hopper::tma_load_3d(st, &x_map, &full[s], 0, 0,
                            kb * (A8 ? 1 : 2));      // x's chunk index
        hopper::tma_load_3d(st + C::X_BYTES, &w_map, &full[s], 0, j0, kb);
        hopper::tma_load_3d(aux, &s_map, &full[s], j0, 0, kb);
        if constexpr (A8) hopper::tma_load_2d(aux + 128, &xs_map, &full[s], 0, kb);
      }
    }
  } else {
    dec_consume<MP, A8>(smem, full, empty, xch, out, part, M, N, j0, g_begin,
                        g_end);
  }
}

// out = bf16(part[0] + part[1] + ... ), the runs in order: 4 elements a
// thread (M x N is a multiple of 16)
__global__ void int4_decode_sum_kernel(const float* __restrict__ part,
                                       bf16* __restrict__ out, int splits,
                                       long long n) {
  const long long e =
      4 * (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (e >= n) return;
  float4 v = *reinterpret_cast<const float4*>(part + e);
  for (int s = 1; s < splits; ++s) {
    const float4 u = *reinterpret_cast<const float4*>(part + s * n + e);
    v.x = __fadd_rn(v.x, u.x);
    v.y = __fadd_rn(v.y, u.y);
    v.z = __fadd_rn(v.z, u.z);
    v.w = __fadd_rn(v.w, u.w);
  }
  *reinterpret_cast<uint2*>(out + e) =
      make_uint2(flash::pack_f32(v.x, v.y), flash::pack_f32(v.z, v.w));
}

template <int MP, bool A8>
cudaError_t launch_mp(const CUtensorMap* maps, bf16* out, float* part, int M,
                      int N, int K, int splits, cudaStream_t st) {
  typedef DecCfg<MP, A8> C;
  auto kernel = int4_decode_kernel<MP, A8>;
  cudaError_t err = hopper::smem_opt_in(kernel, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N / 2 + DEC_P - 1) / DEC_P, splits);
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(maps[0], maps[1], maps[2],
                                             maps[3], out, part, M, N, K);
  return cudaGetLastError();
}

template <bool A8>
cudaError_t launch_rows(const CUtensorMap* maps, bf16* out, float* part,
                        int M, int N, int K, int splits, cudaStream_t st) {
  if (M <= 8) return launch_mp<8, A8>(maps, out, part, M, N, K, splits, st);
  if (M <= 16) return launch_mp<16, A8>(maps, out, part, M, N, K, splits, st);
  if (M <= 32) return launch_mp<32, A8>(maps, out, part, M, N, K, splits, st);
  return launch_mp<64, A8>(maps, out, part, M, N, K, splits, st);
}

int rows_rounded(int M) {
  return M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : 64;
}

}  // namespace

// K8 for x of 1 to 64 rows. xq (M, K) int8 and xs (K / group, M rounded up
// to 4) f32 are the w4a8 branch's scratch (its quantize pass writes them);
// part (splits, M, N) f32 the weight-only branch's when splits > 1 (w4a8
// takes splits == 1). scale_g must be 16-byte aligned (TMA).
extern "C" int int4_decode(const void* x, const void* kq4,
                           const void* scale_g, void* xq, void* xs,
                           void* part, void* out, int M, int N, int K,
                           int group, int act_quant, int splits,
                           void* stream) {
  if (M <= 0 || M > 64 || N <= 0 || K <= 0 || N % 16 != 0 ||
      group != DEC_STEP || K % group != 0 || splits < 1 ||
      splits > K / group || (act_quant && splits != 1) ||
      (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nh = N / 2;
  const int mp = rows_rounded(M);
  const uint64_t groups = K / group;
  cudaError_t err = cudaSuccess;
  if (act_quant) err = quant::launch_quantize(x, xq, xs, M, K, group, st);
  // x (or xq) as (64 or 128 columns, M rows, K / chunk chunks), a stage's
  // box MP rows of 4 (2) chunks; the packed weight as (128 bytes, N/2
  // rows, K / 128 chunks), a box 32 rows of 2 chunks; scale_g as (N/2
  // columns, 2 halves, G groups), a box 32 columns of both halves of 2
  // groups; xs (w4a8; the weight-only branch passes the scale map again)
  // MP row scales of 2 groups
  CUtensorMap maps[4];
  if (err == cudaSuccess) {
    err = act_quant
              ? hopper::make_map_3d(&maps[0], xq,
                                    CU_TENSOR_MAP_DATA_TYPE_UINT8, 128, M,
                                    K / 128, K, 128, 128, mp, 2,
                                    CU_TENSOR_MAP_SWIZZLE_128B)
              : hopper::make_map_3d(&maps[0], x,
                                    CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 64, M,
                                    K / 64, 2ull * K, 128, 64, mp, 4,
                                    CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == cudaSuccess) {
    err = hopper::make_map_3d(&maps[1], kq4, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                              128, nh, K / 128, K, 128, 128, DEC_P, 2,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == cudaSuccess) {
    err = hopper::make_map_3d(&maps[2], scale_g,
                              CU_TENSOR_MAP_DATA_TYPE_FLOAT32, nh, 2, groups,
                              4ull * nh, 4ull * N, DEC_P, 2, 2,
                              CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  maps[3] = maps[2];
  if (err == cudaSuccess && act_quant) {
    err = hopper::make_map_2d(&maps[3], xs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                              4, groups, quant::xs_pitch(M), 2, mp,
                              CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  bf16* o = static_cast<bf16*>(out);
  float* pt = splits > 1 ? static_cast<float*>(part) : nullptr;
  err = act_quant ? launch_rows<true>(maps, o, pt, M, N, K, splits, st)
                  : launch_rows<false>(maps, o, pt, M, N, K, splits, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(M) * N;
  const long long blocks = (n / 4 + 255) / 256;
  int4_decode_sum_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      pt, o, splits, n);
  return static_cast<int>(cudaGetLastError());
}
