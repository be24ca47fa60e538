// The decode routes of K3 and K7: the w8a8 per-channel forward (K3:
// --quantize w8a8, w8a8d and their rotated modes) and the grouped one (K7:
// w8a8g, w8a8o) for x of at most 64 rows, the shapes of generation's decode
// steps (32 rows, one a sequence) and of the adapter prefix (10 rows, in
// training too). int8_fwd.cu and int8_grouped_fwd.cu keep the calls of more
// rows.
//
// Replaces, for those shapes, the TPU kernels int8_fwd_pallas ->
// _fwd_kernel (flipped_tpu/model/pallas/quant_matmul.py:603-698) and
// grouped_matmul_pallas -> _kernel (:55-145), and computes what int8_fwd.cu
// and int8_grouped_fwd.cu compute, bit for bit their plain versions
// (int8_fwd_ref, grouped_matmul_ref), for x (M, K) bf16 and kq (N, K) int8:
//   K3, scale (N,) f32: xs[m] = max(amax_k |x[m, k]| * float32(1/127),
//     1e-8) (a reciprocal multiply), xq = rint(x / xs) half to even, d = the
//     exact int32 dot over all of K, out = bf16((float(d) * xs[m]) *
//     scale[n]).
//   K7, scale_g (K / 128, N) f32: quant_common.cuh's per-(row, group)
//     quantize (amax / 127, a division), one exact int32 dot d_g a group,
//     out = bf16(sum_g (float(d_g) * xs_g[m]) * s_g[n]), the groups added
//     in order 0..G-1 into one f32 sum, each step rounded.
//
// What bounds it on an H100: a decode call reads its weight once, 16.8 MB
// (4096 -> 4096) or 45.1 MB (4096 -> 11008, 11008 -> 4096) of int8: 5.0 and
// 13.5 us at 3.35 TB/s, beside 0.5-1.4 G multiply-adds at 32 rows (under a
// microsecond at the int8 peak). The bytes bound it, and HBM gives its rate
// only to loads from most of the 132 SMs at once: int8_fwd.cu's 128 x 256
// tiles made 16 blocks at N 4096 and wasted three quarters of every
// m64n256 wgmma on zero rows, int8_grouped_fwd.cu's 128 x 128 tiles 32
// blocks. The design (int4_decode.cu's, on int8 weights):
//   - out^T = W . x^T: a block owns 64 output columns, the weight's 64 rows
//     wgmma's M side, x's rows its N, M rounded up to 8, 16, 32 or 64
//     (m64nNk32 s8). Both operands are K-major int8 in shared memory exactly
//     as TMA wrote them (SS form, 128-byte swizzle), so the weight needs no
//     register conversion (K8's nibbles do). Rows past M, columns past N and
//     the contraction past K come in as zeros. 64 tiles at N 4096, 172 at N
//     11008.
//   - a grid that runs in one wave of one block an SM (K7 up to 132 tiles,
//     K3 where the runtime says its clusters fit at once) takes a ring as
//     deep as 192 KB holds (up to 8 stages): a block's bytes in flight
//     bounded it (K7 at 11008 -> 4096 went from 0.036 to 0.026 ms on an
//     H100 80GB HBM3 at 700 W); a larger grid takes rings of about 100 KB,
//     two blocks an SM.
//   - a producer lane keeps a ring of 256-deep stages full by TMA: K3 two
//     2-D boxes of xq and two of the weight a stage (2-D maps: K need only
//     be a multiple of 16; a second half past K is not loaded), K7 one 3-D
//     box of each (the stage's two 128-wide groups) and two of the scales
//     of its two groups (s_g's 64 columns, xs_g's MP rows, the quantize
//     pass's transposed row scales): the TMA unit's cost is about per box.
//   - K3: the int32 sums are exact in any order, so the contraction is cut
//     into `runs` of whole stages, each a block, until the tiles times the
//     runs fill the card (quant_matmul.py's int8_decode_splits: 2 at N
//     4096, 4 at N 2048, none at N 11008). The runs of a tile are one
//     thread-block cluster: each writes its int32 sums to its shared
//     memory, rank 0 adds the others' (exact: two calls give the same
//     bits; no atomics, no second kernel) and applies the epilogue once on
//     the full sum, in JAX's order. One consumer warpgroup issues each
//     128-deep chunk's four wgmmas as a group of their own (a conditional
//     second chunk inside one group made ptxas serialise the wgmmas,
//     C7520) and gives a stage back once its wgmmas are done (int8_fwd.cu's
//     wait<1> loop). The GEMM is a programmatic dependent launch of the
//     quantize pass: it loads its first stages' weight while the pass runs.
//   - K7: the group fold stays in order and is not split across blocks. Up
//     to 32 rows two consumer warpgroups take a tile's even and odd groups
//     (one of each a stage), warpgroup 1 hands each group's term (float(d_g)
//     * xs_g) * s_g to warpgroup 0 through shared memory and named barriers,
//     and warpgroup 0 adds it after its own group's; at 64 rows one
//     warpgroup takes every group (two would not have the registers). Each
//     warpgroup alternates two accumulators: once group i-1's wgmmas are
//     done, group i's are issued and group i-1 is folded while they run
//     (issuing a group before the previous one's wait made ptxas serialise
//     the wgmmas, C7514).
// The quantize passes stay launches of their own (K3's per-row pass, on
// wider blocks than int8_fwd.cu's; K7's quant_common.cuh pass): every
// block needs all of x's rows and their scales, so a quantize inside the
// GEMM would repeat M x K divisions in each of the 64-172 blocks. K7's
// GEMM launches after its pass as usual: as a programmatic dependent of a
// pass that does not signal early it ran slower.
// Not done (later work): K7's chain of group folds (its GEMM, not the
// weight's bytes, sets its time at 4096 -> 4096).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

#include "flash_common.cuh"
#include "hopper_common.cuh"
#include "quant_common.cuh"

namespace {

using quant::bf16;

constexpr int TILE_N = 64;                  // output columns a block
constexpr int CHUNK = 128;                  // contraction bytes a box row
constexpr int STAGE_K = 2 * CHUNK;          // contraction a stage
constexpr int W_CHUNK = TILE_N * CHUNK;     // 8 KB of kq a chunk
constexpr int GROUP = 128;                  // K7's group: one chunk
// |d| <= 127 * 127 * K stays an int32 up to this K
constexpr int MAX_K = 2147483647 / (127 * 127);
// K3's runs of a tile form one cluster: at most the portable cluster size
constexpr int MAX_RUNS = 8;

// MP: wgmma's N, M rounded up; GROUPED: K7; DEEP: one block an SM (the
// grid fits the card in one wave), the ring as deep as shared memory holds
template <int MP, bool GROUPED, bool DEEP>
struct Cfg {
  // a stage: x's (xq's) two chunks of MP rows, the weight's two of 64 rows,
  // then (K7) the scales of the stage's two groups: 64 column scales each,
  // then MP row scales each
  static constexpr int X_CHUNK = MP * CHUNK;
  static constexpr int X_BYTES = 2 * X_CHUNK;
  static constexpr int AUX = X_BYTES + 2 * W_CHUNK;
  static constexpr int STAGE = AUX + (GROUPED ? 1024 : 0);   // 1 KB multiple
  // two consumer warpgroups (K7 up to 32 rows) need the exchange slots, 2 x
  // NR x 128 floats: three stages then keep two blocks an SM; one block an
  // SM takes up to 8 stages in 192 KB
  static constexpr bool DUAL = GROUPED && MP <= 32;
  static constexpr int STAGES =
      DEEP ? (196608 / STAGE < 8 ? 196608 / STAGE : 8)
           : ((MP == 64 || DUAL) ? 3 : 4);
  static constexpr int NR = MP / 2;         // accumulator registers
  static constexpr int CONSUMERS = DUAL ? 256 : 128;
  static constexpr int THREADS = CONSUMERS + 32;   // and a producer warp
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 +
                              (DUAL ? 2 * NR * 128 * 4 : 0) + 1024;
};

// SS wgmma m64nNk32 (s8, s32 sums) for N = 8, 16, 32, 64, one overload a
// size of d (N / 2 registers): A (`da`) the weight's 64 rows and B (`db`)
// x's N rows, both K-major tiles in shared memory, 32 contraction bytes a
// step (+2 on a descriptor). D: d[4i + e] at (row 16w + g + 8 (e >> 1),
// column 8i + 2t + (e & 1)), lane = 4g + t: the row an output column, the
// column a row of x. The _zero forms write d (scale-d 0): a tile's first
// wgmma defines its accumulator, so no ordinary instruction writes it.

__device__ __forceinline__ void ss_s8_zero(int (&d)[4], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n"
      "}\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void ss_s8(int (&d)[4], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void ss_s8_zero(int (&d)[8], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n"
      "}\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]),
        "=r"(d[4]), "=r"(d[5]), "=r"(d[6]), "=r"(d[7])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void ss_s8(int (&d)[8], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void ss_s8_zero(int (&d)[16], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n"
      "}\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]),
        "=r"(d[4]), "=r"(d[5]), "=r"(d[6]), "=r"(d[7]),
        "=r"(d[8]), "=r"(d[9]), "=r"(d[10]), "=r"(d[11]),
        "=r"(d[12]), "=r"(d[13]), "=r"(d[14]), "=r"(d[15])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void ss_s8(int (&d)[16], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void ss_s8_zero(int (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]),
        "=r"(d[4]), "=r"(d[5]), "=r"(d[6]), "=r"(d[7]),
        "=r"(d[8]), "=r"(d[9]), "=r"(d[10]), "=r"(d[11]),
        "=r"(d[12]), "=r"(d[13]), "=r"(d[14]), "=r"(d[15]),
        "=r"(d[16]), "=r"(d[17]), "=r"(d[18]), "=r"(d[19]),
        "=r"(d[20]), "=r"(d[21]), "=r"(d[22]), "=r"(d[23]),
        "=r"(d[24]), "=r"(d[25]), "=r"(d[26]), "=r"(d[27]),
        "=r"(d[28]), "=r"(d[29]), "=r"(d[30]), "=r"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void ss_s8(int (&d)[32], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// 1024-byte alignment for the swizzled tiles
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (hopper::smem_addr(p) & 1023)) & 1023);
}

// Programmatic dependent launch: K3's GEMM, launched with
// cudaLaunchAttributeProgrammaticStreamSerialization (`launch_k3`), starts
// while its quantize pass runs, once that pass's blocks have all reached
// launch_dependents; grid_wait returns once the pass has completed and its
// writes are visible. The GEMM loads the weight (which does not depend on
// x) before it and xq after it.
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// out[row, col] = bf16(v[4q + e]) for the accumulator layout above: row
// 8q + 2t + (e & 1) of x, column col0 + 8 (e >> 1) with col0 = j0 + 16w +
// g. Threads g and g ^ 1 swap one value, so that each holds two adjacent
// columns of one row: one 4-byte store a pair (int4_decode.cu's epilogue).
template <int NR>
__device__ __forceinline__ void store_pairs(const float (&v)[NR],
                                            bf16* __restrict__ out, int M,
                                            int N, int col0, int g, int t) {
  const bool odd = g & 1;
#pragma unroll
  for (int q = 0; q < NR / 4; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 8 * q + 2 * t + (odd ? 1 : 0);
      const int j = col0 - (odd ? 1 : 0) + 8 * h;   // even
      const float v0 = v[4 * q + 2 * h], v1 = v[4 * q + 2 * h + 1];
      const float recv = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
      if (row < M && j < N) {                      // N even: j + 1 < N
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * N +
                                     j) =
            odd ? flash::pack_f32(recv, v1) : flash::pack_f32(v0, recv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3's quantize pass, int8_fwd.cu's arithmetic (int8_fwd_quantize_kernel) on
// wider blocks: one 1024-thread block a row (int8_fwd.cu's 256 threads left
// each thread 43 IEEE divisions in a row at K 11008, on at most 64 SMs),
// 16-byte loads of x, the row kept in registers between the amax and the
// codes (rows up to 1024 x 8 x QV = 16384 wide: every 7B K; a longer row
// reads x a second time), 8 codes stored at once; xq (M, K) int8 and xs
// (M,) f32. It lets the GEMM start at once.
// ---------------------------------------------------------------------------
constexpr int QTHREADS = 1024;
constexpr int QV = 2;             // 8-wide vectors a thread keeps on chip

__device__ __forceinline__ void load8(const bf16* xr, int v, float f[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(xr + 8 * v);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p = __bfloat1622float2(e[j]);
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

__device__ __forceinline__ void store_codes8(int8_t* qr, int v,
                                             const float f[8], float s) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t q =
        static_cast<uint32_t>(__float2int_rn(__fdiv_rn(f[e], s))) & 0xffu;
    w[e >> 2] |= q << (8 * (e & 3));
  }
  *reinterpret_cast<uint2*>(qr + 8 * v) = make_uint2(w[0], w[1]);
}

__global__ void __launch_bounds__(QTHREADS)
int8_decode_quantize_kernel(const bf16* __restrict__ x,
                            int8_t* __restrict__ xq, float* __restrict__ xs,
                            int K) {
  __shared__ float red[QTHREADS / 32];
  launch_dependents();          // the GEMM may start loading its weight
  const long long row = blockIdx.x;
  const bf16* xr = x + row * K;
  int8_t* qr = xq + row * K;
  const int nvec = K / 8;

  float keep[QV][8];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < QV; ++j) {
    const int v = threadIdx.x + j * QTHREADS;
    if (v < nvec) {
      load8(xr, v, keep[j]);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(keep[j][e]));
    }
  }
  for (int v = threadIdx.x + QV * QTHREADS; v < nvec; v += QTHREADS) {
    float f[8];
    load8(xr, v, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(f[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < QTHREADS / 32; ++w) amax = fmaxf(amax, red[w]);
  const float s = fmaxf(__fmul_rn(amax, quant::INV127), quant::EPS);
  if (threadIdx.x == 0) xs[row] = s;

#pragma unroll
  for (int j = 0; j < QV; ++j) {
    const int v = threadIdx.x + j * QTHREADS;
    if (v < nvec) store_codes8(qr, v, keep[j], s);
  }
  for (int v = threadIdx.x + QV * QTHREADS; v < nvec; v += QTHREADS) {
    float f[8];
    load8(xr, v, f);
    store_codes8(qr, v, f, s);
  }
}

// ---------------------------------------------------------------------------
// K3: grid (tiles of 64 output columns, runs), the runs of a tile one
// cluster; warps 0-3 the consumer warpgroup, warp 4 the producer, one lane
// of which issues the loads. Run r (the block's rank in its cluster) takes
// a contiguous share of the ceil(K / 256) stages; the runs' int32 sums meet
// in rank 0's registers through the cluster's shared memory, and rank 0
// applies the epilogue.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every (non-exited) thread of the cluster: shared-memory writes before it
// are visible to the cluster's reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the int32 at shared address `addr` of the cluster's block `rank`
__device__ __forceinline__ int ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  int v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n"
               : "=r"(v)
               : "r"(remote)
               : "memory");
  return v;
}

template <int MP, bool DEEP>
__global__ void __launch_bounds__(Cfg<MP, false, DEEP>::THREADS, DEEP ? 1 : 2)
int8_decode_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w_map,
                   const float* __restrict__ xs,
                   const float* __restrict__ scale, bf16* __restrict__ out,
                   int M, int N, int K) {
  typedef Cfg<MP, false, DEEP> C;
  constexpr int NR = C::NR;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;
  const int j0 = blockIdx.x * TILE_N;
  const int runs = gridDim.y;
  const int run = static_cast<int>(cluster_rank());
  const int all = (K + STAGE_K - 1) / STAGE_K;
  const int s_begin = all * run / runs;
  const int nst = all * (run + 1) / runs - s_begin;   // >= 1: runs <= all
  const int k_begin = s_begin * STAGE_K;
  const int k_end = min(K, k_begin + nst * STAGE_K);
  const int nch = (k_end - k_begin + CHUNK - 1) / CHUNK;   // 128-deep chunks

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);         // one arrive a consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= C::CONSUMERS) {
    // the producer lane: stage i's weight chunks (the first STAGES stages'
    // before the quantize pass has ended), then its xq chunks; the last
    // stage of K has one chunk where K ends in its first half
    if (threadIdx.x == C::CONSUMERS) {
      auto chunks = [&](int i) { return min(2, nch - 2 * i); };
      auto weights = [&](int i) {
        uint64_t* bar = &full[i % C::STAGES];
        uint8_t* st = smem + (i % C::STAGES) * C::STAGE;
        const int k0 = k_begin + i * STAGE_K;
        hopper::mbar_arrive_expect_tx(bar,
                                      chunks(i) * (C::X_CHUNK + W_CHUNK));
        for (int c = 0; c < chunks(i); ++c) {
          hopper::tma_load_2d(st + C::X_BYTES + c * W_CHUNK, &w_map, bar,
                              k0 + c * CHUNK, j0);
        }
      };
      const int pre = min(nst, C::STAGES);
      for (int i = 0; i < pre; ++i) weights(i);
      grid_wait();
      for (int i = 0; i < nst; ++i) {
        const int s = i % C::STAGES;
        if (i >= pre) {
          hopper::mbar_wait(&empty[s], (i / C::STAGES - 1) & 1);
          weights(i);
        }
        uint8_t* st = smem + s * C::STAGE;
        for (int c = 0; c < chunks(i); ++c) {
          hopper::tma_load_2d(st + c * C::X_CHUNK, &x_map, &full[s],
                              k_begin + i * STAGE_K + c * CHUNK, 0);
        }
      }
    }
    return;
  }

  grid_wait();                  // xs, read in the epilogue
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  int d[NR];
  // chunk c's four wgmmas (half c & 1 of stage c / 2, whose full barrier an
  // even chunk waits for) into d, a group of their own; the first writes d
  auto issue = [&](int c, bool first) {
    const int s = (c / 2) % C::STAGES;
    if ((c & 1) == 0) hopper::mbar_wait(&full[s], (c / 2 / C::STAGES) & 1);
    const uint8_t* st = smem + s * C::STAGE;
    const uint64_t da =
        hopper::desc_sw128(st + C::X_BYTES + (c & 1) * W_CHUNK);
    const uint64_t db = hopper::desc_sw128(st + (c & 1) * C::X_CHUNK);
    hopper::wgmma_fence();
    if (first) {
      ss_s8_zero(d, da, db);
    } else {
      ss_s8(d, da, db);
    }
#pragma unroll
    for (int ks = 1; ks < CHUNK / 32; ++ks) {
      ss_s8(d, da + 2 * ks, db + 2 * ks);
    }
    hopper::wgmma_commit();
  };
  issue(0, true);
  for (int c = 1; c < nch; ++c) {
    issue(c, false);
    hopper::wgmma_wait<1>();
    // chunk c - 1 is done: an odd one was its stage's last, and each
    // consumer warp gives the stage back
    if (c & 1) continue;
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[((c - 1) / 2) % C::STAGES]);
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < NR; ++r) hopper::fence_operand(d[r]);

  if (runs > 1) {
    // the runs' sums, exact in any order: each block's to its shared
    // memory (the ring, whose loads and wgmmas are all done), then rank 0
    // adds the others'
    int* red = reinterpret_cast<int*>(smem);
#pragma unroll
    for (int r = 0; r < NR; ++r) red[r * 128 + threadIdx.x] = d[r];
    cluster_sync();
    if (run == 0) {
      const uint32_t base = hopper::smem_addr(red) + 4 * threadIdx.x;
      for (int q = 1; q < runs; ++q) {
#pragma unroll
        for (int r = 0; r < NR; ++r) d[r] += ld_cluster(base + 512 * r, q);
      }
    }
    cluster_sync();             // rank 0 has read every block's sums
    if (run != 0) return;
  }
  // d[4q + e]: row 8q + 2t + (e & 1) of x, column col0 + 8 (e >> 1)
  const int col0 = j0 + 16 * w + g;
  const float sc[2] = {col0 < N ? scale[col0] : 0.f,
                       col0 + 8 < N ? scale[col0 + 8] : 0.f};
  float v[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int row = 8 * (r / 4) + 2 * t + (r & 1);
    const float xv = row < M ? xs[row] : 0.f;
    v[r] = __fmul_rn(__fmul_rn(__int2float_rn(d[r]), xv), sc[(r >> 1) & 1]);
  }
  store_pairs(v, out, M, N, col0, g, t);
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------
// named barrier ids: 1 + b (exchange slot b full), 3 + b (slot b empty)
constexpr int BAR_FULL = 1, BAR_EMPTY = 3;

// A consumer warpgroup of the block's `nk` groups: its fold into acc, then
// (warpgroup 0) the epilogue. Up to 32 rows two warpgroups share the
// groups: group i goes to warpgroup i % 2 as its local step i / 2, and each
// stage holds one group of each. At 64 rows one warpgroup takes every
// group, two a stage.
template <int MP, bool DEEP>
__device__ __forceinline__ void grouped_consume(
    const uint8_t* smem, uint64_t* full, uint64_t* empty, float* xch,
    bf16* __restrict__ out, int M, int N, int j0, int nk) {
  typedef Cfg<MP, true, DEEP> C;
  constexpr int NR = C::NR;
  constexpr bool DUAL = C::DUAL;
  const int wg = DUAL ? threadIdx.x / 128 : 0;
  const int tid = threadIdx.x % 128;
  const int w = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * w + g;                  // the thread's tile columns
  const int n1 = nk / 2;                      // warpgroup 1's steps (DUAL)
  const int nl = DUAL ? (wg ? n1 : nk - n1) : nk;   // this warpgroup's

  float acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.f;
  // local step l: group i(l), in stage slot(l), the half i(l) & 1 of it
  auto group_of = [&](int l) { return DUAL ? 2 * l + wg : l; };
  auto slot = [&](int l) { return DUAL ? l : l / 2; };
  auto stage = [&](int l) {
    return smem + (slot(l) % C::STAGES) * C::STAGE;
  };
  // acc += (float(d) * xs[row]) * s[col], the plain version's order, with
  // the scales that came with local step l's stage. With two warpgroups the
  // order holds across them: warpgroup 1 hands each group's term to
  // warpgroup 0 through xch (two slots of NR x 128 floats), which adds it
  // after its own group's.
  auto fold = [&](const int (&d)[NR], int l) {
    const int i = group_of(l);
    const int j = i & 1;                      // the stage's first or second
    const float* aux = reinterpret_cast<const float*>(stage(l) + C::AUX);
    const float sv[2] = {aux[TILE_N * j + r0], aux[TILE_N * j + r0 + 8]};
    const float* xr = aux + 2 * TILE_N + MP * j;
    float term[NR];
#pragma unroll
    for (int q = 0; q < MP / 8; ++q) {
      const float2 x = *reinterpret_cast<const float2*>(xr + 8 * q + 2 * t);
      const float xv[2] = {x.x, x.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * q + e;
        term[r] = __fmul_rn(__fmul_rn(__int2float_rn(d[r]), xv[e & 1]),
                            sv[e >> 1]);
      }
    }
    if (DUAL && wg == 1) {
      const int b = l & 1;
      if (l >= 2) hopper::bar_sync(BAR_EMPTY + b);
#pragma unroll
      for (int r = 0; r < NR; ++r) xch[(b * NR + r) * 128 + tid] = term[r];
      hopper::bar_arrive(BAR_FULL + b);
      return;
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[r] = __fadd_rn(acc[r], term[r]);
    if (DUAL && i + 1 < nk) {
      const int b = l & 1;
      hopper::bar_sync(BAR_FULL + b);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        acc[r] = __fadd_rn(acc[r], xch[(b * NR + r) * 128 + tid]);
      }
      if (l + 2 < n1) hopper::bar_arrive(BAR_EMPTY + b);
    }
  };
  auto absorb = [&](int (&d)[NR], int l) {
#pragma unroll
    for (int r = 0; r < NR; ++r) hopper::fence_operand(d[r]);
    fold(d, l);
  };
  auto wait_full = [&](int l) {
    const int sl = slot(l);
    hopper::mbar_wait(&full[sl % C::STAGES], (sl / C::STAGES) & 1);
  };
  // each consumer warp gives a stage back once the wgmmas of its last
  // group there are done and it has read the stage's scales
  auto release = [&](int l) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[slot(l) % C::STAGES]);
  };
  // local step l's four wgmmas: the weight's and x's chunk of its group
  auto issue = [&](int l, int (&d)[NR]) {
    const int j = group_of(l) & 1;
    const uint64_t da = hopper::desc_sw128(stage(l) + C::X_BYTES +
                                           j * W_CHUNK);
    const uint64_t db = hopper::desc_sw128(stage(l) + j * C::X_CHUNK);
    hopper::wgmma_fence();
    ss_s8_zero(d, da, db);
#pragma unroll
    for (int ks = 1; ks < GROUP / 32; ++ks) {
      ss_s8(d, da + 2 * ks, db + 2 * ks);
    }
    hopper::wgmma_commit();
  };

  int d0[NR], d1[NR];
  // Local step l into dc once step l - 1's wgmmas are done, then, while
  // they run, step l - 1's dp absorbed (and its stage released when the
  // warpgroup is done there: REL). As int8_grouped_fwd.cu's loop: every
  // read of an accumulator follows a wgmma_wait<0> in straight-line code,
  // the loop is unrolled by two so that each step's accumulator is known
  // where it is written, and the tail is picked before the wait.
  auto step = [&](int l, int (&dc)[NR], int (&dp)[NR], bool rel) {
    hopper::wgmma_wait<0>();
    issue(l, dc);
    absorb(dp, l - 1);
    if (rel) release(l - 1);
  };
  if (nl == 0) return;
  wait_full(0);
  if (nl == 1) {
    issue(0, d0);
    hopper::wgmma_wait<0>();
    absorb(d0, 0);
    release(0);
  } else {
    issue(0, d0);
    if (DUAL) wait_full(1);
    // step l in d[l % 2]; l odd at the tail. Without DUAL a stage holds
    // local steps 2m and 2m + 1: the even ones wait, the odd ones release
    int l = 1;
    for (; l + 2 < nl; l += 2) {
      step(l, d1, d0, DUAL);
      wait_full(l + 1);
      step(l + 1, d0, d1, true);
      if (DUAL) wait_full(l + 2);
    }
    if (nl - l == 2) {
      step(l, d1, d0, DUAL);
      wait_full(l + 1);
      step(l + 1, d0, d1, true);
      hopper::wgmma_wait<0>();
      absorb(d0, nl - 1);
      release(nl - 1);
    } else {
      step(l, d1, d0, DUAL);
      hopper::wgmma_wait<0>();
      absorb(d1, nl - 1);
      release(nl - 1);
    }
  }
  if (DUAL && wg == 1) return;
  store_pairs(acc, out, M, N, j0 + r0, g, t);
}

// Grid (tiles of 64 output columns); THREADS: the consumer warpgroups, then
// the producer warp, one lane of which issues the loads.
template <int MP, bool DEEP>
__global__ void __launch_bounds__(Cfg<MP, true, DEEP>::THREADS, DEEP ? 1 : 2)
int8_grouped_decode_kernel(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap w_map,
                           const __grid_constant__ CUtensorMap s_map,
                           const __grid_constant__ CUtensorMap xs_map,
                           bf16* __restrict__ out, int M, int N, int K) {
  typedef Cfg<MP, true, DEEP> C;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;
  float* xch = reinterpret_cast<float*>(empty + C::STAGES);
  const int j0 = blockIdx.x * TILE_N;
  const int groups = K / GROUP;
  const int stages = (groups + 1) / 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      // one arrive a consumer warp (the last stage of an odd group count
      // with two warpgroups gets only warpgroup 0's: it is never reused)
      hopper::mbar_init(&empty[s], C::CONSUMERS / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= C::CONSUMERS) {
    // the producer lane: each stage's xq and weight groups, their column
    // scales and their row scales; the second group of an odd count's last
    // stage comes in as zeros
    if (threadIdx.x == C::CONSUMERS) {
      for (int i = 0; i < stages; ++i) {
        const int s = i % C::STAGES;
        if (i >= C::STAGES) {
          hopper::mbar_wait(&empty[s], (i / C::STAGES - 1) & 1);
        }
        uint8_t* st = smem + s * C::STAGE;
        float* aux = reinterpret_cast<float*>(st + C::AUX);
        hopper::mbar_arrive_expect_tx(&full[s],
                                      C::AUX + 2 * (TILE_N + MP) * 4);
        hopper::tma_load_3d(st, &x_map, &full[s], 0, 0, 2 * i);
        hopper::tma_load_3d(st + C::X_BYTES, &w_map, &full[s], 0, j0, 2 * i);
        hopper::tma_load_2d(aux, &s_map, &full[s], j0, 2 * i);
        hopper::tma_load_2d(aux + 2 * TILE_N, &xs_map, &full[s], 0, 2 * i);
      }
    }
  } else {
    grouped_consume<MP, DEEP>(smem, full, empty, xch, out, M, N, j0, groups);
  }
}

// K3's launch on `st` of `tiles` x `runs` blocks: a programmatic dependent
// of the quantize pass before it, the runs of a tile one cluster
template <int MP, bool DEEP>
struct K3Launch {
  typedef Cfg<MP, false, DEEP> C;
  cudaLaunchAttribute attrs[2];
  cudaLaunchConfig_t cfg;
  K3Launch(int tiles, int runs, cudaStream_t st) : cfg() {
    attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[0].val.programmaticStreamSerializationAllowed = 1;
    attrs[1].id = cudaLaunchAttributeClusterDimension;
    attrs[1].val.clusterDim.x = 1;
    attrs[1].val.clusterDim.y = runs;
    attrs[1].val.clusterDim.z = 1;
    cfg.gridDim = dim3(tiles, runs);
    cfg.blockDim = dim3(C::THREADS);
    cfg.dynamicSmemBytes = C::SMEM;
    cfg.stream = st;
    cfg.attrs = attrs;
    cfg.numAttrs = 2;
  }
};

template <int MP, bool DEEP>
cudaError_t launch_k3(const CUtensorMap* maps, const float* xs,
                      const float* scale, bf16* out, int M, int N, int K,
                      int runs, cudaStream_t st) {
  auto kernel = int8_decode_kernel<MP, DEEP>;
  const cudaError_t err =
      hopper::smem_opt_in(kernel, Cfg<MP, false, DEEP>::SMEM);
  if (err != cudaSuccess) return err;
  K3Launch<MP, DEEP> l((N + TILE_N - 1) / TILE_N, runs, st);
  return cudaLaunchKernelEx(&l.cfg, kernel, maps[0], maps[1], xs, scale, out,
                            M, N, K);
}

// Whether K3's `tiles` clusters of `runs` blocks with the deep ring run at
// once on the current device (a wide cluster of one-block-an-SM blocks may
// not fit a GPC: at N 2048 four runs made a second wave); the count of
// such clusters is asked once per (device, runs).
template <int MP>
cudaError_t k3_deep(int tiles, int runs, bool* deep) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::pair<int, int>, int> fits;
  const std::lock_guard<std::mutex> lock(mu);
  auto it = fits.find({dev, runs});
  if (it == fits.end()) {
    auto kernel = int8_decode_kernel<MP, true>;
    err = hopper::smem_opt_in(kernel, Cfg<MP, false, true>::SMEM);
    int clusters = 0;
    K3Launch<MP, true> l(1, runs, nullptr);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &l.cfg);
    }
    if (err != cudaSuccess) return err;
    it = fits.emplace(std::make_pair(dev, runs), clusters).first;
  }
  *deep = tiles <= it->second;
  return cudaSuccess;
}

template <int MP, bool DEEP>
cudaError_t launch_k7(const CUtensorMap* maps, bf16* out, int M, int N, int K,
                      cudaStream_t st) {
  typedef Cfg<MP, true, DEEP> C;
  auto kernel = int8_grouped_decode_kernel<MP, DEEP>;
  const cudaError_t err = hopper::smem_opt_in(kernel, C::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<(N + TILE_N - 1) / TILE_N, C::THREADS, C::SMEM, st>>>(
      maps[0], maps[1], maps[2], maps[3], out, M, N, K);
  return cudaGetLastError();
}

// Whether K7's grid of `blocks` fits the current device in one wave of one
// block an SM (then the deep ring: more bytes in flight an SM)
cudaError_t one_wave(int blocks, bool* deep) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  *deep = blocks <= sms;
  return err;
}

int rows_rounded(int M) {
  return M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : 64;
}

}  // namespace

// K3 for x of 1 to 64 rows. xq (M, K) int8 and xs (M,) f32 are scratch the
// wrapper allocates; x, kq 16-byte aligned, K % 16 == 0, N % 8 == 0, runs
// at most MAX_RUNS and ceil(K / 256).
extern "C" int int8_decode(const void* x, const void* kq, const void* scale,
                           void* xq, void* xs, void* out, int M, int N, int K,
                           int runs, void* stream) {
  if (M <= 0 || M > 64 || N <= 0 || K <= 0 || K % 16 != 0 || N % 8 != 0 ||
      K > MAX_K || runs < 1 || runs > MAX_RUNS ||
      runs > (K + STAGE_K - 1) / STAGE_K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_decode_quantize_kernel<<<M, QTHREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(xs), K);
  cudaError_t err = cudaGetLastError();
  const int mp = rows_rounded(M);
  // xq: boxes of MP rows x 128 bytes; kq: 64 rows x 128 bytes
  CUtensorMap maps[2];
  if (err == cudaSuccess) {
    err = hopper::make_map_2d(&maps[0], xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                              M, K, mp, CHUNK, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == cudaSuccess) {
    err = hopper::make_map_2d(&maps[1], kq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                              N, K, TILE_N, CHUNK,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (N + TILE_N - 1) / TILE_N;
  bool deep = false;
  err = mp == 8    ? k3_deep<8>(tiles, runs, &deep)
        : mp == 16 ? k3_deep<16>(tiles, runs, &deep)
        : mp == 32 ? k3_deep<32>(tiles, runs, &deep)
                   : k3_deep<64>(tiles, runs, &deep);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xsf = static_cast<const float*>(xs);
  const float* sc = static_cast<const float*>(scale);
  bf16* o = static_cast<bf16*>(out);
  auto launch = deep ? (mp == 8    ? launch_k3<8, true>
                        : mp == 16 ? launch_k3<16, true>
                        : mp == 32 ? launch_k3<32, true>
                                   : launch_k3<64, true>)
                     : (mp == 8    ? launch_k3<8, false>
                        : mp == 16 ? launch_k3<16, false>
                        : mp == 32 ? launch_k3<32, false>
                                   : launch_k3<64, false>);
  return static_cast<int>(launch(maps, xsf, sc, o, M, N, K, runs, st));
}

// K7 for x of 1 to 64 rows. xq (M, K) int8 and xs (K / 128, xs_pitch(M))
// f32 (the row scales, transposed) are scratch the wrapper allocates; x, kq
// and scale_g 16-byte aligned, K % 128 == 0, N % 8 == 0.
extern "C" int int8_grouped_decode(const void* x, const void* kq,
                                   const void* scale_g, void* xq, void* xs,
                                   void* out, int M, int N, int K,
                                   void* stream) {
  if (M <= 0 || M > 64 || N <= 0 || K <= 0 || K % GROUP != 0 || N % 8 != 0 ||
      K > MAX_K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = quant::launch_quantize(x, xq, xs, M, K, GROUP, st);
  const int mp = rows_rounded(M);
  const uint64_t groups = K / GROUP;
  // xq as (128 bytes, M rows, G groups), a box MP rows of 2 groups; kq as
  // (128 bytes, N rows, G groups), a box 64 rows of 2 groups; scale_g (G,
  // N) 64 columns of 2 groups; xs (G, pitch) MP rows of 2 groups
  CUtensorMap maps[4];
  if (err == cudaSuccess) {
    err = hopper::make_map_3d(&maps[0], xq, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                              CHUNK, M, groups, K, CHUNK, CHUNK, mp, 2,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == cudaSuccess) {
    err = hopper::make_map_3d(&maps[1], kq, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                              CHUNK, N, groups, K, CHUNK, CHUNK, TILE_N, 2,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == cudaSuccess) {
    err = hopper::make_map_2d(&maps[2], scale_g,
                              CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, groups, N,
                              2, TILE_N, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err == cudaSuccess) {
    err = hopper::make_map_2d(&maps[3], xs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                              4, groups, quant::xs_pitch(M), 2, mp,
                              CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  bool deep = false;
  if (err == cudaSuccess) err = one_wave((N + TILE_N - 1) / TILE_N, &deep);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto launch = deep ? (mp == 8    ? launch_k7<8, true>
                        : mp == 16 ? launch_k7<16, true>
                        : mp == 32 ? launch_k7<32, true>
                                   : launch_k7<64, true>)
                     : (mp == 8    ? launch_k7<8, false>
                        : mp == 16 ? launch_k7<16, false>
                        : mp == 32 ? launch_k7<32, false>
                                   : launch_k7<64, false>);
  return static_cast<int>(launch(maps, static_cast<bf16*>(out), M, N, K, st));
}
