// K8 for Hopper: the packed-int4 forward of --quantize int4 / w4a8 (and
// their rotated variants int4r / w4a8r).
//
// Replaces the TPU kernel int4_matmul_grouped_pallas -> _int4_kernel
// (flipped_tpu/model/pallas/quant_matmul.py:160-275). Operands, for x (M, K)
// bf16, kq4 (N/2, K) int8 (the port's layout: byte [j, k] holds W[j, k] in
// its low nibble and W[j + N/2, k] in its high nibble, each a signed 4-bit
// code), scale_g (G, N) f32 with group = K / G a multiple of 128:
//
// act_quant (w4a8): the grouped w8a8 forward of K7 on the unpacked codes
//   xs[m, g]  = max(amax over group g of |x[m, :]| / 127, 1e-8)  a division
//   xq[m, k]  = rint(x[m, k] / xs[m, k / group])                 half to even
//   d_g[m, n] = sum over group g of xq[m, k] * W[n, k]           exact, int32
//   out[m, n] = bf16(sum_g (float(d_g) * xs[m, g]) * scale_g[g, n]), the
//               groups in order, bit for bit the plain version's. Two
//               launches: K7's quantize pass with the call's group, then
//               the GEMM below.
//
// weight-only (int4): bf16 products on the raw codes with the group scale
// applied to each group's partial product, as _int4_kernel does:
//   d_g[m, n] = sum over group g of bf16(x[m, k]) * W[n, k]   f32 (wgmma
//               m64n128k16: products exact, sums in the tensor core's order)
//   out[m, n] = bf16(sum_g d_g * scale_g[g, n]), the groups in order, each
//               step a separate multiply and add (__fmul_rn, __fadd_rn).
//   The plain version takes each d_g exactly (a float64 sum rounded once to
//   f32), so the two differ by the f32 rounding of the group sums; the bound
//   is stated in chip_smoke.py (K8_WO_REL).
//
// What bounds it on an H100: at the 7B training shapes (M 3072, K 4096 or
// 11008, N 4096 or 11008) a call is 103-277 G multiply-adds on 40-97 MB of
// operands, far above both ridge points: compute-bound, at the int8 rate
// for w4a8 (52-140 us at 1979 TOP/s) and the bf16 rate for int4 (104-280 us
// at 989 TFLOP/s). Only wgmma reaches those rates, so both branches are
// warp-specialised TMA + wgmma kernels. The weight-only branch:
//   - operands swapped: each block computes the transposed tile out^T =
//     W . x^T, so the packed weight is wgmma's A operand, converted from
//     nibbles to bf16 in registers (hopper_common.cuh's nibble_pair_bf16:
//     a byte permute, a LOP3 and a bf16x2 subtract per pair, exact), and
//     x, whose rows are K-contiguous, is B straight from shared memory.
//     The weight crosses HBM and shared memory packed, half a byte an
//     element; the bf16 weight never exists.
//   - tile: 64 packed rows x 128 x rows, over 64-deep contraction stages.
//     One consumer warpgroup takes the low nibbles (output columns j), the
//     other the high ones (columns N/2 + j) of the same packed rows, each
//     with one m64n128k16 wgmma a 16-deep step against the shared x tile.
//     A thread keeps two 64-register accumulators (the group partial and
//     the folded sum) and two stages of fragments (32 registers) under the
//     232 that setmaxnreg gives a consumer; twice the x rows would not fit.
//   - one lane of a producer warpgroup (40 registers) keeps a ring of 6
//     stages full with TMA (cp.async.bulk.tensor, mbarrier completion):
//     the x box with the 128-byte swizzle wgmma reads, the packed box with
//     the 64-byte swizzle, which makes the consumers' 2-byte fragment loads
//     conflict-free. Rows past M and packed rows past N/2 come in as zeros.
//   - a stage's fragments are converted while the previous stage's wgmmas
//     run (wait_group 1). At each group's end the warpgroup drains its
//     wgmmas, folds d into the sum with the group's scales (each
//     accumulator row is one output column, so a thread needs two scales a
//     group), and the next group's first wgmma overwrites d (scale-d 0): no
//     ordinary instruction writes d, or ptxas would serialise the wgmmas.
//   - epilogue: each thread holds two columns n and 2 x 32 rows m of
//     out^T; a shuffle with the neighbouring column's thread gives each a
//     bf16 pair of adjacent columns, stored as one 32-bit word.
// The w4a8 branch (int4_w4a8_wgmma_kernel) is the same structure in int8,
// with K7's group fold:
//   - out^T = W . xq^T: the packed weight is wgmma's register A operand,
//     its nibbles sign-extended to s8 in registers (quant_common.cuh
//     nibbles_lo / nibbles_hi, 3 integer operations a register); xq, whose
//     rows are K-contiguous, is B from shared memory (RS m64n128k32). An s8
//     A register holds 4 consecutive contraction bytes of one row, so one
//     32-bit load from the 128-byte-swizzled packed tile (sw128_u32,
//     conflict-free across a warp's 8 rows) gives both warpgroups'
//     fragments: the low-nibble warpgroup (columns j0 + p) and the
//     high-nibble one (N/2 + j0 + p) read the same bytes.
//   - tile: 64 packed rows x 128 x rows over 128-deep stages; a ring of 8
//     stages, each 16 KB of xq, 8 KB of kq4 and, by TMA too, the stage
//     group's row scales (from the quantize pass's transposed xs, one
//     contiguous box) and the tile's 2 x 64 column scales; a persistent
//     grid, rows fastest. Every consumer warp releases a stage (all read
//     the scales with ordinary loads).
//   - registers: one int32 accumulator of 64, the f32 sum and one stage's A
//     fragments (16). A group's first stage overwrites d (scale-d 0); at
//     its end the warpgroup drains its wgmmas and folds d into the sum,
//     acc + (float(d) * xs[m]) * s[n] in the plain version's order, each
//     accumulator row one output column, so a thread needs two scales and
//     32 row scales a group. The two warpgroups run apart enough that one
//     folds while the other's wgmmas run. Two accumulators alternating
//     between groups (K7's layout), with the fragments of the stage in
//     flight beside them, need 208 registers: at 232 they spilled (148
//     bytes) and read slower at the 7B shapes in a throwaway variant build.
//   - epilogue: the weight-only branch's shuffle and 32-bit stores (the
//     accumulator's rows are output columns, so a quad holds 4 rows of
//     one column: no quad transpose gives 16-byte row pieces).
// Not yet done (later work): for the weight-only branch a persistent grid
// and TMA multicast of the x tile across a cluster (x is most of the bytes
// each stage brings from L2); for the w4a8 branch fusing the quantize into
// the loads, a 2-CTA cluster multicasting the xq tile (its 64-packed-row
// tiles read xq from L2 twice as often as K3's tiles do), and an epilogue
// through shared memory (stmatrix) for 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"
#include "quant_common.cuh"

namespace {

using flash::bf16;

constexpr int WO_BM = 128;        // x rows a block: the wgmma N
constexpr int WO_BJ = 64;         // packed rows a block
constexpr int WO_BK = 64;         // contraction a stage: 128-byte x rows
constexpr int WO_STAGES = 6;
constexpr int WO_X_BYTES = WO_BM * WO_BK * 2;          // 16 KB, 128B swizzle
constexpr int WO_W_BYTES = WO_BJ * WO_BK;              // 4 KB, 64B swizzle
constexpr int WO_STAGE_BYTES = WO_X_BYTES + WO_W_BYTES;
constexpr int WO_THREADS = 3 * 128;  // 2 consumer warpgroups, 1 producer
constexpr int WO_SMEM = WO_STAGES * WO_STAGE_BYTES + 2 * WO_STAGES * 8 + 1024;

// 2 bytes at (row p, byte b) of a packed tile of 64-byte rows written by TMA
// with the 64-byte swizzle (16-byte chunk c of row p sits at c ^ (p / 2 % 4);
// the tile is 1024-byte aligned); b is even and b % 16 < 15
__device__ __forceinline__ uint32_t packed_u16(const uint8_t* tile, int p,
                                               int b) {
  const int off = p * 64 + ((((b >> 4) ^ (p >> 1)) & 3) << 4) + (b & 15);
  return *reinterpret_cast<const uint16_t*>(tile + off);
}

// The consumer warpgroup HI (0: low nibbles, output columns j0 + p; 1: high
// nibbles, columns N/2 + j0 + p): the main loop and the epilogue.
template <bool HI>
__device__ __forceinline__ void consume(uint8_t* smem, uint64_t* full,
                                        uint64_t* empty,
                                        const float* __restrict__ scale,
                                        bf16* __restrict__ out, int M, int N,
                                        int K, int group, int m0, int j0) {
  const int nh = N / 2;
  const int nkb = K / WO_BK;               // even: K % 128 == 0
  const int kpg = group / WO_BK;           // stages a group, even
  const int w = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int p0 = 16 * w + g;               // the thread's packed rows p0, p0 + 8
  const bool leader = threadIdx.x % 128 == 0;

  // the group's partial (written first by the group's first wgmma) and the
  // folded sum
  float d[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // the scales of rows p0 and p0 + 8, this group's and the next's
  const int col = (HI ? nh : 0) + j0 + p0;
  const bool ok0 = j0 + p0 < nh, ok1 = j0 + p0 + 8 < nh;
  auto scales = [&](int gi, float (&sv)[2]) {
    const float* sr = scale + static_cast<long long>(gi) * N + col;
    sv[0] = ok0 && gi * kpg < nkb ? sr[0] : 0.f;
    sv[1] = ok1 && gi * kpg < nkb ? sr[8] : 0.f;
  };
  float sc[2], sc_next[2];
  scales(0, sc);
  scales(1, sc_next);
  auto fold = [&]() {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = __fadd_rn(acc[i], __fmul_rn(d[i], sc[(i >> 1) & 1]));
    }
  };
  auto drain = [&]() {
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) hopper::fence_operand(d[i]);
  };

  // One stage: wait for it, convert its A fragments (rows p0 / p0 + 8,
  // bytes 2t, 2t+1 and 2t+8, 2t+9 of each 16-deep step) into a while the
  // previous stage's wgmmas run, then issue its 4 wgmmas.
  auto load = [&](int kb, uint32_t (&a)[4][4]) -> const uint8_t* {
    const int s = kb % WO_STAGES;
    hopper::mbar_wait(&full[s], (kb / WO_STAGES) & 1);
    const uint8_t* st = smem + s * WO_STAGE_BYTES;
    const uint8_t* wt = st + WO_X_BYTES;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int b = 16 * ks + 2 * t;
      a[ks][0] = hopper::nibble_pair_bf16<HI>(packed_u16(wt, p0, b));
      a[ks][1] = hopper::nibble_pair_bf16<HI>(packed_u16(wt, p0 + 8, b));
      a[ks][2] = hopper::nibble_pair_bf16<HI>(packed_u16(wt, p0, b + 8));
      a[ks][3] = hopper::nibble_pair_bf16<HI>(packed_u16(wt, p0 + 8, b + 8));
    }
    return st;
  };
  auto issue = [&](const uint8_t* st, uint32_t (&a)[4][4], bool first) {
    const uint64_t desc = hopper::desc_sw128(st);
    hopper::wgmma_fence();
    if (first) {
      hopper::wgmma_m64n128k16_bf16_rs_zero(d, a[0], desc);
    } else {
      hopper::wgmma_m64n128k16_bf16_rs(d, a[0], desc);
    }
#pragma unroll
    for (int ks = 1; ks < 4; ++ks) {
      hopper::wgmma_m64n128k16_bf16_rs(d, a[ks], desc + 2 * ks);
    }
    hopper::wgmma_commit();
  };
  auto release = [&](int kb) {           // stage kb's buffer is read
    if (leader) hopper::mbar_arrive(&empty[kb % WO_STAGES]);
  };
  // a stage after a group's first: the previous stage is released once
  // only this one is in flight
  auto next = [&](int kb, uint32_t (&a)[4][4]) {
    const uint8_t* st = load(kb, a);
    issue(st, a, false);
    hopper::wgmma_wait<1>();
    release(kb - 1);
  };

  // Each group: its first stage's wgmmas overwrite d (scale-d 0), the
  // other stages, an odd number, alternate the two fragment buffers. From
  // the second group on, the first stage drains the previous group and
  // folds it with its scales before its wgmmas. Every accumulator access
  // outside the wgmmas is on the straight path, and no ordinary
  // instruction writes d, so ptxas keeps the wgmmas in flight.
  uint32_t a0[4][4], a1[4][4];
  auto group_rest = [&](int kb, const uint8_t* st) {
    issue(st, a0, true);
    next(kb + 1, a1);
    for (int kp = 2; kp < kpg; kp += 2) {
      next(kb + kp, a0);
      next(kb + kp + 1, a1);
    }
  };
  group_rest(0, load(0, a0));
  const int ngroups = nkb / kpg;
  for (int gi = 1; gi < ngroups; ++gi) {
    const int kb = gi * kpg;
    const uint8_t* st = load(kb, a0);
    drain();
    release(kb - 1);
    fold();
    sc[0] = sc_next[0];
    sc[1] = sc_next[1];
    scales(gi + 1, sc_next);
    group_rest(kb, st);
  }
  drain();
  fold();

  // out[m, n]: register 4q + 2h + e is packed row p0 + 8h, x row
  // 8q + 2t + e. Threads g and g ^ 1 swap one value, so that each holds two
  // adjacent columns of one row.
  const bool odd = g & 1;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 8 * q + 2 * t + (odd ? 1 : 0);
      const int j = j0 + p0 - (odd ? 1 : 0) + 8 * h;   // even
      const float v0 = acc[4 * q + 2 * h], v1 = acc[4 * q + 2 * h + 1];
      const float recv = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
      if (row < M && j < nh) {
        const float lo = odd ? recv : v0, hi = odd ? v1 : recv;
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * N +
                                     (HI ? nh : 0) + j) =
            flash::pack_f32(lo, hi);
      }
    }
  }
}

// Grid: (M / 128 x-row tiles, N/2 / 64 packed tiles); 384 threads: warps
// 0-3 the low-nibble consumer warpgroup, 4-7 the high-nibble one (232
// registers each), 8-11 the producer warpgroup (40), of which one lane
// issues the loads.
__global__ void __launch_bounds__(WO_THREADS, 1)
int4_wo_kernel(const __grid_constant__ CUtensorMap x_map,
               const __grid_constant__ CUtensorMap w_map,
               const float* __restrict__ scale, bf16* __restrict__ out, int M,
               int N, int K, int group) {
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment for the swizzled tiles
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) &
                              1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + WO_STAGES * WO_STAGE_BYTES);
  uint64_t* empty = full + WO_STAGES;

  const int m0 = blockIdx.x * WO_BM;
  const int j0 = blockIdx.y * WO_BJ;
  const int nkb = K / WO_BK;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WO_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);     // one arrive a consumer warpgroup
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // producer: one lane keeps the ring full
    hopper::regs_dealloc<40>();
    if (threadIdx.x == 256) {
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % WO_STAGES;
        const int round = kb / WO_STAGES;
        if (round > 0) hopper::mbar_wait(&empty[s], (round - 1) & 1);
        uint8_t* st = smem + s * WO_STAGE_BYTES;
        hopper::mbar_arrive_expect_tx(&full[s], WO_STAGE_BYTES);
        hopper::tma_load_2d(st, &x_map, &full[s], kb * WO_BK, m0);
        hopper::tma_load_2d(st + WO_X_BYTES, &w_map, &full[s], kb * WO_BK,
                            j0);
      }
    }
  } else if (warp >= 4) {
    hopper::regs_alloc<232>();
    consume<true>(smem, full, empty, scale, out, M, N, K, group, m0, j0);
  } else {
    hopper::regs_alloc<232>();
    consume<false>(smem, full, empty, scale, out, M, N, K, group, m0, j0);
  }
}

// ---------------------------------------------------------------------------
// w4a8: K7's function on the packed weight, as out^T = W . xq^T
// ---------------------------------------------------------------------------
constexpr int A8_BM = 128;        // x rows a tile: the wgmma N
constexpr int A8_BJ = 64;         // packed rows a tile
constexpr int A8_BK = 128;        // contraction a stage: 128-byte rows
constexpr int A8_STAGES = 8;
constexpr int A8_X_BYTES = A8_BM * A8_BK;     // 16 KB of xq, 128B swizzle
constexpr int A8_W_BYTES = A8_BJ * A8_BK;     // 8 KB of kq4, 128B swizzle
// the fold's operands of the stage's group g (aux): xs[g, m0 .. m0 + 127]
// (the transposed row scales), then scale_g[g, j0 + p] and scale_g[g, N/2 +
// j0 + p] for the tile's packed rows p
constexpr int A8_AUX_S = A8_BM;               // float offsets in aux
constexpr int A8_STAGE_BYTES = A8_X_BYTES + A8_W_BYTES + 1024;
constexpr int A8_TX_BYTES = A8_X_BYTES + A8_W_BYTES + 4 * (A8_BM + 2 * A8_BJ);
constexpr int A8_CONSUMER_WARPS = 8;
constexpr int A8_SMEM =
    A8_STAGES * A8_STAGE_BYTES + 2 * A8_STAGES * 8 + 1024;
static_assert((A8_BM + 2 * A8_BJ) * 4 <= 1024, "aux fits its kilobyte");

struct A8Ring {
  uint8_t* smem;
  uint64_t* full;
  uint64_t* empty;
  __device__ __forceinline__ uint8_t* stage(int it) const {
    return smem + (it % A8_STAGES) * A8_STAGE_BYTES;
  }
  __device__ __forceinline__ const float* aux(int it) const {
    return reinterpret_cast<const float*>(stage(it) + A8_X_BYTES +
                                          A8_W_BYTES);
  }
};

// A consumer thread of warpgroup HI: warp w, lane 4g + t, its packed rows
// p0 = 16w + g and p0 + 8 (the wgmma's A rows; output columns j0 + p, or
// N/2 + j0 + p for HI).
struct A8Place {
  int w, g, t, p0;
};

// each consumer warp gives stage `it` back once it is done with it: the
// warps read the fold's operands with ordinary loads, so each arrives (one
// arrival a warpgroup would free the stage while its other warps read it)
__device__ __forceinline__ void a8_release(const A8Ring& ring,
                                           const A8Place& p, int it) {
  __syncwarp();
  if (p.g == 0 && p.t == 0) {
    hopper::mbar_arrive(&ring.empty[it % A8_STAGES]);
  }
}

// Stage `it`, once in: its A fragments (the packed rows' nibbles of the 4
// 32-deep steps, sign-extended to s8: a[ks] = rows p0, p0 + 8 at bytes
// 32ks + 4t .. + 3, then the same at 32ks + 16 + 4t) into a, then its 4
// wgmmas into d, the first overwriting d if ZERO. The caller has drained
// the wgmmas that read a before.
template <bool HI, bool ZERO>
__device__ __forceinline__ void a8_stage(const A8Ring& ring,
                                         const A8Place& p, int (&d)[64],
                                         uint32_t (&a)[4][4], int it) {
  hopper::mbar_wait(&ring.full[it % A8_STAGES], (it / A8_STAGES) & 1);
  const uint8_t* st = ring.stage(it);
  const uint8_t* wt = st + A8_X_BYTES;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t b = hopper::sw128_u32(wt, p.p0 + 8 * (j & 1),
                                           32 * ks + 16 * (j >> 1) + 4 * p.t);
      a[ks][j] = HI ? quant::nibbles_hi(b) : quant::nibbles_lo(b);
    }
  }
  const uint64_t desc = hopper::desc_sw128(st);
  hopper::wgmma_fence();
  if (ZERO) {
    hopper::wgmma_m64n128k32_s8_rs_zero(d, a[0], desc);
  } else {
    hopper::wgmma_m64n128k32_s8_rs(d, a[0], desc, 1);
  }
#pragma unroll
  for (int ks = 1; ks < 4; ++ks) {
    hopper::wgmma_m64n128k32_s8_rs(d, a[ks], desc + 2 * ks, 1);
  }
  hopper::wgmma_commit();
}

// acc += (float(d) * xs[row]) * scale[col] with the operands of the group
// whose last stage is `it`, which then goes back to the producer.
// d[4q + 2h + e] is packed row p0 + 8h, x row 8q + 2t + e.
template <bool HI>
__device__ __forceinline__ void a8_fold(const A8Ring& ring, const A8Place& p,
                                        int (&d)[64], float (&acc)[64],
                                        int it) {
#pragma unroll
  for (int i = 0; i < 64; ++i) hopper::fence_operand(d[i]);
  const float* aux = ring.aux(it);
  const float* sc = aux + A8_AUX_S + (HI ? A8_BJ : 0);
  const float sv[2] = {sc[p.p0], sc[p.p0 + 8]};
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const float2 x = *reinterpret_cast<const float2*>(aux + 8 * q + 2 * p.t);
    const float xv[2] = {x.x, x.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 4 * q + e;
      acc[r] = __fadd_rn(
          acc[r], __fmul_rn(__fmul_rn(__int2float_rn(d[r]), xv[e & 1]),
                            sv[e >> 1]));
    }
  }
  a8_release(ring, p, it);
}

__device__ __forceinline__ void a8_epilogue(const A8Place& p, bool hi,
                                            const float (&acc)[64],
                                            bf16* __restrict__ out, int M,
                                            int N, int m0, int j0) {
  // Threads g and g ^ 1 swap one value, so that each holds two adjacent
  // columns of one row (as int4_wo_kernel's epilogue)
  const int nh = N / 2;
  const bool odd = p.g & 1;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 8 * q + 2 * p.t + (odd ? 1 : 0);
      const int j = j0 + p.p0 - (odd ? 1 : 0) + 8 * h;   // even
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

// The consumer warpgroup HI (0: low nibbles, output columns j0 + p; 1: high
// nibbles, columns N/2 + j0 + p): each tile of the block in turn, its group
// loop and its epilogue. Each group's first stage overwrites d (scale-d 0),
// every stage after the first waits for the wgmmas before it (they read a),
// and at the group's end the warpgroup drains them and folds d into acc.
// The two warpgroups run the same loop on the same stages; one folds while
// the other's wgmmas run.
template <bool HI>
__device__ __forceinline__ void a8_consume(const A8Ring& ring,
                                           const A8Place& p,
                                           bf16* __restrict__ out, int M,
                                           int N, int tiles, int m_tiles,
                                           int nkb, int kpg) {
  int d[64];
  float acc[64];
  uint32_t a[4][4];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % m_tiles) * A8_BM;
    const int j0 = (tile / m_tiles) * A8_BJ;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kb = it; kb < it + nkb; kb += kpg) {
      a8_stage<HI, true>(ring, p, d, a, kb);
      for (int s = 1; s < kpg; ++s) {
        hopper::wgmma_wait<0>();
        a8_release(ring, p, kb + s - 1);
        a8_stage<HI, false>(ring, p, d, a, kb + s);
      }
      hopper::wgmma_wait<0>();
      a8_fold<HI>(ring, p, d, acc, kb + kpg - 1);
    }
    it += nkb;
    a8_epilogue(p, HI, acc, out, M, N, m0, j0);
  }
}

// Persistent grid of min(tiles, SMs) blocks of 384 threads: warps 0-3 the
// low-nibble consumer warpgroup, 4-7 the high-nibble one (232 registers
// each), 8-11 the producer warpgroup (40), of which one lane issues the
// TMA loads. Tiles: 128 x rows by 64 packed rows, rows fastest.
__global__ void __launch_bounds__(WO_THREADS, 1)
int4_w4a8_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap w_map,
                       const __grid_constant__ CUtensorMap xs_map,
                       const __grid_constant__ CUtensorMap s_map,
                       bf16* __restrict__ out, int M, int N, int K,
                       int group) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) &
                              1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + A8_STAGES * A8_STAGE_BYTES);
  uint64_t* empty = full + A8_STAGES;
  const A8Ring ring{smem, full, empty};

  const int nh = N / 2;
  const int m_tiles = (M + A8_BM - 1) / A8_BM;
  const int tiles = m_tiles * ((nh + A8_BJ - 1) / A8_BJ);
  const int nkb = K / A8_BK;
  const int kpg = group / A8_BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < A8_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], A8_CONSUMER_WARPS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    hopper::regs_dealloc<40>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * A8_BM;
        const int j0 = (tile / m_tiles) * A8_BJ;
        for (int kb = 0; kb < nkb; ++kb, ++it) {
          const int s = it % A8_STAGES;
          const int round = it / A8_STAGES;
          if (round > 0) hopper::mbar_wait(&empty[s], (round - 1) & 1);
          uint8_t* st = smem + s * A8_STAGE_BYTES;
          float* aux = reinterpret_cast<float*>(st + A8_X_BYTES + A8_W_BYTES);
          const int gi = kb / kpg;
          hopper::mbar_arrive_expect_tx(&full[s], A8_TX_BYTES);
          hopper::tma_load_2d(st, &x_map, &full[s], kb * A8_BK, m0);
          hopper::tma_load_2d(st + A8_X_BYTES, &w_map, &full[s], kb * A8_BK,
                              j0);
          hopper::tma_load_2d(aux, &xs_map, &full[s], m0, gi);
          hopper::tma_load_2d(aux + A8_AUX_S, &s_map, &full[s], j0, gi);
          hopper::tma_load_2d(aux + A8_AUX_S + A8_BJ, &s_map, &full[s],
                              nh + j0, gi);
        }
      }
    }
  } else {
    hopper::regs_alloc<232>();
    const int w = warp % 4, g = lane >> 2;
    const A8Place p{w, g, lane & 3, 16 * w + g};
    if (warp >= 4) {
      a8_consume<true>(ring, p, out, M, N, tiles, m_tiles, nkb, kpg);
    } else {
      a8_consume<false>(ring, p, out, M, N, tiles, m_tiles, nkb, kpg);
    }
  }
}

cudaError_t launch_w4a8(const void* xq, const void* kq4, const void* xs,
                        const void* scale_g, void* out, int M, int N, int K,
                        int group, cudaStream_t st) {
  const int nh = N / 2;
  const int groups = K / group;
  CUtensorMap x_map, w_map, xs_map, s_map;
  cudaError_t err = hopper::make_map_2d(
      &x_map, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, A8_BM, A8_BK,
      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) {
    err = hopper::make_map_2d(&w_map, kq4, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                              nh, K, A8_BJ, A8_BK,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == cudaSuccess) {
    err = hopper::make_map_2d(&xs_map, xs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                              4, groups, quant::xs_pitch(M), 1, A8_BM,
                              CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err == cudaSuccess) {
    err = hopper::make_map_2d(&s_map, scale_g,
                              CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, groups, N,
                              1, A8_BJ, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err == cudaSuccess) {
    err = hopper::smem_opt_in(int4_w4a8_wgmma_kernel, A8_SMEM);
  }
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((M + A8_BM - 1) / A8_BM) *
                          ((nh + A8_BJ - 1) / A8_BJ);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  int4_w4a8_wgmma_kernel<<<grid, WO_THREADS, A8_SMEM, st>>>(
      x_map, w_map, xs_map, s_map, static_cast<bf16*>(out), M, N, K, group);
  return cudaGetLastError();
}

}  // namespace

// xq (M, K) int8 and xs (K / group, xs_pitch(M)) f32 (the row scales,
// transposed) are scratch for the w4a8 branch (unused by the weight-only
// one), whose scale_g must be 16-byte aligned (TMA).
extern "C" int int4_fwd(const void* x, const void* kq4, const void* scale_g,
                        void* xq, void* xs, void* out, int M, int N, int K,
                        int group, int act_quant, void* stream) {
  const int nh = N / 2;
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 != 0 || group <= 0 ||
      group % 128 != 0 || K % group != 0 ||
      (M + WO_BM - 1) / WO_BM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!act_quant) {
    CUtensorMap x_map, w_map;
    cudaError_t err = hopper::make_map_2d(
        &x_map, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, WO_BM, WO_BK,
        CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess) {
      err = hopper::make_map_2d(&w_map, kq4, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                                nh, K, WO_BJ, WO_BK,
                                CU_TENSOR_MAP_SWIZZLE_64B);
    }
    if (err == cudaSuccess) err = hopper::smem_opt_in(int4_wo_kernel, WO_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((M + WO_BM - 1) / WO_BM, (nh + WO_BJ - 1) / WO_BJ);
    int4_wo_kernel<<<grid, WO_THREADS, WO_SMEM, st>>>(
        x_map, w_map, static_cast<const float*>(scale_g),
        static_cast<bf16*>(out), M, N, K, group);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = quant::launch_quantize(x, xq, xs, M, K, group, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_w4a8(xq, kq4, xs, scale_g, out, M, N, K, group, st));
}
