// The body shared by K4 (quant_dx.cu) and K9 (int4_dx.cu) on Hopper:
// dx = g . dequant(W)^T with the weight dequantized on its way from shared
// memory into wgmma's register A operand.
//
//   W[n, k]  = bf16(bf16(code[n, k]) * bf16(scale_g[k / group, n]))   the
//              JAX rounding: the product of two bf16 values is exact in
//              f32, then rounds to nearest even (one bf16x2 multiply)
//   dx[m, k] = bf16(sum_n g[m, n] * W[n, k])      f32 accumulation
//
// K4 (PACKED = false): codes from kq (N, K) int8. K9 (PACKED = true): codes
// from kq4 (N/2, K) packed int4, byte [j, k] holding W[j, k] (low nibble)
// and W[j + N/2, k] (high nibble).
//
// What bounds it on an H100: at the 7B training shapes a call is 103-277 G
// multiply-adds of bf16 on 40-138 MB, compute-bound at the 989 TFLOP/s bf16
// peak (104-280 us); only wgmma reaches that rate. The design:
//   - operands swapped: each block computes the transposed tile
//     dx^T = W^T . g^T. The weight is the A operand, from registers: each A
//     row is one dx column, its contraction runs down a column of the
//     stored [n][k] tile, so a thread reads 2 bytes (its two adjacent dx
//     columns) from each of two tile rows n, n + 1 and builds the bf16
//     pairs (n, n + 1) of both columns from them. g, whose rows are
//     contiguous in the contraction, is wgmma's K-major B operand straight
//     from a TMA tile with the 128-byte swizzle. The weight crosses HBM and
//     shared memory at 1 byte (K4) or 1/2 byte (K9) an element; the
//     dequantized bf16 weight exists only in registers.
//   - tile: 128 dx columns (within one scale group, group % 128 == 0) by
//     256 g rows, over 64-deep contraction stages. Two consumer warpgroups
//     own 64 dx columns each and issue one m64n256k16 wgmma a 16-deep step
//     against the whole g tile. The scale varies along the contraction and
//     is applied at the dequantize, so a thread keeps one accumulator set
//     (128 registers) and two stages of fragments (32) under the 232 that
//     setmaxnreg gives a consumer. A thread's A rows 16w + g and
//     16w + g + 8 are the dx columns 16w + 2g and 16w + 2g + 1 of its
//     warpgroup, so its two 2-byte loads a row pair are conflict-free and
//     the epilogue stores bf16 pairs of adjacent columns with no shuffle.
//   - one lane of a producer warpgroup (40 registers) keeps a ring of 5
//     stages full with TMA: the g box (256 rows x 64 columns), the weight
//     box (64 rows x 128 bytes) and the stage's 64 scales of the block's
//     group row. K4's stage kb is n in [64 kb, 64 kb + 64). K9's stages
//     alternate halves: stage 2i takes packed rows j in [64 i, 64 i + 64)
//     with g columns j (low nibbles), stage 2i + 1 the same bytes (an L2
//     hit) with g columns N/2 + j (high nibbles). Rows past M, weight rows
//     past N (N/2) and g columns past N come in as zeros; where a K9 low
//     stage's g columns run into the high half, the weight rows there are
//     zeros.
//   - a stage's fragments are converted while the previous stage's wgmmas
//     run (wait_group 1); the first stage's wgmmas overwrite d (scale-d 0),
//     so no ordinary instruction writes the accumulator and ptxas keeps the
//     wgmmas in flight.
// The plain versions (a cuBLAS bf16 product on the dequantized weight)
// differ from it only in the order of the f32 sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace dxw {

typedef __nv_bfloat16 bf16;

constexpr int BM = 256;        // g rows a block: the wgmma N
constexpr int BKO = 128;       // dx columns a block, 64 a consumer warpgroup
constexpr int BC = 64;         // contraction a stage: 128-byte g rows
constexpr int STAGES = 5;
constexpr int G_BYTES = BM * BC * 2;            // 32 KB, 128B swizzle
constexpr int W_BYTES = BC * BKO;               // 8 KB, 128B swizzle
constexpr int TILE_BYTES = G_BYTES + W_BYTES;
constexpr int S_BYTES = BC * 4;                 // the stage's scales
constexpr int THREADS = 3 * 128;
constexpr int SMEM = STAGES * (TILE_BYTES + S_BYTES) + 2 * STAGES * 8 + 1024;

template <bool B>
struct Bool {
  static constexpr bool value = B;
};

// the 2 bytes at (row r, byte c, c even) of a 128-byte-row tile written by
// TMA with the 128-byte swizzle (16-byte chunk j of row r sits at
// j ^ (r % 8); the tile is 1024-byte aligned)
__device__ __forceinline__ uint32_t sw128_u16(const uint8_t* tile, int r,
                                              int c) {
  return *reinterpret_cast<const uint16_t*>(
      tile + r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15));
}

// float(c) of the int8 code c whose biased byte c + 128 is byte `sel & 3`
// of u: 0x4B0000xx is the float 2^23 + xx, exact.
__device__ __forceinline__ float biased_code_f32(uint32_t u, uint32_t sel) {
  return __fadd_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, sel)),
                   -8388736.f);                     // - (2^23 + 128)
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a,
                                               __nv_bfloat162 b) {
  const __nv_bfloat162 r =
      __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a), b);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The A fragments of one stage: wt the stage's weight tile, sc its 64
// scales, c0 the thread's first dx column in the block. a[ks][2p] (A row
// 16w + g, dx column c0) and a[ks][2p + 1] (row 16w + g + 8, column c0 + 1)
// hold the dequantized pairs (n, n + 1), n = 16 ks + 8 p + 2t. HI: K9's
// high nibbles.
template <bool PACKED, bool HI>
__device__ __forceinline__ void convert(const uint8_t* wt, const float* sc,
                                        int c0, int t, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int n = 16 * ks + 8 * p + 2 * t;
      // bytes [W(n, c0), W(n, c0 + 1), W(n + 1, c0), W(n + 1, c0 + 1)]
      const uint32_t w = __byte_perm(sw128_u16(wt, n, c0),
                                     sw128_u16(wt, n + 1, c0), 0x5410);
      const float2 s = *reinterpret_cast<const float2*>(sc + n);
      const __nv_bfloat162 sb = __floats2bfloat162_rn(s.x, s.y);
      uint32_t q0, q1;             // bf16(code) pairs of columns c0, c0 + 1
      if (PACKED) {
        q0 = hopper::nibbles_bf16x2<HI>(w);
        q1 = hopper::nibbles_bf16x2<HI>(w >> 8);
      } else {
        const uint32_t u = w ^ 0x80808080u;
        q0 = flash::pack_f32(biased_code_f32(u, 0x7540),
                             biased_code_f32(u, 0x7542));
        q1 = flash::pack_f32(biased_code_f32(u, 0x7541),
                             biased_code_f32(u, 0x7543));
      }
      a[ks][2 * p] = bf16x2_mul(q0, sb);
      a[ks][2 * p + 1] = bf16x2_mul(q1, sb);
    }
  }
}

// The consumer warpgroups' main loop and epilogue.
template <bool PACKED>
__device__ __forceinline__ void consume(uint8_t* smem, const float* scales,
                                        uint64_t* full, uint64_t* empty,
                                        bf16* __restrict__ out, int M, int K,
                                        int nst, int m0, int k0) {
  const int wg = threadIdx.x / 128;
  const int w = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int c0 = 64 * wg + 16 * w + 2 * g;
  const bool leader = threadIdx.x % 128 == 0;

  float d[128];
  uint32_t a0[4][4], a1[4][4];

  auto wait_full = [&](int kb) {
    const int s = kb % STAGES;
    hopper::mbar_wait(&full[s], (kb / STAGES) & 1);
    return s;
  };
  auto issue = [&](int s, uint32_t (&a)[4][4], bool first) {
    const uint64_t desc = hopper::desc_sw128(smem + s * TILE_BYTES);
    hopper::wgmma_fence();
    if (first) {
      hopper::wgmma_m64n256k16_bf16_rs_zero(d, a[0], desc);
    } else {
      hopper::wgmma_m64n256k16_bf16_rs(d, a[0], desc);
    }
#pragma unroll
    for (int ks = 1; ks < 4; ++ks) {
      hopper::wgmma_m64n256k16_bf16_rs(d, a[ks], desc + 2 * ks);
    }
    hopper::wgmma_commit();
  };
  // stage kb into a (K9: odd stages are high nibbles), its wgmmas issued;
  // the previous stage is released once only this one is in flight
  auto next = [&](int kb, uint32_t (&a)[4][4], auto hi) {
    const int s = wait_full(kb);
    convert<PACKED, decltype(hi)::value>(smem + s * TILE_BYTES + G_BYTES,
                                         scales + s * BC, c0, t, a);
    issue(s, a, false);
    hopper::wgmma_wait<1>();
    if (leader) hopper::mbar_arrive(&empty[(kb - 1) % STAGES]);
  };
  using Lo = Bool<false>;
  using Hi = Bool<PACKED>;

  {
    const int s = wait_full(0);
    convert<PACKED, false>(smem + s * TILE_BYTES + G_BYTES, scales + s * BC,
                           c0, t, a0);
    issue(s, a0, true);
  }
  int kb = 1;
  for (; kb + 1 < nst; kb += 2) {
    next(kb, a1, Hi());
    next(kb + 1, a0, Lo());
  }
  if (kb < nst) next(kb, a1, Hi());
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 128; ++i) hopper::fence_operand(d[i]);

  // register 4i + 2h + e: dx column c0 + h, g row 8i + 2t + e
  const int col = k0 + c0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * i + 2 * t + e;
      if (row < M) {
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * K +
                                     col) =
            flash::pack_f32(d[4 * i + e], d[4 * i + 2 + e]);
      }
    }
  }
}

// The kernel body, one block of THREADS on grid (K / BKO, ceil(M / BM)):
// warps 0-7 the two consumer warpgroups (232 registers each), warps 8-11
// the producer warpgroup (40), of which one lane issues the loads.
template <bool PACKED>
__device__ __forceinline__ void dx_body(const CUtensorMap& g_map,
                                        const CUtensorMap& w_map,
                                        const CUtensorMap& s_map,
                                        bf16* __restrict__ out, int M, int N,
                                        int K, int group) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) &
                              1023);
  float* scales = reinterpret_cast<float*>(smem + STAGES * TILE_BYTES);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + STAGES * (TILE_BYTES + S_BYTES));
  uint64_t* empty = full + STAGES;

  const int k0 = blockIdx.x * BKO;
  const int m0 = blockIdx.y * BM;
  const int nh = N / 2;
  const int nst = PACKED ? 2 * ((nh + BC - 1) / BC) : (N + BC - 1) / BC;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);     // one arrive a consumer warpgroup
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    hopper::regs_dealloc<40>();
    if (threadIdx.x == 256) {
      const int gi = k0 / group;           // the block's scale row
      for (int kb = 0; kb < nst; ++kb) {
        const int s = kb % STAGES;
        const int round = kb / STAGES;
        if (round > 0) hopper::mbar_wait(&empty[s], (round - 1) & 1);
        // the stage's first weight row (K9: packed row) and g column
        const int c = PACKED ? (kb >> 1) * BC : kb * BC;
        const int gc = PACKED && (kb & 1) ? nh + c : c;
        uint8_t* st = smem + s * TILE_BYTES;
        hopper::mbar_arrive_expect_tx(&full[s], TILE_BYTES + S_BYTES);
        hopper::tma_load_2d(st, &g_map, &full[s], gc, m0);
        hopper::tma_load_2d(st + G_BYTES, &w_map, &full[s], k0, c);
        hopper::tma_load_2d(scales + s * BC, &s_map, &full[s], gc, gi);
      }
    }
  } else {
    hopper::regs_alloc<232>();
    consume<PACKED>(smem, scales, full, empty, out, M, K, nst, m0, k0);
  }
}

// The shapes both kernels take; the Python wrappers check the same (TMA's
// 16-byte row pitches: N % 8 for g, K % 16 for the weight, N % 4 for the
// scales; the scales 16-byte aligned).
inline bool shapes_ok(bool packed, int M, int N, int K, int group) {
  return M > 0 && N > 0 && K > 0 && N % (packed ? 16 : 8) == 0 &&
         group > 0 && group % BKO == 0 && K % group == 0 &&
         (M + BM - 1) / BM <= 65535;
}

// Host: the three tensor maps and the launch of `kernel` (quant_dx.cu's or
// int4_dx.cu's, which run dx_body<PACKED>).
template <bool PACKED, typename Kernel>
inline cudaError_t launch(Kernel kernel, const void* g, const void* kq,
                          const void* scale_g, void* out, int M, int N, int K,
                          int group, cudaStream_t stream) {
  if (!shapes_ok(PACKED, M, N, K, group)) return cudaErrorInvalidValue;
  CUtensorMap g_map, w_map, s_map;
  cudaError_t err = hopper::make_map_2d(&g_map, g,
                                        CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                        M, N, BM, BC,
                                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) {
    err = hopper::make_map_2d(&w_map, kq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                              PACKED ? N / 2 : N, K, BC, BKO,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == cudaSuccess) {
    err = hopper::make_map_2d(&s_map, scale_g,
                              CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K / group,
                              N, 1, BC, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err == cudaSuccess) err = hopper::smem_opt_in(kernel, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(K / BKO, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM, stream>>>(g_map, w_map, s_map,
                                          static_cast<bf16*>(out), M, N, K,
                                          group);
  return cudaGetLastError();
}

}  // namespace dxw
