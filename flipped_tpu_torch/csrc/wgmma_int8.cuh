// The int8 GEMM main loop on Hopper's wgmma, fed by TMA through an mbarrier
// ring: out (M, Nout) bf16 = (a (M, C) int8 . b (C, Nout) int8) * row scale,
// with b contiguous along Nout, i.e. MN-major for the product. K10
// (int8_dgrad.cu) runs it with a = the quantized cotangent gq (M, N), b =
// kq (N, K) and the row scales gsc. (K3's and K7's operands are both
// K-major and need no swap: int8_fwd.cu and int8_grouped_fwd.cu read them
// with the SS form.)
//
// The constraint: for 8-bit types wgmma reads shared-memory operands
// K-major only (its transpose bits are for 16-bit types), b is MN-major,
// and a transposed copy of the weight would add an int8 copy of the frozen
// backbone. So the operands are swapped: each block computes the transposed
// tile out^T = b^T . a^T. A = b^T comes from registers, assembled from the
// TMA-loaded b tile by 4 x 4 byte transposes (__byte_perm); B = a, whose
// rows are contiguous in the contraction, goes to wgmma straight from
// shared memory. No ordinary store writes a buffer that wgmma reads.
//
// Tile: 128 output columns x 256 rows, over 128-deep contraction stages
// (one 128-byte swizzled row of a, one of b). Two consumer warpgroups own
// 128 rows each and issue two m64n128k32 wgmmas a 32-deep step (A tiles 0
// and 1) against their half of the a tile. A thread's four A rows (tile i,
// fragment row 16 w + g + 8 h) are mapped to four consecutive output
// columns 4 (8 w + g) + 2 i + h, so one 32-bit load from each of 4 b rows
// and one 4 x 4 transpose give all four of its fragment registers of a
// 4-deep slice, and the epilogue stores 4 adjacent bf16 (8 bytes) a row.
// One lane of a producer warpgroup keeps a ring of 4 stages (48 KB each)
// full; each consumer warpgroup drains its wgmmas once a stage. Rows past
// M, columns past Nout and the contraction past C come in as zeros.
//
// Exactness: the int32 sums are exact in any order, so the result is the
// plain version's bit for bit (one __int2float_rn, one __fmul_rn, one bf16
// rounding).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace wgmma_int8 {

typedef __nv_bfloat16 bf16;

constexpr int BN = 128;           // output columns a block (A rows)
constexpr int BM = 256;           // rows a block, 128 a consumer warpgroup
constexpr int BC = 128;           // contraction a stage
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BC;  // 32 KB: a rows, 128B swizzle
constexpr int B_BYTES = BC * BN;  // 16 KB: b rows, 128B swizzle
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int THREADS = 3 * 128;
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

// T[c] = byte c of w[0..3], w[j]'s in byte j
__device__ __forceinline__ void transpose4x4(const uint32_t w[4],
                                             uint32_t T[4]) {
  const uint32_t t01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t u01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t u23 = __byte_perm(w[2], w[3], 0x7362);
  T[0] = __byte_perm(t01, t23, 0x5410);
  T[1] = __byte_perm(t01, t23, 0x7632);
  T[2] = __byte_perm(u01, u23, 0x5410);
  T[3] = __byte_perm(u01, u23, 0x7632);
}

// The consumer warpgroups' main loop and epilogue.
__device__ __forceinline__ void consume(uint8_t* smem, uint64_t* full,
                                        uint64_t* empty,
                                        const float* __restrict__ row_scale,
                                        bf16* __restrict__ out, int M,
                                        int Nout, int nst, int m0, int n0) {
  const int warp = threadIdx.x / 32;
  const int wg = warp / 4;             // rows wg * 128 .. + 127
  const int w = warp % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kk = 4 * (8 * w + g);      // the thread's 4 output columns

  int d0[64], d1[64];                  // A tiles 0 and 1
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    d0[i] = 0;
    d1[i] = 0;
  }

  for (int kb = 0; kb < nst; ++kb) {
    const int s = kb % STAGES;
    hopper::mbar_wait(&full[s], (kb / STAGES) & 1);
    const uint8_t* st = smem + s * STAGE_BYTES;
    const uint8_t* bt = st + A_BYTES;

    // A fragments of the 4 steps: contraction rows 32 ks + 4t + j (a0, a1)
    // and 32 ks + 16 + 4t + j (a2, a3), columns kk .. kk + 3
    uint32_t f0[4][4], f1[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t wlo[4], whi[4], T[4], U[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wlo[j] = hopper::sw128_u32(bt, 32 * ks + 4 * t + j, kk);
        whi[j] = hopper::sw128_u32(bt, 32 * ks + 16 + 4 * t + j, kk);
      }
      transpose4x4(wlo, T);
      transpose4x4(whi, U);
      f0[ks][0] = T[0];
      f0[ks][1] = T[1];
      f0[ks][2] = U[0];
      f0[ks][3] = U[1];
      f1[ks][0] = T[2];
      f1[ks][1] = T[3];
      f1[ks][2] = U[2];
      f1[ks][3] = U[3];
    }
    const uint64_t desc = hopper::desc_sw128(st + wg * (A_BYTES / 2));
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int acc = (kb == 0 && ks == 0) ? 0 : 1;
      hopper::wgmma_m64n128k32_s8_rs(d0, f0[ks], desc + 2 * ks, acc);
      hopper::wgmma_m64n128k32_s8_rs(d1, f1[ks], desc + 2 * ks, acc);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      hopper::fence_operand(d0[i]);
      hopper::fence_operand(d1[i]);
    }
    if (threadIdx.x % 128 == 0) hopper::mbar_arrive(&empty[s]);
  }

  // register 4q + 2h + e of tile i: row m = 8q + 2t + e of the warpgroup's
  // 128, output column kk + 2i + h
  const int col = n0 + kk;
  if (col >= Nout) return;             // Nout % 4 == 0: all four or none
#pragma unroll
  for (int q = 0; q < 16; ++q) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + wg * 128 + 8 * q + 2 * t + e;
      if (row >= M) continue;
      const float rs = row_scale[row];
      const int r = 4 * q + e;
      const float v0 = __fmul_rn(__int2float_rn(d0[r]), rs);
      const float v1 = __fmul_rn(__int2float_rn(d0[r + 2]), rs);
      const float v2 = __fmul_rn(__int2float_rn(d1[r]), rs);
      const float v3 = __fmul_rn(__int2float_rn(d1[r + 2]), rs);
      __nv_bfloat162 p01 = __floats2bfloat162_rn(v0, v1);
      __nv_bfloat162 p23 = __floats2bfloat162_rn(v2, v3);
      *reinterpret_cast<uint2*>(out + static_cast<long long>(row) * Nout +
                                col) =
          make_uint2(*reinterpret_cast<uint32_t*>(&p01),
                     *reinterpret_cast<uint32_t*>(&p23));
    }
  }
}

// Grid: (M / 256 row tiles, Nout / 128 column tiles); 384 threads: warps
// 0-7 the two consumer warpgroups (232 registers each), warps 8-11 the
// producer warpgroup (40), of which one lane issues the loads.
__global__ void __launch_bounds__(THREADS, 1)
kn_gemm_row_kernel(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap b_map,
                   const float* __restrict__ row_scale,
                   bf16* __restrict__ out, int M, int Nout, int C) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) &
                              1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nst = (C + BC - 1) / BC;
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
      for (int kb = 0; kb < nst; ++kb) {
        const int s = kb % STAGES;
        const int round = kb / STAGES;
        if (round > 0) hopper::mbar_wait(&empty[s], (round - 1) & 1);
        uint8_t* st = smem + s * STAGE_BYTES;
        hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        hopper::tma_load_2d(st, &a_map, &full[s], kb * BC, m0);
        hopper::tma_load_2d(st + A_BYTES, &b_map, &full[s], n0, kb * BC);
      }
    }
  } else {
    hopper::regs_alloc<232>();
    consume(smem, full, empty, row_scale, out, M, Nout, nst, m0, n0);
  }
}

// Host: the two tensor maps and the launch. a (M, C) int8 and b (C, Nout)
// int8 row-major, 16-byte aligned, C % 16 == 0 and Nout % 16 == 0 (TMA's
// 16-byte strides).
inline cudaError_t launch_kn_gemm_row(const void* a, const void* b,
                                      const float* row_scale, bf16* out, int M,
                                      int Nout, int C, cudaStream_t stream) {
  CUtensorMap a_map, b_map;
  cudaError_t err = hopper::make_map_2d(&a_map, a,
                                        CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M,
                                        C, BM, BC, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) {
    err = hopper::make_map_2d(&b_map, b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, C,
                              Nout, BC, BN, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == cudaSuccess) err = hopper::smem_opt_in(kn_gemm_row_kernel, SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (Nout + BN - 1) / BN);
  kn_gemm_row_kernel<<<grid, THREADS, SMEM, stream>>>(a_map, b_map, row_scale,
                                                      out, M, Nout, C);
  return cudaGetLastError();
}

}  // namespace wgmma_int8
