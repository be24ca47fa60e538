// K4 for Hopper: the backward of the grouped w8a8 modes (w8a8g / w8a8o),
// dx = g @ dequant(W)^T.
//
// Replaces the TPU kernel quant_dx_pallas -> _dx_kernel
// (flipped_tpu/model/pallas/quant_matmul.py:316-406). What it computes, for
// g (M, N) bf16, kq (N, K) int8 (the port's layout), scale_g (G, N) f32 with
// G = K / 128:
//   W[n, k]   = bf16(bf16(kq[n, k]) * bf16(scale_g[k / 128, n]))   the JAX
//               rounding (model/int8.py:389-390): the product of two bf16
//               values is exact in f32, then rounds to nearest even
//   dx[m, k]  = bf16(sum_n g[m, n] * W[n, k])      f32 accumulation
// The plain version (a cuBLAS bf16 product on the dequantized weight)
// differs from it only in the order of the f32 sums.
//
// What bounds it on an H100: at the 7B training shapes a call is 103-277
// GFLOP of bf16 products on ~67-138 MB, compute-bound at the 989 TFLOP/s
// bf16 peak (104-280 us). The TPU kernel's point, which this keeps, is that
// the dequantized (K, N) bf16 weight never exists in HBM: each block
// dequantizes a 64 x 128 tile of kq into shared memory, transposed for the
// B operand, so the weight is read once per block at one byte per element.
//
// Blocking: one block of 8 warps per (128 rows of g, 128 columns of dx); the
// 128 dx columns are one scale group, so a tile needs one scale per n. Each
// warp owns 64 rows x 32 columns (4 x 4 mma.sync m16n8k16 bf16 tiles). The
// contraction over N runs in 64-wide tiles; rows past M and columns past N
// are zero in shared memory.
// Not yet done (later work): cp.async/TMA pipelining, wgmma, ldmatrix.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::mma_16816;
using flash::pack_f32;
using flash::pack_raw;

constexpr int BM = 128;        // rows of g and dx per block
constexpr int BKO = 128;       // dx columns per block: one scale group
constexpr int BC = 64;         // contraction (N) per shared-memory tile
constexpr int GP = BC + 8;     // g_s pitch: 144-byte rows, conflict-free A
constexpr int WP = BKO + 8;    // w_s pitch: 272-byte rows
constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS)
quant_dx_kernel(const bf16* __restrict__ gr, const int8_t* __restrict__ kq,
                const float* __restrict__ scale, bf16* __restrict__ dx, int M,
                int N, int K) {
  __shared__ __align__(16) bf16 g_s[BM * GP];
  __shared__ __align__(16) bf16 w_s[BC * WP];

  const int grp = blockIdx.x;
  const int k0 = grp * BKO;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 2) * 64;  // the warp's rows within the tile
  const int wk = (warp & 3) * 32;   // the warp's dx columns within the tile

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    }
  }

  for (int c0 = 0; c0 < N; c0 += BC) {
    // g tile: 128 rows x 8 chunks of 8 bf16, 4 chunks a thread
#pragma unroll
    for (int j = 0; j < BM * (BC / 8) / NTHREADS; ++j) {
      const int i = threadIdx.x + j * NTHREADS;
      const int row = i / (BC / 8);
      const int ch = (i % (BC / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < M && c0 + ch < N) {  // N % 8 == 0: whole chunks
        v = *reinterpret_cast<const uint4*>(
            gr + static_cast<long long>(m0 + row) * N + c0 + ch);
      }
      *reinterpret_cast<uint4*>(g_s + row * GP + ch) = v;
    }
    // W tile: 64 rows (n) x 8 chunks of 16 int8 (k), dequantized to bf16,
    // 2 chunks a thread
#pragma unroll
    for (int j = 0; j < BC * (BKO / 16) / NTHREADS; ++j) {
      const int i = threadIdx.x + j * NTHREADS;
      const int row = i / (BKO / 16);
      const int ch = (i % (BKO / 16)) * 16;
      const int n = c0 + row;
      uint32_t w[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      if (n < N) {
        const uint4 q = *reinterpret_cast<const uint4*>(
            kq + static_cast<long long>(n) * K + k0 + ch);
        const int8_t* e = reinterpret_cast<const int8_t*>(&q);
        const float sf = __bfloat162float(__float2bfloat16_rn(
            scale[static_cast<long long>(grp) * N + n]));
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          w[p] = pack_f32(__fmul_rn(static_cast<float>(e[2 * p]), sf),
                          __fmul_rn(static_cast<float>(e[2 * p + 1]), sf));
        }
      }
      uint4* dst = reinterpret_cast<uint4*>(w_s + row * WP + ch);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BC; ks += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const bf16* p = g_s + (wm + mt * 16 + g) * GP + ks + 2 * t;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * GP);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * GP + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        // B[n][k] = W[ks + n][wk + nt*8 + k]: two rows of w_s per register
        const bf16* p = w_s + (ks + 2 * t) * WP + wk + nt * 8 + g;
        const uint32_t b0 = pack_raw(p[0], p[WP]);
        const uint32_t b1 = pack_raw(p[8 * WP], p[9 * WP]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_16816(acc[mt][nt], af[mt], b0, b1);
      }
    }
    __syncthreads();  // the next tile overwrites g_s / w_s
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + mt * 16 + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = k0 + wk + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(dx + static_cast<long long>(row) * K +
                                     col) =
            pack_f32(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  }
}

}  // namespace

extern "C" int quant_dx(const void* g, const void* kq, const void* scale_g,
                        void* dx, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || K % BKO != 0 ||
      (M + BM - 1) / BM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(K / BKO, (M + BM - 1) / BM);
  quant_dx_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), static_cast<const int8_t*>(kq),
      static_cast<const float*>(scale_g), static_cast<bf16*>(dx), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
