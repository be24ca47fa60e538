// Device code shared by K4 (quant_dx.cu) and K9 (int4_dx.cu): dx = g @
// dequant(W)^T with the weight dequantized tile by tile in shared memory.
//
//   W[n, k]  = bf16(bf16(code[n, k]) * bf16(scale_g[k / group, n]))   the JAX
//              rounding (model/int8.py:389-390, model/int4.py:77-86): the
//              product of two bf16 values is exact in f32, then rounds to
//              nearest even
//   dx[m, k] = bf16(sum_n g[m, n] * W[n, k])      f32 accumulation
//
// Blocking: one block of 8 warps per (128 rows of g, 128 columns of dx); the
// 128 dx columns lie in one scale group (group % 128 == 0), so a tile needs
// one scale per n. Each warp owns 64 rows x 32 columns (4 x 4 mma.sync
// m16n8k16 bf16 tiles). The contraction over N runs in 64-wide tiles; rows
// past M and columns past N are zero in shared memory.
//   K4 (PACKED = false): codes from kq (N, K) int8; a tile is n in
//     [c0, c0 + 64).
//   K9 (PACKED = true): codes from kq4 (N/2, K) packed int4, byte [j, k]
//     holding W[j, k] (low nibble) and W[j + N/2, k] (high nibble); a tile
//     is 32 packed rows j in [c0, c0 + 32): its n are [c0, c0 + 32) and
//     [N/2 + c0, N/2 + c0 + 32), so g_s takes those two 32-column slices of
//     g and w_s the low then the high nibbles of the same packed bytes, each
//     read once.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace dx {

using flash::bf16;
using flash::mma_16816;
using flash::pack_f32;
using flash::pack_raw;

constexpr int BM = 128;        // rows of g and dx per block
constexpr int BKO = 128;       // dx columns per block: within one group
constexpr int BC = 64;         // contraction (N) per shared-memory tile
constexpr int GP = BC + 8;     // g_s pitch: 144-byte rows, conflict-free A
constexpr int WP = BKO + 8;    // w_s pitch: 272-byte rows
constexpr int NTHREADS = 256;

// 16 dequantized values as bf16 pairs: bf16(code) * sf rounded to bf16
__device__ __forceinline__ void dequant16(const int8_t* e, float sf,
                                          uint32_t w[8]) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    w[p] = pack_f32(__fmul_rn(static_cast<float>(e[2 * p]), sf),
                    __fmul_rn(static_cast<float>(e[2 * p + 1]), sf));
  }
}

__device__ __forceinline__ float scale_bf16(const float* scale, long long i) {
  return __bfloat162float(__float2bfloat16_rn(scale[i]));
}

// The body of K4's and K9's kernels (quant_dx.cu, int4_dx.cu), one block
// of NTHREADS threads on grid (K / BKO, ceil(M / BM)).
template <bool PACKED>
__device__ __forceinline__ void dx_tile(const bf16* __restrict__ gr,
                                        const int8_t* __restrict__ kq,
                                        const float* __restrict__ scale,
                                        bf16* __restrict__ out, int M, int N,
                                        int K, int group) {
  __shared__ __align__(16) bf16 g_s[BM * GP];
  __shared__ __align__(16) bf16 w_s[BC * WP];

  const int k0 = blockIdx.x * BKO;
  const long long srow = static_cast<long long>(k0 / group) * N;
  const int m0 = blockIdx.y * BM;
  const int nh = N / 2;
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

  const int c_end = PACKED ? nh : N;
  for (int c0 = 0; c0 < c_end; c0 += PACKED ? BC / 2 : BC) {
    // g tile: 128 rows x 8 chunks of 8 bf16, 4 chunks a thread; PACKED:
    // chunks 0-3 from columns c0.., chunks 4-7 from nh + c0..
#pragma unroll
    for (int j = 0; j < BM * (BC / 8) / NTHREADS; ++j) {
      const int i = threadIdx.x + j * NTHREADS;
      const int row = i / (BC / 8);
      const int ch = (i % (BC / 8)) * 8;
      const int n = PACKED ? c0 + ch % (BC / 2) : c0 + ch;
      const int col = PACKED && ch >= BC / 2 ? nh + n : n;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < M && n < c_end) {  // N (N/2) % 8 == 0: whole chunks
        v = *reinterpret_cast<const uint4*>(
            gr + static_cast<long long>(m0 + row) * N + col);
      }
      *reinterpret_cast<uint4*>(g_s + row * GP + ch) = v;
    }
    if (PACKED) {
      // 32 packed rows x 8 chunks of 16 bytes, one a thread: the low
      // nibbles go to w_s row r, the high nibbles to row 32 + r
      const int r = threadIdx.x / (BKO / 16);
      const int ch = (threadIdx.x % (BKO / 16)) * 16;
      const int j = c0 + r;
      uint32_t wl[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      uint32_t wh[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      if (j < nh) {
        const uint4 q = *reinterpret_cast<const uint4*>(
            kq + static_cast<long long>(j) * K + k0 + ch);
        const uint32_t* qw = reinterpret_cast<const uint32_t*>(&q);
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          lo[i] = __vsub4((qw[i] & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
          hi[i] = __vsub4(((qw[i] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                          0x08080808u);
        }
        dequant16(reinterpret_cast<const int8_t*>(lo),
                  scale_bf16(scale, srow + j), wl);
        dequant16(reinterpret_cast<const int8_t*>(hi),
                  scale_bf16(scale, srow + nh + j), wh);
      }
      uint4* dl = reinterpret_cast<uint4*>(w_s + r * WP + ch);
      uint4* dh = reinterpret_cast<uint4*>(w_s + (BC / 2 + r) * WP + ch);
      dl[0] = make_uint4(wl[0], wl[1], wl[2], wl[3]);
      dl[1] = make_uint4(wl[4], wl[5], wl[6], wl[7]);
      dh[0] = make_uint4(wh[0], wh[1], wh[2], wh[3]);
      dh[1] = make_uint4(wh[4], wh[5], wh[6], wh[7]);
    } else {
      // 64 rows (n) x 8 chunks of 16 int8 (k), 2 chunks a thread
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
          dequant16(reinterpret_cast<const int8_t*>(&q),
                    scale_bf16(scale, srow + n), w);
        }
        uint4* dst = reinterpret_cast<uint4*>(w_s + row * WP + ch);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
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
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * K +
                                     col) =
            pack_f32(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  }
}

// The shapes both kernels take; the Python wrappers check the same.
inline bool shapes_ok(bool packed, int M, int N, int K, int group) {
  return M > 0 && N > 0 && K > 0 && N % (packed ? 16 : 8) == 0 &&
         group > 0 && group % BKO == 0 && K % group == 0 &&
         (M + BM - 1) / BM <= 65535;
}

inline dim3 grid(int M, int K) { return dim3(K / BKO, (M + BM - 1) / BM); }

}  // namespace dx
