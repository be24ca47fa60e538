// Device code shared by K7 (int8_grouped_fwd.cu) and K8's w4a8 branch
// (int4_fwd.cu): the grouped activation quantize pass and the int8
// tensor-core GEMM tile with its two B layouts and the grouped epilogue;
// the scale constants K3 (int8_fwd.cu) and K10 (int8_dgrad.cu) share.
//
// mma.sync m16n8k32 fragment layouts (s8 in, s32 accumulate), with lane =
// 4 * g + t (g = lane >> 2 in 0..7, t = lane & 3):
//   A (16 x 32, row): a0 = A[g][4t..4t+3]       a1 = A[g+8][4t..4t+3]
//                     a2 = A[g][16+4t..19+4t]   a3 = A[g+8][16+4t..19+4t]
//   B (32 x 8, col):  b0 = B[4t..4t+3][g]       b1 = B[16+4t..19+4t][g]
//   C (16 x 8):       c0, c1 = C[g][2t, 2t+1]   c2, c3 = C[g+8][2t, 2t+1]
// The four int8 values of a register are consecutive in K, the lowest
// address in the low byte. xq (M, K) and kq (N, K) are both K-contiguous, so
// every fragment register is one aligned 32-bit load from shared memory.
//
// Rounding: every float step is an explicit __fmul_rn / __fadd_rn /
// __fdiv_rn, so nvcc cannot contract a multiply and an add into an FMA, and
// the kernels compute bit for bit what their plain PyTorch versions compute
// (model/kernels/quant_matmul.py): the int8 dots are exact int32 sums, the
// int32 -> f32 conversion rounds to nearest even as PyTorch's does, and the
// bf16 output rounds to nearest even.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace quant {

typedef __nv_bfloat16 bf16;

constexpr float EPS = 1e-8f;              // scale floor: zero rows give 0
constexpr float INV127 = 0x1.020408p-7f;  // float32(1/127)

// ---------------------------------------------------------------------------
// Quantize pass: one warp per (row, group) of x (M, K) bf16, group | K. The
// scale is amax / 127 (the grouped formulation of K7 and K8), floored at
// EPS; each code is rint(x / scale), half to even. Writes xq (M, K) int8
// and xs (M, K / group) f32.
// ---------------------------------------------------------------------------
constexpr int QWARPS = 4;  // (row, group) items per block

// (static: every source that includes this header keeps its own copy)
static __global__ void __launch_bounds__(QWARPS * 32)
quantize_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, long long items, int group) {
  const long long item =
      static_cast<long long>(blockIdx.x) * QWARPS + threadIdx.x / 32;
  if (item >= items) return;  // the whole warp leaves together
  const int lane = threadIdx.x % 32;
  // row * K + gi * group == item * group
  const bf16* xr = x + item * group;
  int8_t* qr = xq + item * group;
  const int nvec = group / 8;  // 16-byte vectors of 8 bf16

  float amax = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + v * 8);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  const float s = fmaxf(__fdiv_rn(amax, 127.f), EPS);
  if (lane == 0) xs[item] = s;

  for (int v = lane; v < nvec; v += 32) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + v * 8);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      const int q0 = __float2int_rn(__fdiv_rn(f.x, s));
      const int q1 = __float2int_rn(__fdiv_rn(f.y, s));
      const uint32_t pair = (static_cast<uint32_t>(q0) & 0xffu) |
                            ((static_cast<uint32_t>(q1) & 0xffu) << 8);
      w[j >> 1] |= pair << (16 * (j & 1));
    }
    *reinterpret_cast<uint2*>(qr + v * 8) = make_uint2(w[0], w[1]);
  }
}

inline cudaError_t launch_quantize(const void* x, void* xq, void* xs, int M,
                                   int K, int group, cudaStream_t stream) {
  const long long items = static_cast<long long>(M) * (K / group);
  const long long blocks = (items + QWARPS - 1) / QWARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  quantize_rows_kernel<<<static_cast<unsigned>(blocks), QWARPS * 32, 0,
                         stream>>>(static_cast<const bf16*>(x),
                                   static_cast<int8_t*>(xq),
                                   static_cast<float*>(xs), items, group);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// GEMM tile: out (M, N) bf16 from a (M, Kc) int8, row-major, and an int8 B
// operand, with mma.sync m16n8k32 s8 -> s32. One block of 8 warps per
// 128 x 128 output tile; each warp owns 64 rows x 32 columns (4 x 4 mma
// tiles). The contraction streams through shared memory in 128-byte tiles;
// rows past M or N and bytes past Kc are zero in shared memory. B is one of
//   B_NK      (N, Kc), Kc-contiguous: kq of K7, each fragment register
//             one aligned 32-bit load;
//   B_PACKED4 (N/2, Kc) packed int4 (K8): byte [j, k] holds column j in its
//             low nibble and column j + N/2 in its high nibble. A block
//             covers 64 packed rows, i.e. output columns [j0, j0 + 64) and
//             [N/2 + j0, N/2 + j0 + 64); one 32-bit load of 4 packed bytes
//             gives the fragment registers of both columns, the nibbles
//             sign-extended bytewise.
// Epilogue (K7, K8 w4a8): after each `group`-wide slice g of Kc (a
//   multiple of 128), in order, acc = acc + (float(d_g) * xs[m, g]) *
//   scale[g, n], then d_g = 0; out = bf16(acc). |d_g| <= 127 * 127 * Kc
//     < 2^24 up to Kc = 1040, and with int4 weights (|w| <= 8) up to
//     Kc = 16513, so float(d_g) is exact on every shape the model has.
// ---------------------------------------------------------------------------
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 128;
constexpr int PITCH = BK + 16;  // 144-byte rows: fragment loads hit 32 banks
constexpr int GEMM_THREADS = 256;

enum BMode { B_NK = 0, B_PACKED4 = 1 };

__device__ __forceinline__ void mma_s8_16832(int d[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The signed low / high nibbles of 4 packed bytes as 4 int8 bytes:
// (v ^ 8) - 8 per byte maps the nibble v in 0..15 to v - 16 * (v >= 8).
__device__ __forceinline__ uint32_t nibbles_lo(uint32_t p) {
  return __vsub4((p & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint32_t nibbles_hi(uint32_t p) {
  return nibbles_lo(p >> 4);
}

template <int BMODE>
__device__ __forceinline__ void gemm_tile(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b,
    const float* __restrict__ xs, const float* __restrict__ scale,
    bf16* __restrict__ out, int M, int N, int Kc, int group) {
  __shared__ __align__(16) int8_t a_s[BM * PITCH];
  __shared__ __align__(16) int8_t b_s[BN * PITCH];
  constexpr bool PACKED = BMODE == B_PACKED4;

  const int m0 = blockIdx.y * BM;
  // PACKED: the block's first packed row j0; else its first column
  const int n0 = blockIdx.x * (PACKED ? BN / 2 : BN);
  const int nh = N / 2;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 2) * 64;  // the warp's rows within the tile
  // the warp's columns within the tile (PACKED: its 16 packed rows)
  const int wn = (warp & 3) * (PACKED ? 16 : 32);
  const int groups = Kc / group;    // Kc % group == 0

  // column of fragment column 2t of n-tile nt; PACKED n-tiles 0, 1 are the
  // low nibbles of packed tiles 0, 1 and n-tiles 2, 3 their high nibbles
  auto col_of = [&](int nt) {
    if (PACKED) return (nt >= 2 ? nh : 0) + n0 + wn + (nt & 1) * 8 + 2 * t;
    return n0 + wn + nt * 8 + 2 * t;
  };
  auto col_ok = [&](int nt) {
    return PACKED ? n0 + wn + (nt & 1) * 8 + 2 * t < nh : col_of(nt) < N;
  };

  int acc[4][4][4];
  float facc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[mt][nt][i] = 0;
        facc[mt][nt][i] = 0.f;
      }
    }
  }

  const int n_kt = (Kc + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    // A: 128 rows x 8 chunks of 16 bytes, 4 chunks a thread
#pragma unroll
    for (int j = 0; j < BM * (BK / 16) / GEMM_THREADS; ++j) {
      const int i = threadIdx.x + j * GEMM_THREADS;
      const int row = i / (BK / 16);
      const int ch = (i % (BK / 16)) * 16;
      uint4 av = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + ch < Kc && m0 + row < M) {  // Kc % 16 == 0: whole chunks
        av = *reinterpret_cast<const uint4*>(
            a + static_cast<long long>(m0 + row) * Kc + k0 + ch);
      }
      *reinterpret_cast<uint4*>(a_s + row * PITCH + ch) = av;
    }
    // B_NK: 128 rows, B_PACKED4: 64 packed rows, of 8 chunks of 16 bytes
    constexpr int ROWS = PACKED ? BN / 2 : BN;
    const int rows_in = PACKED ? nh : N;
#pragma unroll
    for (int j = 0; j < ROWS * (BK / 16) / GEMM_THREADS; ++j) {
      const int i = threadIdx.x + j * GEMM_THREADS;
      const int row = i / (BK / 16);
      const int ch = (i % (BK / 16)) * 16;
      uint4 bv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + ch < Kc && n0 + row < rows_in) {
        bv = *reinterpret_cast<const uint4*>(
            b + static_cast<long long>(n0 + row) * Kc + k0 + ch);
      }
      *reinterpret_cast<uint4*>(b_s + row * PITCH + ch) = bv;
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[4][4];
      uint32_t bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int8_t* p = a_s + (wm + mt * 16 + g) * PITCH + ks + 4 * t;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * PITCH);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * PITCH + 16);
      }
      if (PACKED) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int8_t* p = b_s + (wn + np * 8 + g) * PITCH + ks + 4 * t;
          const uint32_t p0 = *reinterpret_cast<const uint32_t*>(p);
          const uint32_t p1 = *reinterpret_cast<const uint32_t*>(p + 16);
          bfr[np][0] = nibbles_lo(p0);
          bfr[np][1] = nibbles_lo(p1);
          bfr[np + 2][0] = nibbles_hi(p0);
          bfr[np + 2][1] = nibbles_hi(p1);
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int8_t* p = b_s + (wn + nt * 8 + g) * PITCH + ks + 4 * t;
          bfr[nt][0] = *reinterpret_cast<const uint32_t*>(p);
          bfr[nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_s8_16832(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites a_s / b_s

    if ((k0 + BK) % group == 0) {
      const int gi = k0 / group;
      float sv[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          sv[nt][c] = col_ok(nt)
              ? scale[static_cast<long long>(gi) * N + col_of(nt) + c]
              : 0.f;
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm + mt * 16 + g + 8 * h;
          const float xv =
              row < M ? xs[static_cast<long long>(row) * groups + gi] : 0.f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int i = 2 * h + c;
              facc[mt][nt][i] = __fadd_rn(
                  facc[mt][nt][i],
                  __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][i]), xv),
                            sv[nt][c]));
              acc[mt][nt][i] = 0;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + mt * 16 + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (!col_ok(nt)) continue;  // N (or N/2) % 8 == 0: col + 1 is in
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<long long>(row) * N + col_of(nt)) =
            __floats2bfloat162_rn(facc[mt][nt][2 * h],
                                  facc[mt][nt][2 * h + 1]);
      }
    }
  }
}

// K7: B_NK, group 128
static __global__ void __launch_bounds__(GEMM_THREADS)
int8_gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ kq,
                 const float* __restrict__ xs,
                 const float* __restrict__ scale, bf16* __restrict__ out,
                 int M, int N, int K) {
  gemm_tile<B_NK>(xq, kq, xs, scale, out, M, N, K, BK);
}

inline cudaError_t launch_gemm(const void* xq, const void* kq, const void* xs,
                        const void* scale, void* out, int M, int N, int K,
                        cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<<<grid, GEMM_THREADS, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(kq),
      static_cast<const float*>(xs), static_cast<const float*>(scale),
      static_cast<bf16*>(out), M, N, K);
  return cudaGetLastError();
}

// The shapes K7 takes; the Python wrappers check the same.
inline bool shapes_ok(int M, int N, int K) {
  return M > 0 && N > 0 && K > 0 && K % 16 == 0 && N % 8 == 0 &&
         (M + BM - 1) / BM <= 65535;
}

}  // namespace quant
