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
//               groups in order. Two launches: K7's quantize pass, then the
//               shared int8 GEMM tile (quant_common.cuh) with the packed B
//               layout, so one 32-bit load of 4 packed bytes gives the B
//               fragments of columns j and j + N/2 and each block writes two
//               128-row x 64-column output tiles, as the TPU kernel's program
//               writes its lo and hi tiles.
//
// weight-only (int4): bf16 products on the raw codes with the group scale
// applied to each group's partial product, as _int4_kernel does:
//   d_g[m, n] = sum over group g of bf16(x[m, k]) * W[n, k]   f32 (mma.sync
//               m16n8k16: products exact, sums in the tensor core's order)
//   out[m, n] = bf16(sum_g d_g * scale_g[g, n]), the groups in order, each
//               step a separate multiply and add (__fmul_rn, __fadd_rn).
//   The plain version takes each d_g exactly (a float64 sum rounded once to
//   f32), so the two differ by the f32 rounding of the group sums; the bound
//   is stated in chip_smoke.py (K8_WO_REL).
//   One launch: 128 rows x 64 packed rows (128 output columns) per block of 8
//   warps, each warp 64 rows x 16 packed columns: 4 x 2 packed n-tiles, each
//   feeding a low and a high 16 x 8 accumulator tile. The contraction runs in
//   64-wide tiles; each warp converts the nibbles of its B fragments to bf16
//   in registers (exact: 0x4300 | (v ^ 8) is bf16(128 + (v ^ 8)), minus 136),
//   so the weight crosses shared memory packed, half a byte an element.
//
// What bounds it on an H100: at the 7B training shapes (M 3072, K 4096 or
// 11008, N 4096 or 11008) a call is 103-277 G multiply-adds on 40-97 MB of
// operands, far above both ridge points: compute-bound, at the int8 rate
// for w4a8 (52-140 us at 1979 TOP/s) and the bf16 rate for int4 (104-280 us
// at 989 TFLOP/s). The packed weight is read once per 128-row block at half
// a byte an element, and the unpacked (K, N) weight never exists in HBM,
// which is the TPU kernel's point too.
// Not yet done (later work): cp.async/TMA pipelining, wgmma, fusing the
// w4a8 quantize into the A loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "quant_common.cuh"

namespace {

using flash::bf16;
using flash::mma_16816;

constexpr int BM = 128;
constexpr int BNP = 64;          // packed rows (output column pairs) a block
constexpr int BK = 64;           // contraction per shared-memory tile
constexpr int AP = BK + 8;       // a_s pitch: 144-byte rows, conflict-free A
constexpr int BP = BK + 16;      // b_s pitch in bytes
constexpr int NTHREADS = 256;

// bf16 pair of the signed nibbles in bits 0..3 and 8..11 of v (the codes of
// contraction positions k and k + 1): low half = position k.
__device__ __forceinline__ uint32_t nibble_pair_bf16(uint32_t v) {
  uint32_t u = (v & 0xFu) | ((v & 0xF00u) << 8);
  u = (u ^ 0x00080008u) | 0x43004300u;         // bf16(128 + (v ^ 8))
  const __nv_bfloat162 r = __hsub2(
      *reinterpret_cast<const __nv_bfloat162*>(&u),
      __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                         __ushort_as_bfloat16(0x4308)));   // - 136
  return *reinterpret_cast<const uint32_t*>(&r);
}

__global__ void __launch_bounds__(NTHREADS)
int4_wo_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ kq4,
               const float* __restrict__ scale, bf16* __restrict__ out,
               int M, int N, int K, int group) {
  __shared__ __align__(16) bf16 a_s[BM * AP];
  __shared__ __align__(16) int8_t b_s[BNP * BP];

  const int nh = N / 2;
  const int m0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BNP;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 2) * 64;   // the warp's rows within the tile
  const int wj = (warp & 3) * 16;    // the warp's packed rows within the tile

  float dacc[4][4][4];  // this group's partial products; n-tiles 2, 3 = high
  float facc[4][4][4];  // sum over the finished groups
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dacc[mt][nt][i] = 0.f;
        facc[mt][nt][i] = 0.f;
      }
    }
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: 128 rows x 8 chunks of 8 bf16, 4 chunks a thread
#pragma unroll
    for (int j = 0; j < BM * (BK / 8) / NTHREADS; ++j) {
      const int i = threadIdx.x + j * NTHREADS;
      const int row = i / (BK / 8);
      const int ch = (i % (BK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < M) {  // K % 128 == 0: whole tiles
        v = *reinterpret_cast<const uint4*>(
            x + static_cast<long long>(m0 + row) * K + k0 + ch);
      }
      *reinterpret_cast<uint4*>(a_s + row * AP + ch) = v;
    }
    // packed tile: 64 rows x 4 chunks of 16 bytes, one chunk a thread
    {
      const int row = threadIdx.x / (BK / 16);
      const int ch = (threadIdx.x % (BK / 16)) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (j0 + row < nh) {
        v = *reinterpret_cast<const uint4*>(
            kq4 + static_cast<long long>(j0 + row) * K + k0 + ch);
      }
      *reinterpret_cast<uint4*>(b_s + row * BP + ch) = v;
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const bf16* p = a_s + (wm + mt * 16 + g) * AP + ks + 2 * t;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * AP);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * AP + 8);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        // B[k][n] = W[j0 + wj + np*8 + g][ks + k]: bytes 2t, 2t+1 and
        // 2t+8, 2t+9 of the packed row
        const int8_t* p = b_s + (wj + np * 8 + g) * BP + ks + 2 * t;
        const uint32_t v0 = *reinterpret_cast<const uint16_t*>(p);
        const uint32_t v1 = *reinterpret_cast<const uint16_t*>(p + 8);
        const uint32_t lo0 = nibble_pair_bf16(v0);
        const uint32_t lo1 = nibble_pair_bf16(v1);
        const uint32_t hi0 = nibble_pair_bf16(v0 >> 4);
        const uint32_t hi1 = nibble_pair_bf16(v1 >> 4);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_16816(dacc[mt][np], af[mt], lo0, lo1);
          mma_16816(dacc[mt][np + 2], af[mt], hi0, hi1);
        }
      }
    }
    __syncthreads();  // the next tile overwrites a_s / b_s

    if ((k0 + BK) % group == 0) {
      const long long srow = static_cast<long long>(k0 / group) * N;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int jc = j0 + wj + (nt & 1) * 8 + 2 * t;
        const int col = (nt >= 2 ? nh : 0) + jc;
        const float s0 = jc < nh ? scale[srow + col] : 0.f;
        const float s1 = jc < nh ? scale[srow + col + 1] : 0.f;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            facc[mt][nt][i] = __fadd_rn(
                facc[mt][nt][i], __fmul_rn(dacc[mt][nt][i], i & 1 ? s1 : s0));
            dacc[mt][nt][i] = 0.f;
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
        const int jc = j0 + wj + (nt & 1) * 8 + 2 * t;
        if (jc >= nh) continue;  // N/2 % 8 == 0: jc + 1 is in as well
        const int col = (nt >= 2 ? nh : 0) + jc;
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * N +
                                     col) =
            flash::pack_f32(facc[mt][nt][2 * h], facc[mt][nt][2 * h + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(quant::GEMM_THREADS)
int4_w4a8_gemm_kernel(const int8_t* __restrict__ xq,
                      const int8_t* __restrict__ kq4,
                      const float* __restrict__ xs,
                      const float* __restrict__ scale,
                      bf16* __restrict__ out, int M, int N, int K,
                      int group) {
  quant::gemm_tile<quant::B_PACKED4, quant::EPI_GROUPED>(xq, kq4, xs, scale,
                                                         out, M, N, K, group);
}

}  // namespace

// xq (M, K) int8 and xs (M, K / group) f32 are scratch for the w4a8 branch
// (unused by the weight-only one).
extern "C" int int4_fwd(const void* x, const void* kq4, const void* scale_g,
                        void* xq, void* xs, void* out, int M, int N, int K,
                        int group, int act_quant, void* stream) {
  const int nh = N / 2;
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 != 0 || group <= 0 ||
      group % 128 != 0 || K % group != 0 || (M + BM - 1) / BM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!act_quant) {
    const dim3 grid((nh + BNP - 1) / BNP, (M + BM - 1) / BM);
    int4_wo_kernel<<<grid, NTHREADS, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const int8_t*>(kq4),
        static_cast<const float*>(scale_g), static_cast<bf16*>(out), M, N, K,
        group);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = quant::launch_quantize<true>(x, xq, xs, M, K, group, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nh + quant::BN / 2 - 1) / (quant::BN / 2),
                  (M + quant::BM - 1) / quant::BM);
  int4_w4a8_gemm_kernel<<<grid, quant::GEMM_THREADS, 0, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(kq4),
      static_cast<const float*>(xs), static_cast<const float*>(scale_g),
      static_cast<bf16*>(out), M, N, K, group);
  return static_cast<int>(cudaGetLastError());
}
