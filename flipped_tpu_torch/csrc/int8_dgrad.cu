// K10 for Hopper: the backward of --quantize w8a8d / w8a8rd, dx = g @ W^T
// with the scale-folded cotangent stochastically rounded to int8.
//
// Replaces the TPU kernel int8_dgrad_pallas -> _dgrad_kernel
// (flipped_tpu/model/pallas/quant_matmul.py:449-562). What it computes, for
// g (M, N) bf16, kq (N, K) int8 (the port's layout), scale (N,) f32 and the
// dither's row period s_mod (S of a (B, S, N) cotangent: row = m % s_mod):
//   gs[m, n]  = float(g[m, n]) * scale[n]
//   gsc[m]    = max(amax_n |gs[m, n]| * float32(1/127), 1e-8)
//   x         = gs[m, n] / gsc[m]                        IEEE divide
//   h         = murmur mix of the bits of x, n and m % s_mod (model/int8.py
//               stochastic_round, the JAX int8.py:154-177), in uint32
//   u         = float(h) * 2^-32                         h rounded to f32
//   gq[m, n]  = clamp(floor(x) + (x - floor(x) > u), -128, 127)
//   dx[m, k]  = bf16(float(sum_n gq[m, n] * kq[n, k]) * gsc[m])   exact int32
// The clamp is the saturating float -> int8 conversion of JAX: f32(1/127)
// lies below 1/127, so the row's absmax entry can divide to 127.00001 and
// round up to 128, which a plain conversion would wrap to -128.
// Two launches: the quantize pass (one block per row: the row amax, then the
// codes and gsc written to scratch the wrapper allocates) and the shared int8
// GEMM tile (quant_common.cuh) with B = kq read as (N, K), contraction over
// its rows: int8 mma.sync needs both operands contiguous in the contraction,
// sm_90 has no 8-bit ldmatrix.trans, and a transposed copy of the weight
// would double the frozen backbone's memory; so the tile fill transposes 4 x
// 4 byte blocks of kq in registers on their way to shared memory. Every
// float step is an explicit __fmul_rn / __fdiv_rn / __fsub_rn, so the kernel
// computes the plain version's IEEE operations bit for bit.
//
// What bounds it on an H100: at the 7B training shapes a call is 103-277
// G multiply-adds of int8 (52-140 us at the 1979 TOP/s peak); the quantize
// pass reads g twice (the second time mostly from L2) and writes the codes,
// M * N * 3 bytes or about 0.1 ms at 3.35 TB/s for M 3072, N 11008.
// Not yet done (later work): cp.async/TMA pipelining, wgmma, fusing the
// quantize pass into the GEMM's A loads (it needs the whole row's amax
// first, as the TPU kernel's full-N row blocks do).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_common.cuh"

namespace {

using quant::bf16;

constexpr int QTHREADS = 256;

__device__ __forceinline__ float scaled(const bf16* gr, const float* scale,
                                        int n) {
  return __fmul_rn(__bfloat162float(gr[n]), scale[n]);
}

__global__ void __launch_bounds__(QTHREADS)
int8_dgrad_quantize_kernel(const bf16* __restrict__ g,
                           const float* __restrict__ scale,
                           int8_t* __restrict__ gq, float* __restrict__ gsc,
                           int N, int s_mod) {
  __shared__ float red[QTHREADS / 32];
  const int row = blockIdx.x;
  const bf16* gr = g + static_cast<long long>(row) * N;
  int8_t* qr = gq + static_cast<long long>(row) * N;

  float amax = 0.f;
  for (int n = threadIdx.x; n < N; n += QTHREADS) {
    amax = fmaxf(amax, fabsf(scaled(gr, scale, n)));
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
  const float sc = fmaxf(__fmul_rn(amax, quant::INV127), quant::EPS);
  if (threadIdx.x == 0) gsc[row] = sc;

  const uint32_t row_u = static_cast<uint32_t>(row % s_mod) * 0x85EBCA6Bu;
  for (int n = threadIdx.x; n < N; n += QTHREADS) {
    const float x = __fdiv_rn(scaled(gr, scale, n), sc);
    uint32_t h = __float_as_uint(x);
    h ^= static_cast<uint32_t>(n) * 0x9E3779B9u;
    h ^= row_u;
    h = (h ^ (h >> 16)) * 0x7FEB352Du;
    h = (h ^ (h >> 15)) * 0x846CA68Bu;
    h ^= h >> 16;
    const float u = __fmul_rn(__uint2float_rn(h), 0x1p-32f);
    const float fl = floorf(x);
    const float q = fl + (__fsub_rn(x, fl) > u ? 1.f : 0.f);
    qr[n] = static_cast<int8_t>(fminf(fmaxf(q, -128.f), 127.f));
  }
}

__global__ void __launch_bounds__(quant::GEMM_THREADS)
int8_dgrad_gemm_kernel(const int8_t* __restrict__ gq,
                       const int8_t* __restrict__ kq,
                       const float* __restrict__ gsc, bf16* __restrict__ out,
                       int M, int K, int N) {
  // out (M, K) = gq (M, N) . kq (N, K): the tile's columns are K, its
  // contraction N
  quant::gemm_tile<quant::B_KN, quant::EPI_ROW>(gq, kq, gsc, nullptr, out, M,
                                                K, N, quant::BK);
}

}  // namespace

// gq (M, N) int8 and gsc (M,) f32 are scratch the wrapper allocates.
extern "C" int int8_dgrad(const void* g, const void* kq, const void* scale,
                          void* gq, void* gsc, void* out, int M, int N, int K,
                          int s_mod, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 != 0 || K % 16 != 0 ||
      s_mod <= 0 || (M + quant::BM - 1) / quant::BM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_dgrad_quantize_kernel<<<M, QTHREADS, 0, st>>>(
      static_cast<const bf16*>(g), static_cast<const float*>(scale),
      static_cast<int8_t*>(gq), static_cast<float*>(gsc), N, s_mod);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((K + quant::BN - 1) / quant::BN,
                  (M + quant::BM - 1) / quant::BM);
  int8_dgrad_gemm_kernel<<<grid, quant::GEMM_THREADS, 0, st>>>(
      static_cast<const int8_t*>(gq), static_cast<const int8_t*>(kq),
      static_cast<const float*>(gsc), static_cast<bf16*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
