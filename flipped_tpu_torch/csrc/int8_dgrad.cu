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
// Two launches:
//   - the quantize pass, one block of 256 threads per row: 16-byte loads of
//     g and of scale, the row's scaled values kept in registers between the
//     amax and the codes (rows up to 256 x 8 x QV = 12288 wide; a longer
//     row reads g a second time), 8 codes stored at once;
//   - the GEMM, dx = gq . kq over N, on wgmma (wgmma_int8.cuh): TMA-fed,
//     the operands swapped so that the MN-major kq is transposed 4 x 4
//     bytes at a time on its way from shared memory into wgmma's register
//     A operand, gq read by wgmma from shared memory as TMA wrote it.
// Every float step is an explicit __fmul_rn / __fdiv_rn / __fsub_rn, so the
// kernel computes the plain version's IEEE operations bit for bit; the
// int32 sums are exact in any order.
//
// What bounds it on an H100: at the 7B training shapes a call is 103-277
// G multiply-adds of int8 (52-140 us at the 1979 TOP/s peak); the quantize
// pass reads g once and writes the codes, M * N * 3 bytes or about 0.03 ms
// at 3.35 TB/s for M 3072, N 11008.
// Not yet done (later work): fusing the quantize pass into the GEMM (its
// A loads need the whole row's amax first, as the TPU kernel's full-N row
// blocks do), a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_common.cuh"
#include "wgmma_int8.cuh"

namespace {

using quant::bf16;

constexpr int QTHREADS = 256;
constexpr int QV = 6;             // 8-wide vectors a thread keeps on chip

// 8 consecutive scales from n (n % 8 == 0): two 16-byte loads where the
// tensor is 16-byte aligned
__device__ __forceinline__ void load_scale8(const float* scale, int n,
                                            bool vec, float s[8]) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(scale + n);
    const float4 b = *reinterpret_cast<const float4*>(scale + n + 4);
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] = scale[n + e];
  }
}

// gs = float(g) * scale for the 8 elements of vector v of the row
__device__ __forceinline__ void scaled8(const bf16* gr, const float* scale,
                                        int v, bool svec, float gs[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(gr + 8 * v);
  const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(&u);
  float s[8];
  load_scale8(scale, 8 * v, svec, s);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(e2[j]);
    gs[2 * j] = __fmul_rn(f.x, s[2 * j]);
    gs[2 * j + 1] = __fmul_rn(f.y, s[2 * j + 1]);
  }
}

// the stochastically rounded, saturated code of x = gs / sc at column n
__device__ __forceinline__ uint32_t sr_code(float gs, float sc, int n,
                                            uint32_t row_u) {
  const float x = __fdiv_rn(gs, sc);
  uint32_t h = __float_as_uint(x);
  h ^= static_cast<uint32_t>(n) * 0x9E3779B9u;
  h ^= row_u;
  h = (h ^ (h >> 16)) * 0x7FEB352Du;
  h = (h ^ (h >> 15)) * 0x846CA68Bu;
  h ^= h >> 16;
  const float u = __fmul_rn(__uint2float_rn(h), 0x1p-32f);
  const float fl = floorf(x);
  const float q = fl + (__fsub_rn(x, fl) > u ? 1.f : 0.f);
  return static_cast<uint32_t>(static_cast<int>(fminf(fmaxf(q, -128.f),
                                                      127.f))) & 0xffu;
}

__device__ __forceinline__ void store_codes8(int8_t* qr, int v,
                                             const float gs[8], float sc,
                                             uint32_t row_u) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    w[e >> 2] |= sr_code(gs[e], sc, 8 * v + e, row_u) << (8 * (e & 3));
  }
  *reinterpret_cast<uint2*>(qr + 8 * v) = make_uint2(w[0], w[1]);
}

__global__ void __launch_bounds__(QTHREADS)
int8_dgrad_quantize_kernel(const bf16* __restrict__ g,
                           const float* __restrict__ scale,
                           int8_t* __restrict__ gq, float* __restrict__ gsc,
                           int N, int s_mod, bool svec) {
  __shared__ float red[QTHREADS / 32];
  const int row = blockIdx.x;
  const bf16* gr = g + static_cast<long long>(row) * N;
  int8_t* qr = gq + static_cast<long long>(row) * N;
  const int nvec = N / 8;

  float keep[QV][8];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < QV; ++j) {
    const int v = threadIdx.x + j * QTHREADS;
    if (v < nvec) {
      scaled8(gr, scale, v, svec, keep[j]);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(keep[j][e]));
    }
  }
  for (int v = threadIdx.x + QV * QTHREADS; v < nvec; v += QTHREADS) {
    float gs[8];
    scaled8(gr, scale, v, svec, gs);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(gs[e]));
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
#pragma unroll
  for (int j = 0; j < QV; ++j) {
    const int v = threadIdx.x + j * QTHREADS;
    if (v < nvec) store_codes8(qr, v, keep[j], sc, row_u);
  }
  for (int v = threadIdx.x + QV * QTHREADS; v < nvec; v += QTHREADS) {
    float gs[8];
    scaled8(gr, scale, v, svec, gs);
    store_codes8(qr, v, gs, sc, row_u);
  }
}

// the rows a call takes: 65535 tiles of 128 rows
constexpr long long MAX_ROWS = 128LL * 65535;

}  // namespace

// gq (M, N) int8 and gsc (M,) f32 are scratch the wrapper allocates.
extern "C" int int8_dgrad(const void* g, const void* kq, const void* scale,
                          void* gq, void* gsc, void* out, int M, int N, int K,
                          int s_mod, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 != 0 || K % 16 != 0 ||
      s_mod <= 0 || M > MAX_ROWS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool svec = reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  int8_dgrad_quantize_kernel<<<M, QTHREADS, 0, st>>>(
      static_cast<const bf16*>(g), static_cast<const float*>(scale),
      static_cast<int8_t*>(gq), static_cast<float*>(gsc), N, s_mod, svec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // dx (M, K) = gq (M, N) . kq (N, K), contraction over N
  return static_cast<int>(wgmma_int8::launch_kn_gemm_row(
      gq, kq, static_cast<const float*>(gsc), static_cast<bf16*>(out), M, K,
      N, st));
}
