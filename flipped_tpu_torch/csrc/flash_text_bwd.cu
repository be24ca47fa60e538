// K2 for Hopper: backward of the causal text attention with the gate2
// video-block bias.
//
// Replaces the TPU kernel flash_text_attention_bwd -> _flash_bwd_kernel
// (flipped_tpu/model/pallas/flash_attention.py:174-300). Per (batch b, head
// h), with the scores s[r, c] of K1 (flash_text_fwd.cu) and K1's saved row
// log-sum-exp lse and output O:
//   P[r, c]   = exp(s[r, c] - lse[r])          0 where c > r or r, c >= S
//   D[r]      = sum_d dO[r, d] * O[r, d]       f32
//   dV[c]     = sum_r bf16(P[r, c]) dO[r]      f32 accumulation
//   dP[r, c]  = dO[r] . V[c]                   f32 from bf16 operands
//   dS[r, c]  = P[r, c] (dP[r, c] - D[r])      f32
//   dQ[r]     = scale sum_c bf16(dS[r, c]) K[c]
//   dK[c]     = scale sum_r bf16(dS[r, c]) Q[r]
//   dgate2[h] = sum over b and the video block of dS (f32)
// P and dS are rounded to bf16 before their products, as the TPU kernel
// rounds them (:210, :219).
//
// Layout: q, k, v, out, dout, dq, dk, dv are contiguous (B, S, H, Dh) bf16;
// lse and delta (B, H, S) f32; gate2 (H,) f32; video_start (B,) int32;
// dg2_part (B, H, ceil(S / 64)) f32, summed by the caller.
//
// What bounds it on an H100: at the training shape (B 24, S 128, H 32,
// Dh 128) the call reads q/k/v/out/dout (126 MB) and writes dq/dk/dv
// (75 MB): ~60 us at 3.35 TB/s, against ~16 GFLOP of causal products,
// ~16 us at the dense bf16 peak. So it is bound by bytes, and the design
// reads each operand a small number of times and keeps every S x S tile
// (P, dP, dS) in registers.
// What the design does about the TPU kernel's shape: that kernel held all
// of S x S for one (b, h) in VMEM, which 227 KB of shared memory cannot
// hold at S 650 (TVQA) and beyond. Here the work is tiled in three passes
// (the dkdv and dq tile loops of flash_bwd.cuh at q_offset 0 and S_k = S),
// so any S is taken; the wrapper (model/kernels/flash_attention.py) routes
// S <= MAX_SEQ_BWD = 2048 here and longer sequences to K6, as the JAX
// package does:
//   1. delta: D for every row, one warp per row.
//   2. dq:    one block per (b, h, 64-row q tile), 4 warps x 16 rows, the
//             loop over 32-key K/V tiles up to the diagonal; one dgate2
//             partial per block.
//   3. dkdv:  one block per (b, h, 64-key tile), 4 warps x 16 keys, the loop
//             over 32-row q tiles from the key tile's first row to S; dK and
//             dV in registers.
// No atomics: every output element and every dgate2 partial has one writer,
// so the result is the same from run to run. Rows past S are zero-filled on
// load (0 * garbage could be NaN) and masked out of P.
// Not yet done (later work): moving onto flash_bwd_wgmma.cuh's TMA + wgmma
// loops (K6a's and K6b's, which keep q_offset, S_q and S_k general), and
// fusing the dq pass into the dkdv pass.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bwd.cuh"

namespace {

using flash::bf16;

constexpr int DELTA_ROWS = 8;  // rows (warps) per delta block

template <int DH>
__global__ void __launch_bounds__(DELTA_ROWS * 32)
flash_bwd_delta_kernel(const bf16* __restrict__ out,
                       const bf16* __restrict__ dout,
                       float* __restrict__ delta, int S, int H,
                       long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * DELTA_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* o = out + row * DH;
  const bf16* d = dout + row * DH;
  float acc = 0.f;
#pragma unroll
  for (int c = lane * 4; c < DH; c += 128) {
    const uint2 ov = *reinterpret_cast<const uint2*>(o + c);
    const uint2 dv = *reinterpret_cast<const uint2*>(d + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 a = __bfloat1622float2(o2[j]);
      const float2 b = __bfloat1622float2(d2[j]);
      acc += a.x * b.x + a.y * b.y;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const long long bs = row / H;
    const int s = static_cast<int>(bs % S);
    const long long b = bs / S;
    delta[(b * H + h) * S + s] = acc;
  }
}

template <int DH>
__global__ void __launch_bounds__(flash::BWD_THREADS)
flash_bwd_dkdv_kernel(const flash::BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  flash::dkdv_tile<DH>(a, smem_raw);
}

template <int DH>
__global__ void __launch_bounds__(flash::BWD_THREADS)
flash_bwd_dq_kernel(const flash::BwdArgs a) {
  flash::dq_tile<DH>(a);
}

template <int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const void* lse,
                       const void* gate2, const void* video_start, void* dq,
                       void* dk, void* dv, void* delta, void* dg2_part, int B,
                       int S, int H, int max_feats, float scale,
                       cudaStream_t stream) {
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* g2_ = static_cast<const float*>(gate2);
  const int* vs_ = static_cast<const int*>(video_start);
  float* delta_ = static_cast<float*>(delta);

  const long long rows = static_cast<long long>(B) * S * H;
  const long long n_delta = (rows + DELTA_ROWS - 1) / DELTA_ROWS;
  if (n_delta > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_delta_kernel<DH><<<static_cast<unsigned>(n_delta),
                               DELTA_ROWS * 32, 0, stream>>>(
      static_cast<const bf16*>(out), do_, delta_, S, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const flash::BwdArgs a{
      q_, k_, v_, do_, lse_, delta_, g2_, vs_, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dg2_part), S, S, 0, H, max_feats, scale};
  err = flash::launch_dq(flash_bwd_dq_kernel<DH>, a, B, stream);
  if (err != cudaSuccess) return err;
  return flash::launch_dkdv<DH>(flash_bwd_dkdv_kernel<DH>, a, B, stream);
}

}  // namespace

extern "C" int flash_text_bwd(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              const void* lse, const void* gate2,
                              const void* video_start, void* dq, void* dk,
                              void* dv, void* delta, void* dg2_part, int B,
                              int S, int H, int Dh, int max_feats, float scale,
                              void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {  // every LLaMA preset of the repo has Dh = 128
    case 128:
      return static_cast<int>(launch_bwd<128>(
          q, k, v, out, dout, lse, gate2, video_start, dq, dk, dv, delta,
          dg2_part, B, S, H, max_feats, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
