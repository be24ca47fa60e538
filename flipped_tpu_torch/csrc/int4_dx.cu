// K9 for Hopper: the backward of the packed-int4 modes (int4, w4a8 and
// their rotated variants), dx = g @ dequant(W)^T.
//
// Replaces the TPU kernel int4_dx_pallas -> _int4_dx_kernel
// (flipped_tpu/model/pallas/quant_matmul.py:701-766). What it computes, for
// g (M, N) bf16, kq4 (N/2, K) packed int4 (the port's layout: byte [j, k]
// holds W[j, k] in its low nibble and W[j + N/2, k] in its high nibble),
// scale_g (G, N) f32 with group = K / G a multiple of 128:
//   W[n, k]   = bf16(bf16(code[n, k]) * bf16(scale_g[k / group, n]))   the
//               JAX rounding (model/int4.py:77-86)
//   dx[m, k]  = bf16(sum_n g[m, n] * W[n, k])      f32 accumulation
// It is K4 (quant_dx.cu) with the packed dequantize: each block takes 32
// packed rows per contraction tile, i.e. the columns g[:, j-tile] and
// g[:, N/2 + j-tile] against the low and the high nibbles of the same bytes
// (dx_common.cuh, PACKED = true). The plain version (a bf16 product on the
// dequantized weight) differs from it only in the order of the f32 sums.
//
// What bounds it on an H100: at the 7B training shapes a call is 103-277
// GFLOP of bf16 products on 40-97 MB, compute-bound at the 989 TFLOP/s bf16
// peak (104-280 us). As on the TPU, neither the unpacked int8 nor the
// dequantized bf16 (K, N) weight ever exists in HBM: the packed weight is
// read once per 128-row block at half a byte an element.
// Not yet done (later work): cp.async/TMA pipelining, wgmma, ldmatrix.

#include "dx_common.cuh"

namespace {

__global__ void __launch_bounds__(dx::NTHREADS)
int4_dx_kernel(const dx::bf16* __restrict__ g, const int8_t* __restrict__ kq4,
               const float* __restrict__ scale, dx::bf16* __restrict__ out,
               int M, int N, int K, int group) {
  dx::dx_tile<true>(g, kq4, scale, out, M, N, K, group);
}

}  // namespace

extern "C" int int4_dx(const void* g, const void* kq4, const void* scale_g,
                       void* out, int M, int N, int K, int group,
                       void* stream) {
  if (!dx::shapes_ok(true, M, N, K, group)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int4_dx_kernel<<<dx::grid(M, K), dx::NTHREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const dx::bf16*>(g), static_cast<const int8_t*>(kq4),
      static_cast<const float*>(scale_g), static_cast<dx::bf16*>(out), M, N,
      K, group);
  return static_cast<int>(cudaGetLastError());
}
