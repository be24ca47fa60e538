// K4 for Hopper: the backward of the grouped w8a8 modes (w8a8g / w8a8o),
// dx = g @ dequant(W)^T (the kernel is dx_common.cuh's, PACKED = false).
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
// Not yet done (later work): cp.async/TMA pipelining, wgmma, ldmatrix.

#include "dx_common.cuh"

namespace {

__global__ void __launch_bounds__(dx::NTHREADS)
quant_dx_kernel(const dx::bf16* __restrict__ g, const int8_t* __restrict__ kq,
                const float* __restrict__ scale, dx::bf16* __restrict__ out,
                int M, int N, int K) {
  dx::dx_tile<false>(g, kq, scale, out, M, N, K, dx::BKO);
}

}  // namespace

extern "C" int quant_dx(const void* g, const void* kq, const void* scale_g,
                        void* out, int M, int N, int K, void* stream) {
  if (!dx::shapes_ok(false, M, N, K, dx::BKO)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  quant_dx_kernel<<<dx::grid(M, K), dx::NTHREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const dx::bf16*>(g), static_cast<const int8_t*>(kq),
      static_cast<const float*>(scale_g), static_cast<dx::bf16*>(out), M, N,
      K);
  return static_cast<int>(cudaGetLastError());
}
