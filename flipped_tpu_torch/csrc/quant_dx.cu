// K4 for Hopper: the backward of the grouped w8a8 modes (w8a8g / w8a8o),
// dx = g @ dequant(W)^T (the kernel body is dx_wgmma.cuh's, PACKED = false).
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
// the dequantized (K, N) bf16 weight never exists in HBM: the int8 codes
// come into shared memory by TMA, one byte an element, and each is
// converted to bf16 (through f32, exact) and multiplied by its bf16 scale
// on its way into wgmma's register A operand (dx_wgmma.cuh).
// Not yet done (later work): a persistent grid, TMA multicast of the g tile
// across a cluster (g is 4/5 of the bytes each stage brings from L2).

#include "dx_wgmma.cuh"

namespace {

__global__ void __launch_bounds__(dxw::THREADS, 1)
quant_dx_kernel(const __grid_constant__ CUtensorMap g_map,
                const __grid_constant__ CUtensorMap w_map,
                const __grid_constant__ CUtensorMap s_map,
                dxw::bf16* __restrict__ out, int M, int N, int K, int group) {
  dxw::dx_body<false>(g_map, w_map, s_map, out, M, N, K, group);
}

}  // namespace

extern "C" int quant_dx(const void* g, const void* kq, const void* scale_g,
                        void* out, int M, int N, int K, void* stream) {
  return static_cast<int>(dxw::launch<false>(
      quant_dx_kernel, g, kq, scale_g, out, M, N, K, dxw::BKO,
      static_cast<cudaStream_t>(stream)));
}
