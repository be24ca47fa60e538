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
// It is K4 (quant_dx.cu) with the packed dequantize: the kernel body is
// dx_wgmma.cuh's with PACKED = true, whose stages alternate between the low
// nibbles of 64 packed rows (against g's columns j) and the high nibbles of
// the same bytes (against columns N/2 + j), each nibble converted to bf16
// (hopper_common.cuh's nibbles_bf16x2, exact) and multiplied by its bf16
// scale on its way into wgmma's register A operand. The plain version (a
// bf16 product on the dequantized weight) differs from it only in the
// order of the f32 sums.
//
// What bounds it on an H100: at the 7B training shapes a call is 103-277
// GFLOP of bf16 products on 40-97 MB, compute-bound at the 989 TFLOP/s bf16
// peak (104-280 us). As on the TPU, neither the unpacked int8 nor the
// dequantized bf16 (K, N) weight ever exists in HBM: the packed weight is
// read at half a byte an element (each stage's packed box twice, the
// second time from L2).
// Not yet done (later work): a persistent grid, TMA multicast of the g tile
// across a cluster.

#include "dx_wgmma.cuh"

namespace {

__global__ void __launch_bounds__(dxw::THREADS, 1)
int4_dx_kernel(const __grid_constant__ CUtensorMap g_map,
               const __grid_constant__ CUtensorMap w_map,
               const __grid_constant__ CUtensorMap s_map,
               dxw::bf16* __restrict__ out, int M, int N, int K, int group) {
  dxw::dx_body<true>(g_map, w_map, s_map, out, M, N, K, group);
}

}  // namespace

extern "C" int int4_dx(const void* g, const void* kq4, const void* scale_g,
                       void* out, int M, int N, int K, int group,
                       void* stream) {
  return static_cast<int>(dxw::launch<true>(
      int4_dx_kernel, g, kq4, scale_g, out, M, N, K, group,
      static_cast<cudaStream_t>(stream)));
}
