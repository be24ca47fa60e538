// K7 for Hopper: the grouped (sub-channel) w8a8 forward of --quantize
// w8a8g / w8a8o.
//
// Replaces the TPU kernel grouped_matmul_pallas -> _kernel
// (flipped_tpu/model/pallas/quant_matmul.py:55-145). What it computes, for
// x (M, K) bf16, kq (N, K) int8 (the port's layout), scale_g (G, N) f32 with
// G = K / 128:
//   xs[m, g]  = max(amax over group g of |x[m, :]| / 127, 1e-8)   a division,
//                                              as model/int8.py:257 writes it
//   xq[m, k]  = rint(x[m, k] / xs[m, k / 128])                    half to even
//   d_g[m, n] = sum over group g of xq[m, k] * kq[n, k]           exact, int32
//   acc       = sum_g (float(d_g) * xs[m, g]) * scale_g[g, n]     f32, over the
//                                              groups in order 0..G-1
//   out[m, n] = bf16(acc)
// Two launches on the caller's stream: the quantize pass (one warp per
// (row, group)) and the GEMM (quant_common.cuh), which folds each group's
// int32 tile into its f32 accumulators after every 128-byte K tile.
//
// What bounds it on an H100: the same int8 products as K3 at the same
// shapes, compute-bound at the 1979 TOP/s peak; the per-group fold adds 3
// f32 operations per output element and group (1/85 of the int8 work).
// The TPU kernel kept the (G, M, N) partial products of the batched XLA
// formulation out of HBM; here they never leave registers either.
// Not yet done (later work): cp.async/TMA pipelining, wgmma, fusing the
// quantize into the GEMM's A loads (each group is local to one K tile).

#include "quant_common.cuh"

extern "C" int int8_grouped_fwd(const void* x, const void* kq,
                                const void* scale_g, void* xq, void* xs,
                                void* out, int M, int N, int K,
                                void* stream) {
  if (!quant::shapes_ok(M, N, K) || K % quant::BK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = quant::launch_quantize(x, xq, xs, M, K, quant::BK, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      quant::launch_gemm(xq, kq, xs, scale_g, out, M, N, K, st));
}
