// K3 for Hopper: the w8a8 per-channel forward, out = x @ dequant(W) with x
// quantized per row.
//
// Replaces the TPU kernel int8_fwd_pallas -> _fwd_kernel
// (flipped_tpu/model/pallas/quant_matmul.py:603-698). What it computes, for
// x (M, K) bf16, kq (N, K) int8 (the port's layout, K-contiguous), scale (N,)
// f32:
//   xs[m]    = max(amax_k |x[m, k]| * float32(1/127), 1e-8)
//   xq[m, k] = rint(x[m, k] / xs[m])                     half to even, int8
//   d[m, n]  = sum_k xq[m, k] * kq[n, k]                  exact, int32
//   out[m,n] = bf16((float(d) * xs[m]) * scale[n])        the JAX order,
//                                                         model/int8.py:77
// Two launches on the caller's stream: the quantize pass (one warp per row,
// writing xq and xs to scratch the wrapper allocates) and the GEMM
// (quant_common.cuh, mma.sync m16n8k32 s8, 128 x 128 tiles).
//
// What bounds it on an H100: at the 7B training shapes (M 3072, K 4096 or
// 11008, N 4096 or 11008) a call is 103-277 GOP of int8 products on 67-138
// MB of operands, ~1500 operations per byte, far above the ~590 at which
// int8 tensor cores and not HBM are the limit: it is compute-bound (52-140
// us at the 1979 TOP/s peak). The design keeps the int32 sums in registers
// and reads each operand tile into shared memory once per block; the
// quantize pass costs one extra write and read of xq (M*K bytes).
// Not yet done (later work): cp.async/TMA pipelining, wgmma, fusing the
// quantize into the GEMM's A loads.

#include "quant_common.cuh"

extern "C" int int8_fwd(const void* x, const void* kq, const void* scale,
                        void* xq, void* xs, void* out, int M, int N, int K,
                        void* stream) {
  if (!quant::shapes_ok(M, N, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = quant::launch_quantize<false>(x, xq, xs, M, K, K, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      quant::launch_gemm<false>(xq, kq, xs, scale, out, M, N, K, st));
}
