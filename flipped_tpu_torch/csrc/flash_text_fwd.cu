// K1 for Hopper: causal text attention with the gate2 video-block bias, forward.
//
// Replaces the TPU kernel flash_text_attention -> _flash_kernel
// (flipped_tpu/model/pallas/flash_attention.py:59-171). What it computes, per
// (batch b, head h):
//   s[r, c] = q[r]·k[c] / sqrt(Dh)                      f32 from bf16 operands
//           + gate2[h]  where vs >= 0, r >= vs+F, vs <= c < vs+F
//                       (vs = video_start[b], F = max_feats)
//   s[r, c] = -1e30     where c > r (causal) or c >= S (key padding)
//   out[r]  = softmax(s[r]) @ v                          f32 softmax, P in bf16,
//                                                        f32 accumulation
//   lse[r]  = log sum_c exp(s[r, c])                     read by the backward (K2)
//
// Layout: q, k, v, out are (B, S, H, Dh) bf16, read and written through their
// batch/sequence/head strides with no transposed or padded copies; gate2 is
// (H,) f32, video_start (B,) int32, lse (B, H, S) f32.
//
// What bounds it on an H100: at the eval shapes (S = 128, Dh = 128) one
// (b, h) pair does ~4 MFLOP of causal work on 128 KB of q/k/v/out, about 32
// FLOP per byte, far below the ~295 FLOP/byte at which bf16 tensor cores and
// not HBM become the limit; and the whole call is tens of microseconds, so
// launch latency and the tail of 512 small blocks weigh as much as the bytes.
// What the design does about it: every q/k/v byte is read from HBM once per
// q tile and out is written once, the S×S scores never leave registers, and
// causally dead K/V tiles are never loaded. Unlike the TPU kernel, which kept
// all of K/V in VMEM (hence its S <= 4096 bound), K/V stream through shared
// memory in 64-key tiles with an online (FA2-style) softmax, so there is no
// sequence bound; the ragged S edge is masked in the kernel.
//
// Blocking: the tile loop of flash_fwd.cuh, shared with K5
// (flash_stream_fwd.cu), at q_offset 0 and S_k = S: one block of 4 warps per
// (b, h, 64-row q tile), mma.sync m16n8k16 bf16 -> f32, the score registers
// reused as the A operand of the PV product.
// Not yet done (later work): cp.async/TMA double buffering of K/V, wgmma.

#include <cuda_runtime.h>

#include "flash_fwd.cuh"

namespace {

template <int DH>
__global__ void __launch_bounds__(flash::FWD_THREADS)
flash_text_fwd_kernel(const flash::FwdArgs a) {
  flash::fwd_tile<DH>(a);
}

}  // namespace

extern "C" int flash_text_fwd(const void* q, const void* k, const void* v,
                              const void* gate2, const void* video_start,
                              void* out, void* lse, int B, int S, int H,
                              int Dh, int max_feats, long long sb,
                              long long ss, long long sh, long long osb,
                              long long oss, long long osh, float scale,
                              void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const flash::FwdArgs a{
      static_cast<const flash::bf16*>(q), static_cast<const flash::bf16*>(k),
      static_cast<const flash::bf16*>(v), static_cast<const float*>(gate2),
      static_cast<const int*>(video_start), static_cast<flash::bf16*>(out),
      static_cast<float*>(lse), S, S, 0, H, max_feats, sb, ss, sh, sb, ss,
      sh, osb, oss, osh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {  // every LLaMA preset of the repo has Dh = 128
    case 128:
      return static_cast<int>(
          flash::launch_fwd(flash_text_fwd_kernel<128>, a, B, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
