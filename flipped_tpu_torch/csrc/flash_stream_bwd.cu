// K6a and K6b for Hopper: the streaming backward of the causal text
// attention with the gate2 video-block bias, for a q shard at a global
// offset, in two passes with no atomics.
//
// Replaces the TPU kernels of flash_streaming_bwd
// (flipped_tpu/model/pallas/flash_attention.py:484-578, 665-719):
//   K6a _stream_dq_kernel  -> flash_stream_dq:  dq (S_q rows) and dgate2,
//                                               keys innermost;
//   K6b _stream_dkv_kernel -> flash_stream_dkv: dk, dv (S_k rows), q rows
//                                               innermost.
// What they compute is stated in flash_bwd.cuh: q, dout (B, S_q, H, Dh) at
// global rows q_offset + i, k, v (B, S_k, H, Dh), the forward's lse and the
// row statistic D = rowsum(dO * O_text) (B, H, S_q) f32 both computed
// outside these kernels (the lse by K5, D by the wrapper in plain torch, as
// the JAX package computes it in XLA, :608-613). dk and dv are partial sums
// over this shard's rows only (the mask keeps i < S_q, the TPU kernel's
// row < q_offset + S_q): a sequence-parallel caller sums them over the
// shards, and sums dgate2 too. Key tiles above every row of the shard write
// zero dk/dv.
//
// What bounds them on an H100: at the long-context training shape (B 3,
// S 4096, H 32, Dh 128) K6a does three products over the 8.4 M causal
// pairs of each (b, h) (QK^T, dO V^T, dS K: 6.2e11 FLOP, 0.63 ms at the
// dense bf16 peak) and K6b four (QK^T, dO V^T, P^T dO, dS^T Q: 8.2e11 FLOP,
// 0.83 ms), against 0.50 GB (K6a: q, k, v, dO read, dq written) and 0.60 GB
// (K6b: dk, dv written) of bytes, 0.15 and 0.18 ms at 3.35 TB/s: both are
// bound by operations.
// What the design does about it: every S x S tile (P, dP, dS) stays in
// registers, the products run on the tensor cores (mma.sync m16n8k16), and
// causally dead tiles are skipped per block and per warp. The TPU grid
// carried dq, dk/dv and dgate2 in VMEM scratch across sequential grid steps;
// blocks on the card run in no order, so each sum is a loop inside one
// block (the dq and dkdv tile loops of flash_bwd.cuh, shared with K2), and
// dgate2 becomes one partial per (b, h, 64-row q tile), summed by the
// caller. Splitting the passes (recomputing P in each) keeps every output
// with one writer instead of the atomics a fused pass would need.
// Not yet done (later work): cp.async/TMA double buffering, ldmatrix,
// wgmma.

#include <cuda_runtime.h>

#include "flash_bwd.cuh"

namespace {

using flash::bf16;

template <int DH>
__global__ void __launch_bounds__(flash::BWD_THREADS)
flash_stream_dq_kernel(const flash::BwdArgs a) {
  flash::dq_tile<DH>(a);
}

template <int DH>
__global__ void __launch_bounds__(flash::BWD_THREADS)
flash_stream_dkv_kernel(const flash::BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  flash::dkdv_tile<DH>(a, smem_raw);
}

bool bad_shape(int B, int S_q, int S_k, int H, int q_offset) {
  return B <= 0 || S_q <= 0 || S_k <= 0 || H <= 0 || q_offset < 0 ||
         B > 65535 || H > 65535;
}

flash::BwdArgs make_args(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, const void* gate2,
                         const void* video_start, void* dq, void* dk,
                         void* dv, void* dg2_part, int S_q, int S_k, int H,
                         int q_offset, int max_feats, float scale) {
  return flash::BwdArgs{
      static_cast<const bf16*>(q),     static_cast<const bf16*>(k),
      static_cast<const bf16*>(v),     static_cast<const bf16*>(dout),
      static_cast<const float*>(lse),  static_cast<const float*>(delta),
      static_cast<const float*>(gate2),
      static_cast<const int*>(video_start),
      static_cast<bf16*>(dq),          static_cast<bf16*>(dk),
      static_cast<bf16*>(dv),          static_cast<float*>(dg2_part),
      S_q, S_k, q_offset, H, max_feats, scale};
}

}  // namespace

// K6a: dq (B, S_q, H, Dh) and dg2_part (B, H, ceil(S_q / 64)).
extern "C" int flash_stream_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* gate2,
                               const void* video_start, void* dq,
                               void* dg2_part, int B, int S_q, int S_k, int H,
                               int Dh, int q_offset, int max_feats,
                               float scale, void* stream) {
  if (bad_shape(B, S_q, S_k, H, q_offset)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const flash::BwdArgs a =
      make_args(q, k, v, dout, lse, delta, gate2, video_start, dq, nullptr,
                nullptr, dg2_part, S_q, S_k, H, q_offset, max_feats, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {  // every LLaMA preset of the repo has Dh = 128
    case 128:
      return static_cast<int>(
          flash::launch_dq(flash_stream_dq_kernel<128>, a, B, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K6b: dk, dv (B, S_k, H, Dh), partial over this shard's rows.
extern "C" int flash_stream_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* gate2,
                                const void* video_start, void* dk, void* dv,
                                int B, int S_q, int S_k, int H, int Dh,
                                int q_offset, int max_feats, float scale,
                                void* stream) {
  if (bad_shape(B, S_q, S_k, H, q_offset)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const flash::BwdArgs a =
      make_args(q, k, v, dout, lse, delta, gate2, video_start, nullptr, dk,
                dv, nullptr, S_q, S_k, H, q_offset, max_feats, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 128:
      return static_cast<int>(
          flash::launch_dkdv<128>(flash_stream_dkv_kernel<128>, a, B, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
