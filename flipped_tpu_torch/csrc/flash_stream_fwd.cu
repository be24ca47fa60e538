// K5 for Hopper: the streaming forward of the causal text attention with the
// gate2 video-block bias, for a q shard at a global offset.
//
// Replaces the TPU kernel flash_streaming_fwd -> _stream_fwd_kernel
// (flipped_tpu/model/pallas/flash_attention.py:314-441). What it computes:
// the forward of K1 (flash_fwd.cuh states it in full) for q (B, S_q, H, Dh)
// whose row i sits at global position q_offset + i, against K/V (B, S_k, H,
// Dh) with S_k >= 1 and no relation to S_q: the causal mask, the causal skip
// and the gate2 video block take the global row, keys >= S_k are masked.
// Returns out (B, S_q, H, Dh) bf16 and lse (B, H, S_q) f32, which the
// streaming backward (K6a, K6b, flash_stream_bwd.cu) reads. The JAX package
// takes this kernel for S > 4096 (one card, long context) and for every
// sequence-parallel shard (q_offset = shard * S / sp against all-gathered
// K/V).
//
// Layout: q, k, v, out are read and written through their batch / sequence /
// head strides (k and v share theirs), with a unit Dh stride; gate2 (H,) f32,
// video_start (B,) int32.
//
// What bounds it on an H100: at the long-context training shape (B 3,
// S 4096, H 32, Dh 128) the call does two products over 8.4 M causal pairs
// per (b, h), 4.1e11 FLOP, 0.42 ms at the dense bf16 peak, against 0.4 GB
// of q/k/v/out (0.12 ms at 3.35 TB/s): it is bound by operations, about
// 1,000 FLOP per byte.
// What the design does about it: the S x S scores never leave registers,
// causally dead K/V tiles are never loaded, and every block does the QK^T
// and PV products of its 64 rows on the tensor cores (mma.sync m16n8k16).
// The TPU kernel's reason to exist, VMEM too small for all of K/V beyond
// S = 4096, does not carry over: a tile loop that streams K/V through
// shared memory has no sequence bound, so K5 is flash_fwd.cuh's loop (K1's
// until K1 moved to flash_fwd_wgmma.cuh) with the q offset and S_k as
// parameters. The TPU grid's
// k axis, which carried the running max, sum and accumulator in VMEM scratch
// across grid steps, is the loop inside the block; the lse is (B, H, S_q)
// f32, not the TPU kernel's 8-lane Mosaic layout.
// Not yet done (later work): cp.async/TMA double buffering of K/V, wgmma.

#include <cuda_runtime.h>

#include "flash_fwd.cuh"

namespace {

template <int DH>
__global__ void __launch_bounds__(flash::FWD_THREADS)
flash_stream_fwd_kernel(const flash::FwdArgs a) {
  flash::fwd_tile<DH>(a);
}

}  // namespace

extern "C" int flash_stream_fwd(const void* q, const void* k, const void* v,
                                const void* gate2, const void* video_start,
                                void* out, void* lse, int B, int S_q,
                                int S_k, int H, int Dh, int q_offset,
                                int max_feats, long long qsb, long long qss,
                                long long qsh, long long ksb, long long kss,
                                long long ksh, long long osb, long long oss,
                                long long osh, float scale, void* stream) {
  if (B <= 0 || S_q <= 0 || S_k <= 0 || H <= 0 || q_offset < 0 ||
      B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const flash::FwdArgs a{
      static_cast<const flash::bf16*>(q), static_cast<const flash::bf16*>(k),
      static_cast<const flash::bf16*>(v), static_cast<const float*>(gate2),
      static_cast<const int*>(video_start), static_cast<flash::bf16*>(out),
      static_cast<float*>(lse), S_q, S_k, q_offset, H, max_feats, qsb, qss,
      qsh, ksb, kss, ksh, osb, oss, osh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {  // every LLaMA preset of the repo has Dh = 128
    case 128:
      return static_cast<int>(
          flash::launch_fwd(flash_stream_fwd_kernel<128>, a, B, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
