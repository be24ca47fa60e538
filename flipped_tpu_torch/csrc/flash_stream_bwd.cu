// K6a and K6b for Hopper: the streaming backward of the causal text
// attention with the gate2 video-block bias, for a q shard at a global
// offset, in two passes with no atomics on the outputs.
//
// Replaces the TPU kernels of flash_streaming_bwd
// (flipped_tpu/model/pallas/flash_attention.py:484-578, 665-719):
//   K6a _stream_dq_kernel  -> flash_stream_dq:  dq (S_q rows) and dgate2,
//                                               keys innermost;
//   K6b _stream_dkv_kernel -> flash_stream_dkv: dk, dv (S_k rows), q rows
//                                               innermost.
// What they compute is stated in flash_bwd_wgmma.cuh: q, dout (B, S_q, H,
// Dh) at global rows q_offset + i, k, v (B, S_k, H, Dh), all contiguous,
// the forward's lse and the row statistic D = rowsum(dO * O_text) (B, H,
// S_q) f32 both computed outside these kernels (the lse by K5, D by the
// wrapper in plain torch, as the JAX package computes it in XLA,
// :608-613). dk and dv are partial sums over this shard's rows only (the
// TPU kernel's row < q_offset + S_q): a sequence-parallel caller sums them
// over the shards, and sums dgate2 too. Key tiles above every row of the
// shard write zero dk/dv.
//
// What bounds them on an H100: at the long-context training shape (B 3,
// S 4096, H 32, Dh 128) K6a does three products over the 8.4 M causal
// pairs of each (b, h) (QK^T, dO V^T, dS K: 6.2e11 FLOP, 0.63 ms at the
// dense bf16 peak) and K6b four (QK^T, dO V^T, P^T dO, dS^T Q: 8.2e11 FLOP,
// 0.83 ms), against 0.50 GB (K6a: q, k, v, dO read, dq written) and 0.60 GB
// (K6b: dk, dv written) of bytes, 0.15 and 0.18 ms at 3.35 TB/s: both are
// bound by operations.
// What the design does about it (flash_bwd_wgmma.cuh): every product is a
// wgmma on operands that TMA wrote into shared memory through an mbarrier
// ring, a producer warp keeping the loads in flight while two consumer
// warpgroups compute; every S x S tile (P, dP, dS) stays in registers and
// feeds the next product from there; the tiles are 128 rows (K6a) or 128
// keys (K6b) an item, so each K/V (K6a) or Q/dO (K6b) byte is read once per
// item; causally dead tiles are never loaded; a persistent grid takes items
// from a shared counter, the longest first, in groups of a few heads that
// L2 holds. The TPU grid carried dq, dk/dv and dgate2 in
// VMEM scratch across sequential grid steps; blocks on the card run in no
// order, so each sum is a loop inside one block, and dgate2 becomes one
// partial per (b, h, 64-row q tile), summed by the caller. Splitting the
// passes (recomputing P in each) keeps every output with one writer instead
// of the atomics a fused pass would need.

#include <cuda_runtime.h>

#include "flash_bwd_wgmma.cuh"

namespace {

__global__ void __launch_bounds__(flashbw::THREADS, 1)
flash_stream_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const flashbw::Args a) {
  flashbw::dq_body<false>(&q_map, &do_map, &k_map, &v_map, nullptr, a);
}

__global__ void __launch_bounds__(flashbw::THREADS, 1)
flash_stream_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const flashbw::Args a) {
  flashbw::dkv_body<1, 4>(&q_map, &do_map, &k_map, &v_map, a);
}

// every LLaMA preset of the repo has Dh = 128
bool bad_shape(int B, int S_q, int S_k, int H, int Dh, int q_offset) {
  return B <= 0 || S_q <= 0 || S_k <= 0 || H <= 0 || q_offset < 0 ||
         Dh != flashbw::DH;
}

}  // namespace

// K6a: dq (B, S_q, H, Dh) and dg2_part (B, H, ceil(S_q / 64)). `sched` is
// the item counter (two uint32, zero between launches: the last block
// resets them) of the caller's stream: launches on one stream run in
// order, launches on two take two counters.
extern "C" int flash_stream_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* gate2,
                               const void* video_start, void* dq,
                               void* dg2_part, int B, int S_q, int S_k, int H,
                               int Dh, int q_offset, int max_feats,
                               float scale, void* sched, void* stream) {
  if (bad_shape(B, S_q, S_k, H, Dh, q_offset)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[4];
  cudaError_t err = flashbw::make_maps(maps, q, dout, k, v, B, S_q, S_k, H,
                                       flashbw::DQ_BQ, flashbw::DQ_BKV);
  if (err != cudaSuccess) return static_cast<int>(err);
  const flashbw::Args a =
      flashbw::make_args(lse, delta, gate2, video_start, dq, dg2_part,
                         nullptr, nullptr, sched, B, S_q, S_k, H, q_offset,
                         max_feats, scale);
  const long long items =
      static_cast<long long>((S_q + flashbw::DQ_BQ - 1) / flashbw::DQ_BQ) *
      H * B;
  return static_cast<int>(flashbw::launch(
      flash_stream_dq_kernel, a, items, flashbw::DQ_SMEM,
      static_cast<cudaStream_t>(stream), maps[0], maps[1], maps[2],
      maps[3]));
}

// K6b: dk, dv (B, S_k, H, Dh), partial over this shard's rows.
extern "C" int flash_stream_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* gate2,
                                const void* video_start, void* dk, void* dv,
                                int B, int S_q, int S_k, int H, int Dh,
                                int q_offset, int max_feats, float scale,
                                void* sched, void* stream) {
  if (bad_shape(B, S_q, S_k, H, Dh, q_offset)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[4];
  cudaError_t err = flashbw::make_maps(maps, q, dout, k, v, B, S_q, S_k, H,
                                       flashbw::DKV_BQ, flashbw::DKV_BK);
  if (err != cudaSuccess) return static_cast<int>(err);
  const flashbw::Args a =
      flashbw::make_args(lse, delta, gate2, video_start, nullptr, nullptr,
                         dk, dv, sched, B, S_q, S_k, H, q_offset, max_feats,
                         scale);
  const long long items =
      static_cast<long long>((S_k + flashbw::DKV_BK - 1) / flashbw::DKV_BK) *
      H * B;
  return static_cast<int>(flashbw::launch(
      flash_stream_dkv_kernel, a, items, flashbw::Dkv<1, 4>::SMEM,
      static_cast<cudaStream_t>(stream), maps[0], maps[1], maps[2],
      maps[3]));
}
