// K5 for Hopper: the streaming forward of the causal text attention with the
// gate2 video-block bias, for a q shard at a global offset.
//
// Replaces the TPU kernel flash_streaming_fwd -> _stream_fwd_kernel
// (flipped_tpu/model/pallas/flash_attention.py:314-441). What it computes:
// the forward of K1 (flash_fwd_wgmma.cuh states it in full) for q (B, S_q,
// H, Dh) whose row i sits at global position q_offset + i, against K/V (B,
// S_k, H, Dh) with S_k >= 1 and no relation to S_q: the causal mask, the
// causal skip and the gate2 video block take the global row, keys >= S_k
// are masked. Returns out (B, S_q, H, Dh) bf16 and lse (B, H, S_q) f32,
// which the streaming backward (K6a, K6b, flash_stream_bwd.cu) reads. The
// JAX package takes this kernel for S > 4096 (one card, long context) and
// for every sequence-parallel shard (q_offset = shard * S / sp against
// all-gathered K/V).
//
// Layout: q, k, v, out are read and written through their batch / sequence /
// head strides (k and v share theirs, q has its own; multiples of 8
// elements, as TMA takes them), with a unit Dh stride; gate2 (H,) f32,
// video_start (B,) int32.
//
// What bounds it on an H100: at the long-context training shape (B 3,
// S 4096, H 32, Dh 128) the call does two products over 8.4 M causal pairs
// per (b, h), 4.1e11 FLOP, 0.42 ms at the dense bf16 peak, against 0.4 GB
// of q/k/v/out (0.12 ms at 3.35 TB/s): it is bound by operations, about
// 1,000 FLOP per byte.
// What the design does about it: K5 is K1's loop (flash_fwd_wgmma.cuh) with
// the q offset and S_k as parameters. Both products are wgmma on tiles that
// TMA wrote into shared memory, and a warpgroup takes the softmax of one
// key tile while the tensor cores run the P V product of the tile before;
// the S x S scores never leave registers, and causally dead K/V tiles are
// never loaded. The items (b, h, 128-row q tile) come from a counter the
// grid shares, in groups of a few heads, the longest first: the blocks in
// flight read the K/V of a few heads, which L2 holds, instead of one head
// each. The TPU kernel's reason to exist, VMEM too small for all of K/V
// beyond S = 4096, does not carry over: a tile loop that streams K/V
// through shared memory has no sequence bound. The TPU grid's k axis,
// which carried the running max, sum and accumulator in VMEM scratch
// across grid steps, is the loop inside the block; the lse is (B, H, S_q)
// f32, not the TPU kernel's 8-lane Mosaic layout.

#include <cuda_runtime.h>

#include "flash_fwd_wgmma.cuh"

namespace {

// the item counter and count of blocks done (zero between launches: the
// last block of a launch resets them)
__device__ unsigned int stream_fwd_sched[2];

template <bool MULTI>
__global__ void __launch_bounds__(flashw::threads(MULTI), 1)
flash_stream_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const flashw::Args a) {
  flashw::fwd_body<MULTI>(&q_map, &k_map, &v_map, a);
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
  // every LLaMA preset of the repo has Dh = 128; TMA takes 16-byte strides
  if (B <= 0 || S_q <= 0 || S_k <= 0 || H <= 0 || q_offset < 0 ||
      Dh != flashw::DH || qsb % 8 != 0 || qss % 8 != 0 || qsh % 8 != 0 ||
      ksb % 8 != 0 || kss % 8 != 0 || ksh % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[3];
  cudaError_t err = hopper::make_map_4d_bf16(
      &maps[0], q, Dh, H, S_q, B, qsh, qss, qsb, flashw::BOX, flashw::BQ);
  for (int i = 1; i < 3 && err == cudaSuccess; ++i) {
    err = hopper::make_map_4d_bf16(&maps[i], i == 1 ? k : v, Dh, H, S_k, B,
                                   ksh, kss, ksb, flashw::BOX, flashw::BKV);
  }
  void* sched = nullptr;
  if (err == cudaSuccess) {
    err = cudaGetSymbolAddress(&sched, stream_fwd_sched);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const flashw::Args a{static_cast<const float*>(gate2),
                       static_cast<const int*>(video_start),
                       static_cast<flashw::bf16*>(out),
                       static_cast<float*>(lse),
                       static_cast<unsigned int*>(sched),
                       B, S_q, S_k, q_offset, H, max_feats, osb, oss, osh,
                       scale};
  static bool attr_set[2] = {false, false};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t launched =
      flashw::multi_tile(a)
          ? flashw::launch<true>(flash_stream_fwd_kernel<true>, maps, a,
                                 attr_set[1], st)
          : flashw::launch<false>(flash_stream_fwd_kernel<false>, maps, a,
                                  attr_set[0], st);
  return static_cast<int>(launched);
}
