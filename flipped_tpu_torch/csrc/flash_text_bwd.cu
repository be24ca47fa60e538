// K2 for Hopper: backward of the causal text attention with the gate2
// video-block bias.
//
// Replaces the TPU kernel flash_text_attention_bwd -> _flash_bwd_kernel
// (flipped_tpu/model/pallas/flash_attention.py:174-300). Per (batch b, head
// h), with the scores s[r, c] of K1 (flash_text_fwd.cu) and K1's saved row
// log-sum-exp lse and output O:
//   P[r, c]   = exp(s[r, c] - lse[r])          0 where c > r or r, c >= S
//   D[r]      = sum_d dO[r, d] * O[r, d]       f32
//   dV[c]     = sum_r bf16(P[r, c]) dO[r]      f32 accumulation
//   dP[r, c]  = dO[r] . V[c]                   f32 from bf16 operands
//   dS[r, c]  = P[r, c] (dP[r, c] - D[r])      f32
//   dQ[r]     = scale sum_c bf16(dS[r, c]) K[c]
//   dK[c]     = scale sum_r bf16(dS[r, c]) Q[r]
//   dgate2[h] = sum over b and the video block of dS (f32)
// P and dS are rounded to bf16 before their products, as the TPU kernel
// rounds them (:210, :219).
//
// Layout: q, k, v, out, dout, dq, dk, dv are contiguous (B, S, H, Dh) bf16;
// lse and delta (B, H, S) f32 (delta: D, written by the first pass); gate2
// (H,) f32; video_start (B,) int32;
// dg2_part (B, H, ceil(S / 64)) f32, one partial per 64 q rows, summed by
// the caller.
//
// What bounds it on an H100: at the training shape (B 24, S 128, H 32,
// Dh 128) the call reads q/k/v/out/dout (126 MB) and writes dq/dk/dv
// (75 MB): ~60 us at 3.35 TB/s, against ~16 GFLOP of causal products,
// ~16 us at the dense bf16 peak. So it is bound by bytes; the two passes
// below read q, dout, k and v twice and out once (about 302 MB, ~90 us at
// 3.35 TB/s), and every S x S tile (P, dP, dS) stays in registers.
// What the design does about the TPU kernel's shape: that kernel held all
// of S x S for one (b, h) in VMEM, which 227 KB of shared memory cannot
// hold at S 650 (TVQA) and beyond. Here the work is tiled in two passes,
// K6a's and K6b's loops (flash_bwd_wgmma.cuh) at q_offset 0 and S_q =
// S_k = S, so any S is taken; the wrapper
// (model/kernels/flash_attention.py) routes S <= MAX_SEQ_BWD = 2048 here
// and longer sequences to K6, as the JAX package does:
//   1. dq:    K6a's loop (dq_body<true>): a persistent grid of 128-row q
//             items, Q, dO and O by TMA once an item, 128-key K/V tiles
//             through a TMA ring, S, dP SS wgmmas, dq += dS K an RS wgmma;
//             one dgate2 partial per consumer warpgroup (64 q rows). D =
//             rowsum(dO * O) is summed from shared memory once an item (the
//             TPU kernel computes D inside too, :213-215; K6's D comes from
//             the caller), and written to `delta` for the second pass.
//   2. dkdv:  K6b's loop: 128-key items with K and V resident, 64-row q
//             steps of Q, dO, lse and D through a ring, S^T, dP^T SS
//             wgmmas, dV += P^T dO and dK += dS^T Q RS wgmmas; with two
//             K/V buffers and two q stages (dkv_body<2, 2>; K6 has one and
//             four), so that the next item's K and V load while this one's
//             few steps run.
// The two loops take their items from counters of their own
// (`text_dq_sched`, `text_dkv_sched` below, not K6's), in groups of a few
// heads.
// No atomics on the outputs: every output element and every dgate2 partial
// has one writer, so the result is the same from run to run. Rows past S
// come in as zeros by TMA and keys past S are masked out of P.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd_wgmma.cuh"

namespace {

// each loop's shared item counter and count of blocks done (zero between
// launches: the last block of a launch resets them)
__device__ unsigned int text_dq_sched[2];
__device__ unsigned int text_dkv_sched[2];

__global__ void __launch_bounds__(flashbw::THREADS, 1)
flash_text_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap o_map,
                     const flashbw::Args a) {
  flashbw::dq_body<true>(&q_map, &do_map, &k_map, &v_map, &o_map, a);
}

__global__ void __launch_bounds__(flashbw::THREADS, 1)
flash_text_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const flashbw::Args a) {
  flashbw::dkv_body<2, 2>(&q_map, &do_map, &k_map, &v_map, a);
}

}  // namespace

// delta (B, H, S) f32 is scratch: the dq pass writes D there for the dk/dv
// pass.
extern "C" int flash_text_bwd(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              const void* lse, const void* gate2,
                              const void* video_start, void* dq, void* dk,
                              void* dv, void* delta, void* dg2_part, int B,
                              int S, int H, int Dh, int max_feats, float scale,
                              void* stream) {
  // every LLaMA preset of the repo has Dh = 128
  if (B <= 0 || S <= 0 || H <= 0 || Dh != flashbw::DH) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap maps[4], o_map;
  void* sched = nullptr;
  cudaError_t err = flashbw::make_maps(maps, q, dout, k, v, B, S, S, H,
                                       flashbw::DQ_BQ, flashbw::DQ_BKV);
  if (err == cudaSuccess) {
    err = hopper::make_map_4d_bf16(
        &o_map, out, flashbw::DH, H, S, B, flashbw::DH,
        static_cast<uint64_t>(H) * flashbw::DH,
        static_cast<uint64_t>(S) * H * flashbw::DH, flashbw::BOX,
        flashbw::DQ_BQ);
  }
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&sched, text_dq_sched);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool dq_attr = false;
  err = flashbw::launch(
      flash_text_dq_kernel,
      flashbw::make_args(lse, delta, gate2, video_start, dq, dg2_part,
                         nullptr, nullptr, sched, B, S, S, H, 0, max_feats,
                         scale),
      static_cast<long long>((S + flashbw::DQ_BQ - 1) / flashbw::DQ_BQ) * H *
          B,
      flashbw::DQ_SMEM_OWN_D, dq_attr, st, maps[0], maps[1], maps[2],
      maps[3], o_map);

  if (err == cudaSuccess) {
    err = flashbw::make_maps(maps, q, dout, k, v, B, S, S, H, flashbw::DKV_BQ,
                             flashbw::DKV_BK);
  }
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&sched, text_dkv_sched);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool dkv_attr = false;
  return static_cast<int>(flashbw::launch(
      flash_text_dkv_kernel,
      flashbw::make_args(lse, delta, gate2, video_start, nullptr, nullptr, dk,
                         dv, sched, B, S, S, H, 0, max_feats, scale),
      static_cast<long long>((S + flashbw::DKV_BK - 1) / flashbw::DKV_BK) *
          H * B,
      flashbw::Dkv<2, 2>::SMEM, dkv_attr, st, maps[0], maps[1], maps[2],
      maps[3]));
}
