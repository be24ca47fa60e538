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
// batch/sequence/head strides with no transposed or padded copies (q, k and
// v share theirs, multiples of 8 elements); gate2 is (H,) f32, video_start
// (B,) int32, lse (B, H, S) f32.
//
// What bounds it on an H100: at the eval and training shapes (S = 128,
// Dh = 128) one (b, h) pair does ~4 MFLOP of causal work on 128 KB of
// q/k/v/out, about 32 FLOP per byte, far below the ~295 FLOP/byte at which
// bf16 tensor cores and not HBM become the limit: it is bound by bytes, and
// the whole call is tens of microseconds. At the forward-only lengths up to
// S 4096 the products grow with S^2 and bound it instead.
// What the design does about it (flash_fwd_wgmma.cuh, K5's loop too): every
// q/k/v byte is read from HBM once per 128-row q tile, by TMA, and out is
// written once; a persistent grid whose producer loads the next (b, h)
// while the consumer warpgroups finish this one keeps loads in flight at
// S 128, where one q tile is the whole (b, h); both products are wgmma
// (Q K^T from shared memory, P V with P from registers); the S x S scores
// never leave registers, and causally dead K/V tiles are never loaded.
// Unlike the TPU kernel, which kept all of K/V in VMEM (hence its S <= 4096
// bound), K/V stream through shared memory with an online softmax, so
// there is no sequence bound; the ragged S edge is masked in the kernel.

#include <cuda_runtime.h>

#include "flash_fwd_wgmma.cuh"

namespace {

// the item counter and count of blocks done (zero between launches: the
// last block of a launch resets them)
__device__ unsigned int fwd_sched[2];

template <bool MULTI>
__global__ void __launch_bounds__(flashw::threads(MULTI), 1)
flash_text_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const flashw::Args a) {
  flashw::fwd_body<MULTI>(&q_map, &k_map, &v_map, a);
}

}  // namespace

extern "C" int flash_text_fwd(const void* q, const void* k, const void* v,
                              const void* gate2, const void* video_start,
                              void* out, void* lse, int B, int S, int H,
                              int Dh, int max_feats, long long sb,
                              long long ss, long long sh, long long osb,
                              long long oss, long long osh, float scale,
                              void* stream) {
  // every LLaMA preset of the repo has Dh = 128; TMA takes 16-byte strides
  if (B <= 0 || S <= 0 || H <= 0 || Dh != flashw::DH || sb % 8 != 0 ||
      ss % 8 != 0 || sh % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = hopper::make_map_4d_bf16(
        &maps[i], bases[i], Dh, H, S, B, sh, ss, sb, flashw::BOX,
        flashw::BQ);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  void* sched = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&sched, fwd_sched);
  if (err != cudaSuccess) return static_cast<int>(err);
  const flashw::Args a{static_cast<const float*>(gate2),
                       static_cast<const int*>(video_start),
                       static_cast<flashw::bf16*>(out),
                       static_cast<float*>(lse),
                       static_cast<unsigned int*>(sched),
                       B, S, S, 0, H, max_feats, osb, oss, osh, scale};
  static bool attr_set[2] = {false, false};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t launched =
      flashw::multi_tile(a)
          ? flashw::launch<true>(flash_text_fwd_kernel<true>, maps, a,
                                 attr_set[1], st)
          : flashw::launch<false>(flash_text_fwd_kernel<false>, maps, a,
                                  attr_set[0], st);
  return static_cast<int>(launched);
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
