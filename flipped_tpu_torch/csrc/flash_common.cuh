// Device helpers shared by the flash-attention tile loops
// (flash_fwd_wgmma.cuh for K1 and K5, flash_bwd_wgmma.cuh for K2, K6a and
// K6b) and the bf16 epilogues of the quant kernels: bf16 packing and the
// gate2 video-block test.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// gate2 applies on text rows >= vs + F and video columns [vs, vs + F);
// vs < 0 (QAV rows) turns it off.
__device__ __forceinline__ bool in_video_block(int row, int col, int vs,
                                               int max_feats) {
  return vs >= 0 && row >= vs + max_feats && col >= vs &&
         col < vs + max_feats;
}

}  // namespace flash
