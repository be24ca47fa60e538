// Device helpers shared by the flash-attention kernels (the tile loops of
// flash_fwd.cuh and flash_bwd.cuh, which K1, K2, K5, K6a and K6b run): bf16
// packing, the mma.sync m16n8k16 product, and the gate2 video-block test.
//
// mma.sync m16n8k16 fragment layouts (bf16 in, f32 accumulate), with lane =
// 4 * g + t (g = lane >> 2 in 0..7, t = lane & 3):
//   A (16 x 16, row):  a0 = A[g][2t, 2t+1]     a1 = A[g+8][2t, 2t+1]
//                      a2 = A[g][2t+8, 2t+9]   a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, col):   b0 = B[2t, 2t+1][g]     b1 = B[2t+8, 2t+9][g]
//   C (16 x 8):        c0, c1 = C[g][2t, 2t+1] c2, c3 = C[g+8][2t, 2t+1]
// The C tiles of two adjacent n-tiles, packed to bf16, are the A fragment of
// a 16 x 16 tile: that is how a score tile becomes the left operand of the
// next product without leaving registers.
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

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulation.
__device__ __forceinline__ void mma_16816(float d[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// gate2 applies on text rows >= vs + F and video columns [vs, vs + F);
// vs < 0 (QAV rows) turns it off.
__device__ __forceinline__ bool in_video_block(int row, int col, int vs,
                                               int max_feats) {
  return vs >= 0 && row >= vs + max_feats && col >= vs &&
         col < vs + max_feats;
}

}  // namespace flash
