// Device code shared by K7 (int8_grouped_fwd.cu) and K8's w4a8 branch
// (int4_fwd.cu): the grouped activation quantize pass and the signed-nibble
// unpacking; the scale constants K3 (int8_fwd.cu) and K10 (int8_dgrad.cu)
// share.
//
// Rounding: every float step is an explicit __fmul_rn / __fadd_rn /
// __fdiv_rn, so nvcc cannot contract a multiply and an add into an FMA, and
// the kernels compute bit for bit what their plain PyTorch versions compute
// (model/kernels/quant_matmul.py): the int8 dots are exact int32 sums, the
// int32 -> f32 conversion rounds to nearest even as PyTorch's does, and the
// bf16 output rounds to nearest even.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace quant {

typedef __nv_bfloat16 bf16;

constexpr float EPS = 1e-8f;              // scale floor: zero rows give 0
constexpr float INV127 = 0x1.020408p-7f;  // float32(1/127)

// ---------------------------------------------------------------------------
// Quantize pass: one warp per (row, group) of x (M, K) bf16, group | K. The
// scale is amax / 127 (the grouped formulation of K7 and K8), floored at
// EPS; each code is rint(x / scale), half to even. Writes xq (M, K) int8
// and xs transposed, (K / group, pitch) f32 with pitch >= M a multiple of
// 4: the GEMMs load one group's row scales of a tile as one contiguous TMA
// box (the rows' stride would otherwise put each in a sector of its own).
// ---------------------------------------------------------------------------
constexpr int QWARPS = 4;  // (row, group) items per block

// (static: every source that includes this header keeps its own copy)
static __global__ void __launch_bounds__(QWARPS * 32)
quantize_rows_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, long long items, int group,
                     int groups, int pitch) {
  const long long item =
      static_cast<long long>(blockIdx.x) * QWARPS + threadIdx.x / 32;
  if (item >= items) return;  // the whole warp leaves together
  const int lane = threadIdx.x % 32;
  // item = row * groups + gi, groups fastest: a block reads 4 adjacent
  // pieces of x (row * K + gi * group == item * group). Rows fastest
  // would write adjacent row scales but read x in scattered pieces, and
  // read slower on the card.
  const bf16* xr = x + item * group;
  int8_t* qr = xq + item * group;
  const int nvec = group / 8;  // 16-byte vectors of 8 bf16

  float amax = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + v * 8);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  const float s = fmaxf(__fdiv_rn(amax, 127.f), EPS);
  if (lane == 0) xs[(item % groups) * pitch + item / groups] = s;

  for (int v = lane; v < nvec; v += 32) {
    const uint4 u = *reinterpret_cast<const uint4*>(xr + v * 8);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      const int q0 = __float2int_rn(__fdiv_rn(f.x, s));
      const int q1 = __float2int_rn(__fdiv_rn(f.y, s));
      const uint32_t pair = (static_cast<uint32_t>(q0) & 0xffu) |
                            ((static_cast<uint32_t>(q1) & 0xffu) << 8);
      w[j >> 1] |= pair << (16 * (j & 1));
    }
    *reinterpret_cast<uint2*>(qr + v * 8) = make_uint2(w[0], w[1]);
  }
}

// the pitch of the transposed row scales: M rounded up to 4 floats, TMA's
// 16-byte row stride
inline int xs_pitch(int M) { return (M + 3) / 4 * 4; }

inline cudaError_t launch_quantize(const void* x, void* xq, void* xs, int M,
                                   int K, int group, cudaStream_t stream) {
  const long long items = static_cast<long long>(M) * (K / group);
  const long long blocks = (items + QWARPS - 1) / QWARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  quantize_rows_kernel<<<static_cast<unsigned>(blocks), QWARPS * 32, 0,
                         stream>>>(static_cast<const bf16*>(x),
                                   static_cast<int8_t*>(xq),
                                   static_cast<float*>(xs), items, group,
                                   K / group, xs_pitch(M));
  return cudaGetLastError();
}

// The signed low / high nibbles of 4 packed bytes as 4 int8 bytes (K8's
// w4a8 branch): per byte, the nibble v in 0..15 of the code c (v = c mod
// 16) ^ 8 is c + 8 in 0..15; adding 120 gives c + 128 with no carry into
// the next byte, and ^ 0x80 subtracts 128 modulo 256, leaving the byte c
// (a LOP3, an add and a LOP3).
__device__ __forceinline__ uint32_t nibbles_lo(uint32_t p) {
  return (((p & 0x0F0F0F0Fu) ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;
}
__device__ __forceinline__ uint32_t nibbles_hi(uint32_t p) {
  return nibbles_lo(p >> 4);
}

}  // namespace quant
