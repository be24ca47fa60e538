// The forward tile loop shared by K1 (flash_text_fwd.cu) and K5
// (flash_stream_fwd.cu): causal attention with the gate2 video-block bias
// for one (batch b, head h, 64-row q tile), K/V streamed through shared
// memory in 64-key tiles with an online softmax. For q row i (local) at
// global position r = q_offset + i, and key c < S_k:
//   s[i, c] = q[i]·k[c] / sqrt(Dh)                     f32 from bf16 operands
//           + gate2[h]  where vs >= 0, r >= vs+F, vs <= c < vs+F
//                       (vs = video_start[b], F = max_feats)
//   s[i, c] = -1e30     where c > r (causal) or c >= S_k (key padding)
//   out[i]  = softmax(s[i]) @ v                         f32 softmax, P in bf16,
//                                                       f32 accumulation
//   lse[i]  = log sum_c exp(s[i, c])                    read by the backward
// K1 calls it with q_offset 0 and S_k = S_q; K5 with the q shard's global
// offset and K/V that may be longer than q.
//
// Blocking: one block of 4 warps per (b, h, 64-row q tile); each warp owns 16
// q rows. Products are mma.sync m16n8k16 bf16 -> f32. The score accumulator
// of the QK^T product is reused in registers as the A operand of the PV
// product (the m16n8 C layout of two adjacent n-tiles is the m16k16 A layout).
// Tiles with the longest causal loop are scheduled first; key tiles past the
// tile's last global row are never loaded.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace flash {

constexpr int FWD_BQ = 64;  // q rows per block (4 warps x 16)
constexpr int FWD_BK = 64;  // keys per K/V tile
constexpr int FWD_THREADS = 128;

struct FwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* gate2;
  const int* video_start;
  bf16* out;
  float* lse;  // (B, H, S_q)
  int S_q, S_k, q_offset, H, max_feats;
  long long qsb, qss, qsh;  // q strides (batch, sequence, head)
  long long ksb, kss, ksh;  // k and v strides
  long long osb, oss, osh;  // out strides
  float scale;
};

template <int DH>
__device__ __forceinline__ void fwd_tile(const FwdArgs& a) {
  constexpr int BQ = FWD_BQ;
  constexpr int BK = FWD_BK;
  constexpr int NTHREADS = FWD_THREADS;
  constexpr int LDS = DH + 8;        // smem row pitch: conflict-free fragments
  constexpr int KSTEPS = DH / 16;    // k-steps of the QK^T product
  constexpr int NT_D = DH / 8;       // n-tiles of the output row
  constexpr int NT_K = BK / 8;       // n-tiles of a score tile
  constexpr int VEC_PER_ROW = DH / 8;  // 16-byte vectors per K/V row
  __shared__ __align__(16) bf16 k_s[BK * LDS];
  __shared__ __align__(16) bf16 v_s[BK * LDS];

  const int S_q = a.S_q;
  const int S_k = a.S_k;
  const int n_qt = (S_q + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // row within the 8-row group of a fragment
  const int t = lane & 3;   // thread within the quad

  const bf16* qb = a.q + b * a.qsb + h * a.qsh;
  const bf16* kb = a.k + b * a.ksb + h * a.ksh;
  const bf16* vb = a.v + b * a.ksb + h * a.ksh;
  const long long ss = a.qss;
  const long long kss = a.kss;
  const int vs = a.video_start[b];
  const float g2 = a.gate2[h];
  const int max_feats = a.max_feats;
  const float scale = a.scale;

  const int r0 = q0 + warp * 16 + g;  // this thread's two local rows
  const int r1 = r0 + 8;
  const int gr0 = a.q_offset + r0;    // and their global positions
  const int gr1 = gr0 + 8;

  // Q fragments straight from global memory: read once per block.
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + t * 2;
    qf[kk][0] = r0 < S_q ? *reinterpret_cast<const uint32_t*>(qb + r0 * ss + c) : 0u;
    qf[kk][1] = r1 < S_q ? *reinterpret_cast<const uint32_t*>(qb + r1 * ss + c) : 0u;
    qf[kk][2] = r0 < S_q ? *reinterpret_cast<const uint32_t*>(qb + r0 * ss + c + 8) : 0u;
    qf[kk][3] = r1 < S_q ? *reinterpret_cast<const uint32_t*>(qb + r1 * ss + c + 8) : 0u;
  }

  float o[NT_D][4];
#pragma unroll
  for (int d = 0; d < NT_D; ++d) {
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};  // running row max (rows r0, r1)
  float l[2] = {0.f, 0.f};              // this thread's share of the row sum

  // keys past the tile's last global row are causally dead
  const int kv_end = min(S_k, a.q_offset + q0 + BQ);
  const int n_kt = (kv_end + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    for (int i = threadIdx.x; i < BK * VEC_PER_ROW; i += NTHREADS) {
      const int row = i / VEC_PER_ROW;
      const int vec = i % VEC_PER_ROW;
      const int key = k0 + row;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < S_k) {  // rows past S_k are zero: 0 * garbage could be NaN
        kv = *reinterpret_cast<const uint4*>(kb + key * kss + vec * 8);
        vv = *reinterpret_cast<const uint4*>(vb + key * kss + vec * 8);
      }
      *reinterpret_cast<uint4*>(k_s + row * LDS + vec * 8) = kv;
      *reinterpret_cast<uint4*>(v_s + row * LDS + vec * 8) = vv;
    }
    __syncthreads();

    // scores: (16 rows x 64 keys) per warp
    float sc[NT_K][4];
#pragma unroll
    for (int n = 0; n < NT_K; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int n = 0; n < NT_K; ++n) {
        const bf16* kp = k_s + (n * 8 + g) * LDS + kk * 16 + t * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + 8);
        mma_16816(sc[n], qf[kk], b0, b1);
      }
    }

    // scale, gate2 video block, causal + key-padding mask; row max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT_K; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i < 2 ? gr0 : gr1;
        const int col = k0 + n * 8 + t * 2 + (i & 1);
        float s = sc[n][i] * scale;
        if (in_video_block(row, col, vs, max_feats)) s += g2;
        if (col > row || col >= S_k) s = NEG_INF;
        sc[n][i] = s;
        mx[i >> 1] = fmaxf(mx[i >> 1], s);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
    }
    // Key 0 lies in the first tile and is visible to every row (global
    // rows are >= 0), so mx is a finite score from the first tile on;
    // exp(-inf) = 0 clears the empty initial state.
    const float alpha0 = __expf(m[0] - mx[0]);
    const float alpha1 = __expf(m[1] - mx[1]);
    m[0] = mx[0];
    m[1] = mx[1];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT_K; ++n) {
      sc[n][0] = __expf(sc[n][0] - m[0]);
      sc[n][1] = __expf(sc[n][1] - m[0]);
      sc[n][2] = __expf(sc[n][2] - m[1]);
      sc[n][3] = __expf(sc[n][3] - m[1]);
      rs0 += sc[n][0] + sc[n][1];
      rs1 += sc[n][2] + sc[n][3];
    }
    l[0] = l[0] * alpha0 + rs0;
    l[1] = l[1] * alpha1 + rs1;
#pragma unroll
    for (int d = 0; d < NT_D; ++d) {
      o[d][0] *= alpha0;
      o[d][1] *= alpha0;
      o[d][2] *= alpha1;
      o[d][3] *= alpha1;
    }

    // O += P @ V, P from the score registers (bf16), V from shared memory
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f32(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_f32(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_f32(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_f32(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int d = 0; d < NT_D; ++d) {
        const bf16* vp = v_s + (kk * 16 + t * 2) * LDS + d * 8 + g;
        const uint32_t b0 = pack_raw(vp[0], vp[LDS]);
        const uint32_t b1 = pack_raw(vp[8 * LDS], vp[9 * LDS]);
        mma_16816(o[d], pa, b0, b1);
      }
    }
    __syncthreads();  // the next tile overwrites k_s / v_s
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
  }
  const float inv0 = 1.f / l[0];
  const float inv1 = 1.f / l[1];
  bf16* ob = a.out + b * a.osb + h * a.osh;
#pragma unroll
  for (int d = 0; d < NT_D; ++d) {
    const int c = d * 8 + t * 2;
    if (r0 < S_q) {
      *reinterpret_cast<uint32_t*>(ob + r0 * a.oss + c) =
          pack_f32(o[d][0] * inv0, o[d][1] * inv0);
    }
    if (r1 < S_q) {
      *reinterpret_cast<uint32_t*>(ob + r1 * a.oss + c) =
          pack_f32(o[d][2] * inv1, o[d][3] * inv1);
    }
  }
  if (t == 0) {
    float* lb = a.lse + (static_cast<long long>(b) * a.H + h) * S_q;
    if (r0 < S_q) lb[r0] = m[0] + logf(l[0]);
    if (r1 < S_q) lb[r1] = m[1] + logf(l[1]);
  }
}

// Launch `kernel` (a __global__ wrapper of fwd_tile) over (q tiles, H, B).
template <typename Kernel>
cudaError_t launch_fwd(Kernel kernel, const FwdArgs& a, int B,
                       cudaStream_t stream) {
  const dim3 grid((a.S_q + FWD_BQ - 1) / FWD_BQ, a.H, B);
  kernel<<<grid, FWD_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace flash
