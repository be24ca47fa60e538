// The backward tile loops of K2 (flash_text_bwd.cu), on mma.sync; K6a and
// K6b run the TMA + wgmma loops of flash_bwd_wgmma.cuh, which compute the
// same function. For q row i (local) at global position
// r = q_offset + i and key c, with the forward's scores s (flash_fwd.cuh),
// its saved row log-sum-exp lse and D = rowsum(dO * O) given per row:
//   P[i, c]   = exp(s[i, c] - lse[i])       0 unless c <= r, c < S_k, i < S_q
//   dV[c]     = sum_i bf16(P[i, c]) dO[i]    f32 accumulation
//   dP[i, c]  = dO[i] . V[c]                 f32 from bf16 operands
//   dS[i, c]  = P[i, c] (dP[i, c] - D[i])    f32
//   dQ[i]     = scale sum_c bf16(dS[i, c]) K[c]
//   dK[c]     = scale sum_i bf16(dS[i, c]) Q[i]
//   dgate2[h] = sum over the video block of dS (f32), one partial per dq
//               block
// P and dS are rounded to bf16 before their products, as the TPU kernels
// round them.
//
// Layout: q, dout, dq are contiguous (B, S_q, H, Dh) bf16; k, v, dk, dv
// contiguous (B, S_k, H, Dh); lse and delta (B, H, S_q) f32; gate2 (H,) f32;
// video_start (B,) int32.
//
//   dkdv_tile: one block per (b, h, 64-key tile), 4 warps x 16 keys. The K/V
//              tile sits in shared memory; the loop walks 32-row q tiles
//              from the first row that sees the tile's first key to S_q,
//              staging Q, dO, lse and D in shared memory. dK and dV
//              accumulate in registers; key tiles above every row write
//              zeros.
//   dq_tile:   one block per (b, h, 64-row q tile), 4 warps x 16 rows, Q and
//              dO fragments in registers; the loop walks 32-key K/V tiles up
//              to the tile's last global row. It writes dQ and one dgate2
//              partial per block.
// No atomics: every output element and every dgate2 partial has one writer,
// so the result is the same from run to run. Rows past S_q and keys past S_k
// are zero-filled on load (0 * garbage could be NaN) and masked out of P.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace flash {

constexpr int BWD_WARPS = 4;
constexpr int BWD_THREADS = BWD_WARPS * 32;
constexpr int BK_DKV = 64;  // keys per dkdv block (4 warps x 16)
constexpr int BQ_DKV = 32;  // q rows per dkdv loop step
constexpr int BQ_DQ = 64;   // q rows per dq block (4 warps x 16)
constexpr int BK_DQ = 32;   // keys per dq loop step

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  const float* gate2;
  const int* video_start;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* dg2_part;  // (B, H, q tiles of BQ_DQ rows)
  int S_q, S_k, q_offset, H, max_feats;
  float scale;
};

template <int DH>
constexpr int dkdv_smem_bytes() {
  return (2 * BK_DKV + 2 * BQ_DKV) * (DH + 8) * 2 + 2 * BQ_DKV * 4;
}

// Copy `nrows` rows of DH bf16 starting at sequence row r0 (stride ss) into
// shared memory with pitch LDS; rows at or past S are zero.
template <int DH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int nrows, int S, long long ss) {
  constexpr int LDS = DH + 8;
  constexpr int VEC = DH / 8;
  for (int i = threadIdx.x; i < nrows * VEC; i += BWD_THREADS) {
    const int row = i / VEC;
    const int vec = i % VEC;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < S) {
      x = *reinterpret_cast<const uint4*>(src + (r0 + row) * ss + vec * 8);
    }
    *reinterpret_cast<uint4*>(dst + row * LDS + vec * 8) = x;
  }
}

// A fragment (16 x 16, row) from a shared-memory tile with pitch LDS:
// rows row0 .. row0+15, columns col0 .. col0+15.
template <int LDS>
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* base,
                                       int row0, int col0, int g, int t) {
  const bf16* p = base + (row0 + g) * LDS + col0 + t * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 8);
}

// B fragment (16 x 8, col) for B[k][n] = X[n][k]: X rows n0 .. n0+7 hold
// the columns of B, so each thread reads two consecutive k of one row.
template <int LDS>
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1,
                                            const bf16* base, int n0, int k0,
                                            int g, int t) {
  const bf16* p = base + (n0 + g) * LDS + k0 + t * 2;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment (16 x 8, col) for B[k][n] = X[k][n]: X rows k0 .. k0+15 are the
// k axis, so each thread gathers two rows of one column.
template <int LDS>
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1,
                                            const bf16* base, int k0, int n0,
                                            int g, int t) {
  const bf16* p = base + (k0 + t * 2) * LDS + n0 + g;
  b0 = pack_raw(p[0], p[LDS]);
  b1 = pack_raw(p[8 * LDS], p[9 * LDS]);
}

// The C tiles of n-tiles 2j and 2j+1 as the bf16 A fragment of k-step j.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = pack_f32(c0[0], c0[1]);
  a[1] = pack_f32(c0[2], c0[3]);
  a[2] = pack_f32(c1[0], c1[1]);
  a[3] = pack_f32(c1[2], c1[3]);
}

// Sum v over the block (BWD_THREADS threads) and write it from thread 0.
__device__ __forceinline__ void block_sum_store(float v, float* dst) {
  __shared__ float red[BWD_WARPS];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < BWD_WARPS; ++w) sum += red[w];
    *dst = sum;
  }
}

template <int DH>
__device__ __forceinline__ void dkdv_tile(const BwdArgs& a,
                                          unsigned char* smem_raw) {
  constexpr int LDS = DH + 8;        // smem pitch: conflict-free fragments
  constexpr int KSTEPS = DH / 16;    // k-steps over the head dim
  constexpr int NT_D = DH / 8;       // n-tiles of a dK/dV row
  constexpr int NT_Q = BQ_DKV / 8;   // n-tiles of q rows per loop step
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + BK_DKV * LDS;
  bf16* q_s = v_s + BK_DKV * LDS;
  bf16* do_s = q_s + BQ_DKV * LDS;
  float* lse_s = reinterpret_cast<float*>(do_s + BQ_DKV * LDS);
  float* d_s = lse_s + BQ_DKV;

  const int S_q = a.S_q;
  const int S_k = a.S_k;
  const int q_offset = a.q_offset;
  const int max_feats = a.max_feats;
  const float scale = a.scale;
  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * BK_DKV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  const long long ss = static_cast<long long>(a.H) * DH;
  const long long q_off = static_cast<long long>(b) * S_q * ss +
                          static_cast<long long>(h) * DH;
  const long long k_off = static_cast<long long>(b) * S_k * ss +
                          static_cast<long long>(h) * DH;
  const float* lse_b = a.lse + (static_cast<long long>(b) * a.H + h) * S_q;
  const float* d_b = a.delta + (static_cast<long long>(b) * a.H + h) * S_q;
  const int vs = a.video_start[b];
  const float g2 = a.gate2[h];

  load_rows<DH>(k_s, a.k + k_off, k0, BK_DKV, S_k, ss);
  load_rows<DH>(v_s, a.v + k_off, k0, BK_DKV, S_k, ss);

  float acc_dk[NT_D][4];
  float acc_dv[NT_D][4];
#pragma unroll
  for (int d = 0; d < NT_D; ++d) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_dk[d][i] = acc_dv[d][i] = 0.f;
  }
  const int wk = warp * 16;          // the warp's first key within the tile
  const int key0 = k0 + wk + g;      // this thread's two keys (C rows)
  const int key1 = key0 + 8;

  // rows at global positions before k0 see none of the tile's keys (causal)
  for (int q0 = max(0, k0 - q_offset); q0 < S_q; q0 += BQ_DKV) {
    __syncthreads();  // the previous step is done with q_s / do_s
    load_rows<DH>(q_s, a.q + q_off, q0, BQ_DKV, S_q, ss);
    load_rows<DH>(do_s, a.dout + q_off, q0, BQ_DKV, S_q, ss);
    for (int i = threadIdx.x; i < BQ_DKV; i += BWD_THREADS) {
      const bool in = q0 + i < S_q;
      lse_s[i] = in ? lse_b[q0 + i] : 0.f;
      d_s[i] = in ? d_b[q0 + i] : 0.f;
    }
    __syncthreads();
    if (q_offset + q0 + BQ_DKV - 1 < k0 + wk) continue;  // all of this warp's
                                                         // keys are after
                                                         // these rows (uniform)

    // S^T = K Q^T: 16 keys x BQ_DKV rows
    float st[NT_Q][4];
#pragma unroll
    for (int n = 0; n < NT_Q; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t af[4];
      load_a<LDS>(af, k_s, wk, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < NT_Q; ++n) {
        uint32_t b0, b1;
        load_b_rows<LDS>(b0, b1, q_s, n * 8, kk * 16, g, t);
        mma_16816(st[n], af, b0, b1);
      }
    }
    // P^T from the saved lse; 0 off the causal mask and past S_q / S_k
#pragma unroll
    for (int n = 0; n < NT_Q; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = i < 2 ? key0 : key1;
        const int ql = n * 8 + t * 2 + (i & 1);
        const int row = q_offset + q0 + ql;
        float p = 0.f;
        if (key <= row && q0 + ql < S_q && key < S_k) {
          float s = st[n][i] * scale;
          if (in_video_block(row, key, vs, max_feats)) s += g2;
          p = __expf(s - lse_s[ql]);
        }
        st[n][i] = p;
      }
    }
    // dV += P^T dO
#pragma unroll
    for (int kq = 0; kq < BQ_DKV / 16; ++kq) {
      uint32_t pa[4];
      c_to_a(pa, st[2 * kq], st[2 * kq + 1]);
#pragma unroll
      for (int d = 0; d < NT_D; ++d) {
        uint32_t b0, b1;
        load_b_cols<LDS>(b0, b1, do_s, kq * 16, d * 8, g, t);
        mma_16816(acc_dv[d], pa, b0, b1);
      }
    }
    // dP^T = V dO^T
    float dpt[NT_Q][4];
#pragma unroll
    for (int n = 0; n < NT_Q; ++n) dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t af[4];
      load_a<LDS>(af, v_s, wk, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < NT_Q; ++n) {
        uint32_t b0, b1;
        load_b_rows<LDS>(b0, b1, do_s, n * 8, kk * 16, g, t);
        mma_16816(dpt[n], af, b0, b1);
      }
    }
    // dS^T = P^T (dP^T - D)
#pragma unroll
    for (int n = 0; n < NT_Q; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dpt[n][i] = st[n][i] * (dpt[n][i] - d_s[n * 8 + t * 2 + (i & 1)]);
      }
    }
    // dK += dS^T Q
#pragma unroll
    for (int kq = 0; kq < BQ_DKV / 16; ++kq) {
      uint32_t da[4];
      c_to_a(da, dpt[2 * kq], dpt[2 * kq + 1]);
#pragma unroll
      for (int d = 0; d < NT_D; ++d) {
        uint32_t b0, b1;
        load_b_cols<LDS>(b0, b1, q_s, kq * 16, d * 8, g, t);
        mma_16816(acc_dk[d], da, b0, b1);
      }
    }
  }

  bf16* dkb = a.dk + k_off;
  bf16* dvb = a.dv + k_off;
#pragma unroll
  for (int d = 0; d < NT_D; ++d) {
    const int c = d * 8 + t * 2;
    if (key0 < S_k) {
      *reinterpret_cast<uint32_t*>(dkb + key0 * ss + c) =
          pack_f32(acc_dk[d][0] * scale, acc_dk[d][1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + key0 * ss + c) =
          pack_f32(acc_dv[d][0], acc_dv[d][1]);
    }
    if (key1 < S_k) {
      *reinterpret_cast<uint32_t*>(dkb + key1 * ss + c) =
          pack_f32(acc_dk[d][2] * scale, acc_dk[d][3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + key1 * ss + c) =
          pack_f32(acc_dv[d][2], acc_dv[d][3]);
    }
  }
}

template <int DH>
__device__ __forceinline__ void dq_tile(const BwdArgs& a) {
  constexpr int LDS = DH + 8;
  constexpr int KSTEPS = DH / 16;
  constexpr int NT_D = DH / 8;
  constexpr int NT_K = BK_DQ / 8;    // n-tiles of keys per loop step
  __shared__ __align__(16) bf16 k_s[BK_DQ * LDS];
  __shared__ __align__(16) bf16 v_s[BK_DQ * LDS];

  const int S_q = a.S_q;
  const int S_k = a.S_k;
  const int q_offset = a.q_offset;
  const int max_feats = a.max_feats;
  const float scale = a.scale;
  const int n_qt = (S_q + BQ_DQ - 1) / BQ_DQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ_DQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  const long long ss = static_cast<long long>(a.H) * DH;
  const long long q_off = static_cast<long long>(b) * S_q * ss +
                          static_cast<long long>(h) * DH;
  const long long k_off = static_cast<long long>(b) * S_k * ss +
                          static_cast<long long>(h) * DH;
  const bf16* qb = a.q + q_off;
  const bf16* dob = a.dout + q_off;
  const float* lse_b = a.lse + (static_cast<long long>(b) * a.H + h) * S_q;
  const float* d_b = a.delta + (static_cast<long long>(b) * a.H + h) * S_q;
  const int vs = a.video_start[b];
  const float g2 = a.gate2[h];

  const int r0 = q0 + warp * 16 + g;  // this thread's two local rows
  const int r1 = r0 + 8;
  const int gr0 = q_offset + r0;      // and their global positions
  const int gr1 = gr0 + 8;
  const float lse0 = r0 < S_q ? lse_b[r0] : 0.f;
  const float lse1 = r1 < S_q ? lse_b[r1] : 0.f;
  const float d0 = r0 < S_q ? d_b[r0] : 0.f;
  const float d1 = r1 < S_q ? d_b[r1] : 0.f;

  // Q and dO fragments straight from global memory: read once per block
  uint32_t qf[KSTEPS][4];
  uint32_t df[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + t * 2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = (j & 1) ? r1 : r0;
      const int col = c + ((j & 2) ? 8 : 0);
      qf[kk][j] = row < S_q ? *reinterpret_cast<const uint32_t*>(qb + row * ss + col) : 0u;
      df[kk][j] = row < S_q ? *reinterpret_cast<const uint32_t*>(dob + row * ss + col) : 0u;
    }
  }

  float acc[NT_D][4];
#pragma unroll
  for (int d = 0; d < NT_D; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float dg2 = 0.f;

  // keys past the tile's last global row are causally dead
  const int kv_end = min(S_k, q_offset + q0 + BQ_DQ);
  const int n_kt = (kv_end + BK_DQ - 1) / BK_DQ;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK_DQ;
    load_rows<DH>(k_s, a.k + k_off, k0, BK_DQ, S_k, ss);
    load_rows<DH>(v_s, a.v + k_off, k0, BK_DQ, S_k, ss);
    __syncthreads();
    if (q_offset + q0 + warp * 16 + 15 >= k0) {  // else every key is after
                                                 // the warp's rows (uniform)
      // S = Q K^T
      float sc[NT_K][4];
#pragma unroll
      for (int n = 0; n < NT_K; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int n = 0; n < NT_K; ++n) {
          uint32_t b0, b1;
          load_b_rows<LDS>(b0, b1, k_s, n * 8, kk * 16, g, t);
          mma_16816(sc[n], qf[kk], b0, b1);
        }
      }
      // P from the saved lse
#pragma unroll
      for (int n = 0; n < NT_K; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = i < 2 ? gr0 : gr1;
          const bool in_rows = (i < 2 ? r0 : r1) < S_q;
          const int col = k0 + n * 8 + t * 2 + (i & 1);
          float p = 0.f;
          if (col <= row && in_rows && col < S_k) {
            float s = sc[n][i] * scale;
            if (in_video_block(row, col, vs, max_feats)) s += g2;
            p = __expf(s - (i < 2 ? lse0 : lse1));
          }
          sc[n][i] = p;
        }
      }
      // dP = dO V^T, then dS = P (dP - D) in place
      float dp[NT_K][4];
#pragma unroll
      for (int n = 0; n < NT_K; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int n = 0; n < NT_K; ++n) {
          uint32_t b0, b1;
          load_b_rows<LDS>(b0, b1, v_s, n * 8, kk * 16, g, t);
          mma_16816(dp[n], df[kk], b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < NT_K; ++n) {
        dp[n][0] = sc[n][0] * (dp[n][0] - d0);
        dp[n][1] = sc[n][1] * (dp[n][1] - d0);
        dp[n][2] = sc[n][2] * (dp[n][2] - d1);
        dp[n][3] = sc[n][3] * (dp[n][3] - d1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // dgate2 over the video block, f32
          const int col = k0 + n * 8 + t * 2 + (i & 1);
          if (in_video_block(i < 2 ? gr0 : gr1, col, vs, max_feats)) {
            dg2 += dp[n][i];
          }
        }
      }
      // dQ += dS K
#pragma unroll
      for (int kq = 0; kq < BK_DQ / 16; ++kq) {
        uint32_t da[4];
        c_to_a(da, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
        for (int d = 0; d < NT_D; ++d) {
          uint32_t b0, b1;
          load_b_cols<LDS>(b0, b1, k_s, kq * 16, d * 8, g, t);
          mma_16816(acc[d], da, b0, b1);
        }
      }
    }
    __syncthreads();  // the next step overwrites k_s / v_s
  }

  bf16* dqb = a.dq + q_off;
#pragma unroll
  for (int d = 0; d < NT_D; ++d) {
    const int c = d * 8 + t * 2;
    if (r0 < S_q) {
      *reinterpret_cast<uint32_t*>(dqb + r0 * ss + c) =
          pack_f32(acc[d][0] * scale, acc[d][1] * scale);
    }
    if (r1 < S_q) {
      *reinterpret_cast<uint32_t*>(dqb + r1 * ss + c) =
          pack_f32(acc[d][2] * scale, acc[d][3] * scale);
    }
  }
  block_sum_store(dg2, a.dg2_part +
                           (static_cast<long long>(b) * a.H + h) * gridDim.x +
                           qt);
}

// Launch the dq kernel over (q tiles, H, B) and the dkdv kernel over (key
// tiles, H, B); the dkdv kernel's dynamic shared memory is above 48 KB, and
// the opt-in holds only for the current device: set it on every launch (it
// is cheap).
template <typename Kernel>
cudaError_t launch_dq(Kernel kernel, const BwdArgs& a, int B,
                      cudaStream_t stream) {
  kernel<<<dim3((a.S_q + BQ_DQ - 1) / BQ_DQ, a.H, B), BWD_THREADS, 0,
           stream>>>(a);
  return cudaGetLastError();
}

template <int DH, typename Kernel>
cudaError_t launch_dkdv(Kernel kernel, const BwdArgs& a, int B,
                        cudaStream_t stream) {
  constexpr int smem = dkdv_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.S_k + BK_DKV - 1) / BK_DKV, a.H, B), BWD_THREADS, smem,
           stream>>>(a);
  return cudaGetLastError();
}

}  // namespace flash
