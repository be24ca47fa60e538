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
// lse and delta (B, H, S) f32; gate2 (H,) f32; video_start (B,) int32;
// dg2_part (B, H, ceil(S / 64)) f32, summed by the caller.
//
// What bounds it on an H100: at the training shape (B 24, S 128, H 32,
// Dh 128) the call reads q/k/v/out/dout (126 MB) and writes dq/dk/dv
// (75 MB): ~60 us at 3.35 TB/s, against ~16 GFLOP of causal products,
// ~16 us at the dense bf16 peak. So it is bound by bytes, and the design
// reads each operand a small number of times and keeps every S x S tile
// (P, dP, dS) in registers.
// What the design does about the TPU kernel's shape: that kernel held all
// of S x S for one (b, h) in VMEM, which 227 KB of shared memory cannot
// hold at S 650 (TVQA) and beyond. Here the work is tiled in two passes, so
// any S is taken (the JAX package routes S <= 2048 here):
//   1. delta: D for every row, one warp per row.
//   2. dkdv:  one block per (b, h, 64-key tile), 4 warps x 16 keys. The K/V
//             tile sits in shared memory; the loop walks 32-row q tiles from
//             the key tile's first row to S (earlier rows see none of its
//             keys), staging Q, dO, lse and D in shared memory. dK and dV
//             accumulate in registers. Each block writes one dgate2 partial.
//   3. dq:    one block per (b, h, 64-row q tile), 4 warps x 16 rows, with
//             Q and dO fragments in registers; the loop walks 32-key K/V
//             tiles up to the diagonal.
// No atomics: every output element and every dgate2 partial has one writer,
// so the result is the same from run to run. Rows past S are zero-filled on
// load (0 * garbage could be NaN) and masked out of P.
// Not yet done (later work): cp.async/TMA double buffering, ldmatrix, wgmma,
// and fusing the dq pass into the dkdv pass.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::in_video_block;
using flash::mma_16816;
using flash::pack_f32;
using flash::pack_raw;

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BK_DKV = 64;  // keys per dkdv block (4 warps x 16)
constexpr int BQ_DKV = 32;  // q rows per dkdv loop step
constexpr int BQ_DQ = 64;   // q rows per dq block (4 warps x 16)
constexpr int BK_DQ = 32;   // keys per dq loop step
constexpr int DELTA_ROWS = 8;  // rows (warps) per delta block

template <int DH>
constexpr int dkdv_smem_bytes() {
  return (2 * BK_DKV + 2 * BQ_DKV) * (DH + 8) * 2 + 2 * BQ_DKV * 4;
}

// Copy `nrows` rows of DH bf16 starting at sequence row r0 (stride ss) into
// shared memory with pitch LDS; rows past S are zero.
template <int DH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int nrows, int S, long long ss) {
  constexpr int LDS = DH + 8;
  constexpr int VEC = DH / 8;
  for (int i = threadIdx.x; i < nrows * VEC; i += NTHREADS) {
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

template <int DH>
__global__ void __launch_bounds__(DELTA_ROWS * 32)
flash_bwd_delta_kernel(const bf16* __restrict__ out,
                       const bf16* __restrict__ dout,
                       float* __restrict__ delta, int S, int H,
                       long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * DELTA_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* o = out + row * DH;
  const bf16* d = dout + row * DH;
  float acc = 0.f;
#pragma unroll
  for (int c = lane * 4; c < DH; c += 128) {
    const uint2 ov = *reinterpret_cast<const uint2*>(o + c);
    const uint2 dv = *reinterpret_cast<const uint2*>(d + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 a = __bfloat1622float2(o2[j]);
      const float2 b = __bfloat1622float2(d2[j]);
      acc += a.x * b.x + a.y * b.y;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const long long bs = row / H;
    const int s = static_cast<int>(bs % S);
    const long long b = bs / S;
    delta[(b * H + h) * S + s] = acc;
  }
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ gate2,
                      const int* __restrict__ video_start,
                      bf16* __restrict__ dk, bf16* __restrict__ dv,
                      float* __restrict__ dg2_part, int S, int H,
                      int max_feats, float scale) {
  constexpr int LDS = DH + 8;        // smem pitch: conflict-free fragments
  constexpr int KSTEPS = DH / 16;    // k-steps over the head dim
  constexpr int NT_D = DH / 8;       // n-tiles of a dK/dV row
  constexpr int NT_Q = BQ_DKV / 8;   // n-tiles of q rows per loop step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + BK_DKV * LDS;
  bf16* q_s = v_s + BK_DKV * LDS;
  bf16* do_s = q_s + BQ_DKV * LDS;
  float* lse_s = reinterpret_cast<float*>(do_s + BQ_DKV * LDS);
  float* d_s = lse_s + BQ_DKV;
  __shared__ float red[NWARPS];

  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * BK_DKV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  const long long ss = static_cast<long long>(H) * DH;
  const long long head_off = static_cast<long long>(b) * S * ss +
                             static_cast<long long>(h) * DH;
  const float* lse_b = lse + (static_cast<long long>(b) * H + h) * S;
  const float* d_b = delta + (static_cast<long long>(b) * H + h) * S;
  const int vs = video_start[b];
  const float g2 = gate2[h];

  load_rows<DH>(k_s, k + head_off, k0, BK_DKV, S, ss);
  load_rows<DH>(v_s, v + head_off, k0, BK_DKV, S, ss);

  float acc_dk[NT_D][4];
  float acc_dv[NT_D][4];
#pragma unroll
  for (int d = 0; d < NT_D; ++d) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_dk[d][i] = acc_dv[d][i] = 0.f;
  }
  float dg2 = 0.f;
  const int wk = warp * 16;          // the warp's first key within the tile
  const int key0 = k0 + wk + g;      // this thread's two keys (C rows)
  const int key1 = key0 + 8;

  // q rows before k0 see none of the tile's keys (causal)
  for (int q0 = k0; q0 < S; q0 += BQ_DKV) {
    __syncthreads();  // the previous step is done with q_s / do_s
    load_rows<DH>(q_s, q + head_off, q0, BQ_DKV, S, ss);
    load_rows<DH>(do_s, dout + head_off, q0, BQ_DKV, S, ss);
    for (int i = threadIdx.x; i < BQ_DKV; i += NTHREADS) {
      const bool in = q0 + i < S;
      lse_s[i] = in ? lse_b[q0 + i] : 0.f;
      d_s[i] = in ? d_b[q0 + i] : 0.f;
    }
    __syncthreads();
    if (q0 + BQ_DKV - 1 < k0 + wk) continue;  // all of this warp's keys are
                                              // after these rows (uniform)

    // S^T = K Q^T: 16 keys x BQ_DKV rows
    float st[NT_Q][4];
#pragma unroll
    for (int n = 0; n < NT_Q; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4];
      load_a<LDS>(a, k_s, wk, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < NT_Q; ++n) {
        uint32_t b0, b1;
        load_b_rows<LDS>(b0, b1, q_s, n * 8, kk * 16, g, t);
        mma_16816(st[n], a, b0, b1);
      }
    }
    // P^T from K1's lse; 0 off the causal mask and past S
#pragma unroll
    for (int n = 0; n < NT_Q; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = i < 2 ? key0 : key1;
        const int ql = n * 8 + t * 2 + (i & 1);
        const int row = q0 + ql;
        float p = 0.f;
        if (key <= row && row < S) {
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
      uint32_t a[4];
      load_a<LDS>(a, v_s, wk, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < NT_Q; ++n) {
        uint32_t b0, b1;
        load_b_rows<LDS>(b0, b1, do_s, n * 8, kk * 16, g, t);
        mma_16816(dpt[n], a, b0, b1);
      }
    }
    // dS^T = P^T (dP^T - D); dgate2 over the video block, f32
#pragma unroll
    for (int n = 0; n < NT_Q; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = i < 2 ? key0 : key1;
        const int ql = n * 8 + t * 2 + (i & 1);
        const float ds = st[n][i] * (dpt[n][i] - d_s[ql]);
        if (in_video_block(q0 + ql, key, vs, max_feats)) dg2 += ds;
        dpt[n][i] = ds;
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

  bf16* dkb = dk + head_off;
  bf16* dvb = dv + head_off;
#pragma unroll
  for (int d = 0; d < NT_D; ++d) {
    const int c = d * 8 + t * 2;
    if (key0 < S) {
      *reinterpret_cast<uint32_t*>(dkb + key0 * ss + c) =
          pack_f32(acc_dk[d][0] * scale, acc_dk[d][1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + key0 * ss + c) =
          pack_f32(acc_dv[d][0], acc_dv[d][1]);
    }
    if (key1 < S) {
      *reinterpret_cast<uint32_t*>(dkb + key1 * ss + c) =
          pack_f32(acc_dk[d][2] * scale, acc_dk[d][3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + key1 * ss + c) =
          pack_f32(acc_dv[d][2], acc_dv[d][3]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    dg2 += __shfl_xor_sync(0xffffffffu, dg2, off);
  }
  if (lane == 0) red[warp] = dg2;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) sum += red[w];
    dg2_part[(static_cast<long long>(b) * H + h) * gridDim.x + kt] = sum;
  }
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ gate2,
                    const int* __restrict__ video_start,
                    bf16* __restrict__ dq, int S, int H, int max_feats,
                    float scale) {
  constexpr int LDS = DH + 8;
  constexpr int KSTEPS = DH / 16;
  constexpr int NT_D = DH / 8;
  constexpr int NT_K = BK_DQ / 8;    // n-tiles of keys per loop step
  __shared__ __align__(16) bf16 k_s[BK_DQ * LDS];
  __shared__ __align__(16) bf16 v_s[BK_DQ * LDS];

  const int n_qt = (S + BQ_DQ - 1) / BQ_DQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ_DQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  const long long ss = static_cast<long long>(H) * DH;
  const long long head_off = static_cast<long long>(b) * S * ss +
                             static_cast<long long>(h) * DH;
  const bf16* qb = q + head_off;
  const bf16* dob = dout + head_off;
  const float* lse_b = lse + (static_cast<long long>(b) * H + h) * S;
  const float* d_b = delta + (static_cast<long long>(b) * H + h) * S;
  const int vs = video_start[b];
  const float g2 = gate2[h];

  const int r0 = q0 + warp * 16 + g;  // this thread's two rows
  const int r1 = r0 + 8;
  const float lse0 = r0 < S ? lse_b[r0] : 0.f;
  const float lse1 = r1 < S ? lse_b[r1] : 0.f;
  const float d0 = r0 < S ? d_b[r0] : 0.f;
  const float d1 = r1 < S ? d_b[r1] : 0.f;

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
      qf[kk][j] = row < S ? *reinterpret_cast<const uint32_t*>(qb + row * ss + col) : 0u;
      df[kk][j] = row < S ? *reinterpret_cast<const uint32_t*>(dob + row * ss + col) : 0u;
    }
  }

  float acc[NT_D][4];
#pragma unroll
  for (int d = 0; d < NT_D; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  const int kv_end = min(S, q0 + BQ_DQ);  // later keys are causally dead
  const int n_kt = (kv_end + BK_DQ - 1) / BK_DQ;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK_DQ;
    load_rows<DH>(k_s, k + head_off, k0, BK_DQ, S, ss);
    load_rows<DH>(v_s, v + head_off, k0, BK_DQ, S, ss);
    __syncthreads();
    if (q0 + warp * 16 + 15 >= k0) {  // else every key is after the warp's
                                      // rows (warp-uniform)
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
      // P from K1's lse
#pragma unroll
      for (int n = 0; n < NT_K; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = i < 2 ? r0 : r1;
          const int col = k0 + n * 8 + t * 2 + (i & 1);
          float p = 0.f;
          if (col <= row && row < S) {
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

  bf16* dqb = dq + head_off;
#pragma unroll
  for (int d = 0; d < NT_D; ++d) {
    const int c = d * 8 + t * 2;
    if (r0 < S) {
      *reinterpret_cast<uint32_t*>(dqb + r0 * ss + c) =
          pack_f32(acc[d][0] * scale, acc[d][1] * scale);
    }
    if (r1 < S) {
      *reinterpret_cast<uint32_t*>(dqb + r1 * ss + c) =
          pack_f32(acc[d][2] * scale, acc[d][3] * scale);
    }
  }
}

template <int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const void* lse,
                       const void* gate2, const void* video_start, void* dq,
                       void* dk, void* dv, void* delta, void* dg2_part, int B,
                       int S, int H, int max_feats, float scale,
                       cudaStream_t stream) {
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* g2_ = static_cast<const float*>(gate2);
  const int* vs_ = static_cast<const int*>(video_start);
  float* delta_ = static_cast<float*>(delta);

  const long long rows = static_cast<long long>(B) * S * H;
  const long long n_delta = (rows + DELTA_ROWS - 1) / DELTA_ROWS;
  if (n_delta > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_delta_kernel<DH><<<static_cast<unsigned>(n_delta),
                               DELTA_ROWS * 32, 0, stream>>>(
      static_cast<const bf16*>(out), do_, delta_, S, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  flash_bwd_dq_kernel<DH><<<dim3((S + BQ_DQ - 1) / BQ_DQ, H, B), NTHREADS, 0,
                            stream>>>(q_, k_, v_, do_, lse_, delta_, g2_, vs_,
                                      static_cast<bf16*>(dq), S, H, max_feats,
                                      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int smem = dkdv_smem_bytes<DH>();
  // The opt-in above 48 KB holds only for the current device: set it on
  // every launch (it is cheap).
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<DH><<<dim3((S + BK_DKV - 1) / BK_DKV, H, B), NTHREADS,
                              smem, stream>>>(
      q_, k_, v_, do_, lse_, delta_, g2_, vs_, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float*>(dg2_part), S, H, max_feats,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_text_bwd(const void* q, const void* k, const void* v,
                              const void* out, const void* dout,
                              const void* lse, const void* gate2,
                              const void* video_start, void* dq, void* dk,
                              void* dv, void* delta, void* dg2_part, int B,
                              int S, int H, int Dh, int max_feats, float scale,
                              void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {  // every LLaMA preset of the repo has Dh = 128
    case 128:
      return static_cast<int>(launch_bwd<128>(
          q, k, v, out, dout, lse, gate2, video_start, dq, dk, dv, delta,
          dg2_part, B, S, H, max_feats, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
