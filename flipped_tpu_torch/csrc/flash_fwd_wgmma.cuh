// The forward tile loop of K1 (flash_text_fwd.cu) on Hopper: causal
// attention with the gate2 video-block bias, K/V fed by TMA through an
// mbarrier ring, both products on wgmma. For q row i (local) at global
// position r = q_offset + i, and key c < S_k:
//   s[i, c] = q[i]·k[c] / sqrt(Dh)                     f32 from bf16 operands
//           + gate2[h]  where vs >= 0, r >= vs+F, vs <= c < vs+F
//                       (vs = video_start[b], F = max_feats)
//   s[i, c] = -1e30     where c > r (causal) or c >= S_k (key padding)
//   out[i]  = softmax(s[i]) @ v                         f32 softmax, P in bf16,
//                                                       f32 accumulation
//   lse[i]  = log sum_c exp(s[i, c])                    read by the backward
// K1 runs it with q_offset 0 and S_k = S_q; the loop keeps both as
// parameters, as flash_fwd.cuh's does for K5.
//
// Blocking: a work item is one (b, h, 128-row q tile); the grid is
// persistent (one block an SM, items in turn, the longest causal loops
// first). A block is two consumer warpgroups of 64 q rows each and one
// producer warp, one lane of which issues every load by TMA: the item's Q
// tile into one of two slots, then its K and V tiles of 128 keys into a
// ring of two stages, K and V with barriers of their own so that Q K^T
// starts before V has landed. The producer runs ahead across items, so at
// the eval and training length (S 128: one K/V tile an item) the next
// item's Q, K and V stream in while this one computes. Causally dead K/V
// tiles are never loaded; rows past S_q and S_k come in as zeros (the 4-D
// tensor map stops at S, so no row of the next batch is read).
//
// Products: S = Q K^T is an SS wgmma m64n128k16 (Q and K both K-major along
// Dh, each a pair of 64-column boxes with the 128-byte swizzle). O += P V
// is an RS wgmma: P comes straight from the score registers (the f32
// accumulator layout of m64n128 packed to bf16 pairs is the A-register
// layout of m64k16), V is read from shared memory as an MN-major B
// through the transpose bit. The numerics are those of flash_fwd.cuh: the
// same scale, bias and masks, the unnormalised P rounded to bf16, the
// division by the row sum at the end.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace flashw {

typedef __nv_bfloat16 bf16;

constexpr int DH = 128;             // every LLaMA preset of the repo
constexpr int BQ = 128;             // q rows an item, 64 a warpgroup
constexpr int BKV = 128;            // keys a K/V tile
constexpr int BOX = 64;             // Dh columns a TMA box: 128 bytes
constexpr int BOX_BYTES = 128 * BOX * 2;        // 16 KB
constexpr int TILE_BYTES = 2 * BOX_BYTES;       // 128 rows x Dh: 32 KB
constexpr int Q_SLOTS = 2;
constexpr int KV_STAGES = 2;
constexpr int THREADS = 2 * 128 + 32;
constexpr int N_BARS = 2 * Q_SLOTS + 3 * KV_STAGES;
constexpr int SMEM = (Q_SLOTS + 2 * KV_STAGES) * TILE_BYTES + N_BARS * 8 +
                     1024;

struct Args {
  const float* gate2;
  const int* video_start;
  bf16* out;
  float* lse;                 // (B, H, S_q)
  int B, S_q, S_k, q_offset, H, max_feats;
  long long osb, oss, osh;    // out strides (batch, sequence, head)
  float scale;
};

struct Bars {
  uint64_t* full_q;
  uint64_t* empty_q;
  uint64_t* full_k;
  uint64_t* full_v;
  uint64_t* empty_kv;
};

__device__ __forceinline__ int n_qtiles(const Args& a) {
  return (a.S_q + BQ - 1) / BQ;
}

// item -> (q tile, head, batch), the q tiles with the most K/V tiles first
__device__ __forceinline__ void decode(const Args& a, int item, int& qt,
                                       int& h, int& b) {
  const int bh = item % (a.H * a.B);
  qt = n_qtiles(a) - 1 - item / (a.H * a.B);
  h = bh % a.H;
  b = bh / a.H;
}

// K/V tiles of q tile qt: keys past its last global row are causally dead
__device__ __forceinline__ int kv_tiles(const Args& a, int qt) {
  const int kv_end = min(a.S_k, a.q_offset + (qt + 1) * BQ);
  return (kv_end + BKV - 1) / BKV;
}

__device__ __forceinline__ void producer(uint8_t* smem, const Bars& bar,
                                         const CUtensorMap* q_map,
                                         const CUtensorMap* k_map,
                                         const CUtensorMap* v_map,
                                         const Args& a, int items) {
  int ni = 0, nkv = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++ni) {
    int qt, h, b;
    decode(a, item, qt, h, b);
    const int slot = ni % Q_SLOTS;
    if (ni >= Q_SLOTS) {
      hopper::mbar_wait(&bar.empty_q[slot], (ni / Q_SLOTS - 1) & 1);
    }
    uint8_t* qs = smem + slot * TILE_BYTES;
    hopper::mbar_arrive_expect_tx(&bar.full_q[slot], TILE_BYTES);
    hopper::tma_load_4d(qs, q_map, &bar.full_q[slot], 0, h, qt * BQ, b);
    hopper::tma_load_4d(qs + BOX_BYTES, q_map, &bar.full_q[slot], BOX, h,
                        qt * BQ, b);
    const int n_kt = kv_tiles(a, qt);
    for (int j = 0; j < n_kt; ++j, ++nkv) {
      const int s = nkv % KV_STAGES;
      if (nkv >= KV_STAGES) {
        hopper::mbar_wait(&bar.empty_kv[s], (nkv / KV_STAGES - 1) & 1);
      }
      uint8_t* ks = smem + (Q_SLOTS + s) * TILE_BYTES;
      uint8_t* vs = smem + (Q_SLOTS + KV_STAGES + s) * TILE_BYTES;
      hopper::mbar_arrive_expect_tx(&bar.full_k[s], TILE_BYTES);
      hopper::tma_load_4d(ks, k_map, &bar.full_k[s], 0, h, j * BKV, b);
      hopper::tma_load_4d(ks + BOX_BYTES, k_map, &bar.full_k[s], BOX, h,
                          j * BKV, b);
      hopper::mbar_arrive_expect_tx(&bar.full_v[s], TILE_BYTES);
      hopper::tma_load_4d(vs, v_map, &bar.full_v[s], 0, h, j * BKV, b);
      hopper::tma_load_4d(vs + BOX_BYTES, v_map, &bar.full_v[s], BOX, h,
                          j * BKV, b);
    }
  }
}

// S = Q K^T over Dh: 8 steps of 16, 4 in each 64-column box
__device__ __forceinline__ void qk(float (&s)[64], const uint8_t* q_rows,
                                   const uint8_t* k_tile) {
  const uint64_t dq0 = hopper::desc_sw128(q_rows);
  const uint64_t dq1 = hopper::desc_sw128(q_rows + BOX_BYTES);
  const uint64_t dk0 = hopper::desc_sw128(k_tile);
  const uint64_t dk1 = hopper::desc_sw128(k_tile + BOX_BYTES);
  hopper::wgmma_fence();
  hopper::wgmma_m64n128k16_bf16_ss_zero(s, dq0, dk0);
#pragma unroll
  for (int ks = 1; ks < 4; ++ks) {
    hopper::wgmma_m64n128k16_bf16_ss(s, dq0 + 2 * ks, dk0 + 2 * ks);
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    hopper::wgmma_m64n128k16_bf16_ss(s, dq1 + 2 * ks, dk1 + 2 * ks);
  }
  hopper::wgmma_commit();
}

// O += P V over the tile's 128 keys: 8 steps of 16 key rows (2048 bytes)
__device__ __forceinline__ void pv(float (&o)[64], const uint32_t (&p)[8][4],
                                   const uint8_t* v_tile) {
#pragma unroll
  for (int i = 0; i < 64; ++i) hopper::fence_operand(o[i]);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    hopper::wgmma_m64n128k16_bf16_rs_tb(
        o, p[kk], hopper::desc_sw128_mn(v_tile + kk * 2048, BOX_BYTES));
  }
  hopper::wgmma_commit();
}

// The consumer warpgroups: every item of the block in turn.
__device__ __forceinline__ void consume(uint8_t* smem, const Bars& bar,
                                        const Args& a, int items) {
  const int wg = threadIdx.x / 128;
  const int w = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool leader = threadIdx.x % 128 == 0;
  const int max_feats = a.max_feats;
  const float scale = a.scale;
  uint64_t* full_q = bar.full_q;
  uint64_t* full_k = bar.full_k;
  uint64_t* full_v = bar.full_v;

  float sc[64], o[64];
  int ni = 0, nkv = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++ni) {
    int qt, h, b;
    decode(a, item, qt, h, b);
    const int slot = ni % Q_SLOTS;
    hopper::mbar_wait(&full_q[slot], (ni / Q_SLOTS) & 1);
    const uint8_t* q_rows = smem + slot * TILE_BYTES + wg * 64 * 128;
    const int vs = a.video_start[b];
    const float g2 = a.gate2[h];
    const int wg_row = qt * BQ + 64 * wg;           // local, first row
    const int r0 = wg_row + 16 * w + g;             // the thread's rows
    const int r1 = r0 + 8;
    const int gr0 = a.q_offset + r0;
    const int gr1 = gr0 + 8;

#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running row max (rows r0, r1)
    float l[2] = {0.f, 0.f};              // this thread's share of the sum

    const int n_kt = kv_tiles(a, qt);
    for (int j = 0; j < n_kt; ++j, ++nkv) {
      const int s = nkv % KV_STAGES;
      const uint32_t par = (nkv / KV_STAGES) & 1;
      const uint8_t* k_tile = smem + (Q_SLOTS + s) * TILE_BYTES;
      const uint8_t* v_tile = smem + (Q_SLOTS + KV_STAGES + s) * TILE_BYTES;
      hopper::mbar_wait(&full_k[s], par);
      qk(sc, q_rows, k_tile);
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) hopper::fence_operand(sc[i]);
      // the item's last Q K^T: its Q slot goes back to the producer
      if (j == n_kt - 1 && leader) hopper::mbar_arrive(&bar.empty_q[slot]);

      // scale, gate2 video block, causal + key-padding mask; row max.
      // sc[4i + e] is (row r0, key k0 + 8i + 2t + e), sc[4i + 2 + e] row r1.
      const int k0 = j * BKV;
      const bool edge = (vs >= 0 && k0 < vs + max_feats && k0 + BKV > vs) ||
                        k0 + BKV - 1 > a.q_offset + wg_row ||
                        k0 + BKV > a.S_k;
      float mx[2] = {m[0], m[1]};
      if (edge) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int row = (i & 2) ? gr1 : gr0;
          const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          float v = sc[i] * scale;
          if (flash::in_video_block(row, col, vs, max_feats)) v += g2;
          if (col > row || col >= a.S_k) v = flash::NEG_INF;
          sc[i] = v;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], v);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          sc[i] *= scale;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      // Key 0 lies in the first tile and is visible to every row, so mx is
      // a finite score from the first tile on; exp(-inf) = 0 clears the
      // empty initial state (o is 0 there).
      const float alpha0 = __expf(m[0] - mx[0]);
      const float alpha1 = __expf(m[1] - mx[1]);
      m[0] = mx[0];
      m[1] = mx[1];
      float rs0 = 0.f, rs1 = 0.f;
      uint32_t p[8][4];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float e0 = __expf(sc[4 * i] - m[0]);
        const float e1 = __expf(sc[4 * i + 1] - m[0]);
        const float e2 = __expf(sc[4 * i + 2] - m[1]);
        const float e3 = __expf(sc[4 * i + 3] - m[1]);
        rs0 += e0 + e1;
        rs1 += e2 + e3;
        // keys 16kk + 2t (i = 2kk) and 16kk + 8 + 2t (i = 2kk + 1): the
        // A fragment registers of step kk
        p[i >> 1][2 * (i & 1)] = flash::pack_f32(e0, e1);
        p[i >> 1][2 * (i & 1) + 1] = flash::pack_f32(e2, e3);
      }
      l[0] = l[0] * alpha0 + rs0;
      l[1] = l[1] * alpha1 + rs1;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        o[4 * i] *= alpha0;
        o[4 * i + 1] *= alpha0;
        o[4 * i + 2] *= alpha1;
        o[4 * i + 3] *= alpha1;
      }

      hopper::mbar_wait(&full_v[s], par);
      pv(o, p, v_tile);
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) hopper::fence_operand(o[i]);
      if (leader) hopper::mbar_arrive(&bar.empty_kv[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv0 = 1.f / l[0];
    const float inv1 = 1.f / l[1];
    // o[4i + e] is (row r0, Dh column 8i + 2t + e), o[4i + 2 + e] row r1;
    // each quad transposes the pairs of 32 columns at a time for 16-byte
    // stores (out's rows are 16-byte aligned: the wrapper allocates it)
    bf16* ob = a.out + b * a.osb + h * a.osh;
#pragma unroll
    for (int j = 0; j < DH / 32; ++j) {
      uint32_t v0[4], v1[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * j + q;
        v0[q] = flash::pack_f32(o[4 * i] * inv0, o[4 * i + 1] * inv0);
        v1[q] = flash::pack_f32(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
      }
      const uint4 w0 = hopper::quad_transpose(v0, t);
      const uint4 w1 = hopper::quad_transpose(v1, t);
      const int c = 8 * (4 * j + t);
      if (r0 < a.S_q) *reinterpret_cast<uint4*>(ob + r0 * a.oss + c) = w0;
      if (r1 < a.S_q) *reinterpret_cast<uint4*>(ob + r1 * a.oss + c) = w1;
    }
    if (t == 0) {
      float* lb = a.lse + (static_cast<long long>(b) * a.H + h) * a.S_q;
      if (r0 < a.S_q) lb[r0] = m[0] + logf(l[0]);
      if (r1 < a.S_q) lb[r1] = m[1] + logf(l[1]);
    }
  }
}

// The kernel body: THREADS threads, warps 0-7 the consumer warpgroups,
// warp 8 the producer.
__device__ __forceinline__ void fwd_body(const CUtensorMap* q_map,
                                         const CUtensorMap* k_map,
                                         const CUtensorMap* v_map,
                                         const Args& a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) &
                              1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + (Q_SLOTS + 2 * KV_STAGES) * TILE_BYTES);
  const Bars bar{bars, bars + Q_SLOTS, bars + 2 * Q_SLOTS,
                 bars + 2 * Q_SLOTS + KV_STAGES,
                 bars + 2 * Q_SLOTS + 2 * KV_STAGES};
  const int items = n_qtiles(a) * a.H * a.B;

  if (threadIdx.x == 0) {
    for (int i = 0; i < Q_SLOTS; ++i) {
      hopper::mbar_init(&bar.full_q[i], 1);
      hopper::mbar_init(&bar.empty_q[i], 2);  // one arrive a warpgroup
    }
    for (int i = 0; i < KV_STAGES; ++i) {
      hopper::mbar_init(&bar.full_k[i], 1);
      hopper::mbar_init(&bar.full_v[i], 1);
      hopper::mbar_init(&bar.empty_kv[i], 2);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256) producer(smem, bar, q_map, k_map, v_map, a, items);
  } else {
    consume(smem, bar, a, items);
  }
}

// Host: the launch of `kernel` (a __global__ wrapper of fwd_body taking
// the three maps and Args) on a persistent grid.
template <typename Kernel>
inline cudaError_t launch(Kernel kernel, const CUtensorMap& q_map,
                          const CUtensorMap& k_map, const CUtensorMap& v_map,
                          const Args& a, cudaStream_t stream) {
  static bool attr_set = false;
  cudaError_t err = cudaSuccess;
  if (!attr_set) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    attr_set = err == cudaSuccess;
  }
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const long long items =
      static_cast<long long>((a.S_q + BQ - 1) / BQ) * a.H * a.B;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = items < sms ? static_cast<int>(items) : sms;
  kernel<<<grid, THREADS, SMEM, stream>>>(q_map, k_map, v_map, a);
  return cudaGetLastError();
}

}  // namespace flashw
