// The forward tile loop of K1 (flash_text_fwd.cu) and K5
// (flash_stream_fwd.cu) on Hopper: causal attention with the gate2
// video-block bias, Q, K and V fed by TMA through mbarrier rings, both
// products on wgmma. For q row i (local) at global position
// r = q_offset + i, and key c < S_k:
//   s[i, c] = q[i]·k[c] / sqrt(Dh)                     f32 from bf16 operands
//           + gate2[h]  where vs >= 0, r >= vs+F, vs <= c < vs+F
//                       (vs = video_start[b], F = max_feats)
//   s[i, c] = -1e30     where c > r (causal) or c >= S_k (key padding)
//   out[i]  = softmax(s[i]) @ v                         f32 softmax, P in bf16,
//                                                       f32 accumulation
//   lse[i]  = log sum_c exp(s[i, c])                    read by the backward
// K1 runs it with q_offset 0 and S_k = S_q; K5 with a q shard at q_offset
// against K/V of any length S_k.
//
// Blocking: a work item is one (b, h, 128-row q tile). The grid is
// persistent (one block an SM), and a block's producer takes its next item
// from a counter the grid shares (`next_item`) once it has issued the loads
// of the current one, and hands it to the consumers through shared memory
// beside the item's Q slot. Items come in groups of GROUP (b, h) pairs, the
// q tiles with the most K/V tiles first within a group: the blocks in
// flight then stream the K/V of a few heads, which L2 holds (in the order
// of (b, h) pairs within a q tile, the 132 blocks in flight at S 4096 stream
// 132 heads' K/V, 264 MB, past the 50 MB L2; the counter keeps the blocks
// level where items differ in length). Where every item has one K/V tile
// (MULTI false: K1 at S 128, one q tile a head) the items are of one length
// and in (b, h) order, and block i takes items i, i + grid, ... instead.
//
// A block is two consumer warpgroups of 64 q rows each (setmaxnreg 232) and
// a producer warpgroup (40; one warp and no setmaxnreg where every item has
// one K/V tile) one lane of which issues every load by TMA: the
// item's Q tile into one of two slots, then its K and V tiles of 128 keys
// into a ring of two stages, each of K and V with its own full and empty
// barriers. The producer runs ahead across items, so at S 128 the next
// item's Q, K and V stream in while this one computes. Causally dead K/V
// tiles are never loaded; rows past S_q and S_k come in as zeros (the 4-D
// tensor map stops at S, so no row of the next batch is read). A warpgroup
// computes every tile of its item (a tile past its own last row is all
// masked and adds exactly nothing), and every consumer warp arrives on the
// empty barriers.
//
// Products: S = Q K^T is an SS wgmma m64n128k16 (Q and K both K-major along
// Dh, each a pair of 64-column boxes with the 128-byte swizzle). O += P V
// is an RS wgmma: P comes straight from the score registers (the f32
// accumulator layout of m64n128 packed to bf16 pairs is the A-register
// layout of m64k16), V is read from shared memory as an MN-major B
// through the transpose bit. The two overlap within a warpgroup: for key
// tile j it issues S_j = Q K_j^T and then O += P_{j-1} V_{j-1}, takes the
// softmax of S_j while the P V product runs on the tensor cores, and only
// then rescales O and packs P_j. The numerics do not depend on that order:
// the same scale, bias and masks, the unnormalised P rounded to bf16, O
// rescaled before each P V, the division by the row sum at the end.
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
// threads a block: two consumer warpgroups and a producer warpgroup; where
// every item has one K/V tile (MULTI false) a producer warp, and no
// setmaxnreg (the single-tile path fits the 224 registers of 288 threads)
constexpr int threads(bool multi) { return multi ? 3 * 128 : 2 * 128 + 32; }
// every consumer warp arrives on the empty barriers (lane 0 of each)
constexpr int CONSUMER_WARPS = 8;
// (b, h) pairs an item group: the blocks in flight share a few heads' K/V
constexpr int GROUP = 4;
constexpr int N_BARS = 2 * Q_SLOTS + 4 * KV_STAGES;
constexpr int BARS = (Q_SLOTS + 2 * KV_STAGES) * TILE_BYTES;
constexpr int ITEMS = BARS + N_BARS * 8;        // the item of each Q slot
constexpr int SMEM = ITEMS + Q_SLOTS * 4 + 1024;

struct Args {
  const float* gate2;
  const int* video_start;
  bf16* out;
  float* lse;                 // (B, H, S_q)
  unsigned int* sched;        // [2]: the next shared item, the blocks done
                              // (the caller's stream's, zero between launches)
  int B, S_q, S_k, q_offset, H, max_feats;
  long long osb, oss, osh;    // out strides (batch, sequence, head)
  float scale;
};

struct Bars {
  uint64_t* full_q;           // [Q_SLOTS]
  uint64_t* empty_q;
  uint64_t* full_k;           // [KV_STAGES]
  uint64_t* full_v;
  uint64_t* empty_k;
  uint64_t* empty_v;
};

__device__ __forceinline__ int n_qtiles(const Args& a) {
  return (a.S_q + BQ - 1) / BQ;
}

// The producer's n-th item: the block's own index first, then the next of
// the counter the grid shares, so that a block takes an item when it is
// ready for one; -1 past the last. A block counts itself done when it runs
// past the last item, and the last one done resets the counter for the
// next launch. The counter is the caller's stream's (the wrappers keep one
// per stream, model/kernels/flash_attention.py): launches on one stream
// run one after the other, and two launches in flight on two streams take
// two counters, so neither takes the other's items.
__device__ __forceinline__ int next_item(const Args& a, int n, int items) {
  const int item = n == 0 ? static_cast<int>(blockIdx.x)
                          : static_cast<int>(gridDim.x +
                                             atomicAdd(&a.sched[0], 1u));
  if (item < items) return item;
  if (atomicAdd(&a.sched[1], 1u) == gridDim.x - 1) {
    atomicExch(&a.sched[0], 0u);
    atomicExch(&a.sched[1], 0u);
  }
  return -1;
}

// item -> (q tile, head, batch): items come in groups of GROUP (b, h) pairs
// (the last group may hold fewer), and within a group by rank, each rank
// over the group's pairs: rank 0, the q tile with the most K/V tiles, first
__device__ __forceinline__ void decode(const Args& a, int item, int& qt,
                                       int& h, int& b) {
  const int tiles = n_qtiles(a);
  const int bh_n = a.H * a.B;
  const int grp = item / (GROUP * tiles);
  const int rest = item - grp * GROUP * tiles;
  const int size = min(GROUP, bh_n - grp * GROUP);
  const int bh = grp * GROUP + rest % size;
  qt = tiles - 1 - rest / size;
  h = bh % a.H;
  b = bh / a.H;
}

// K/V tiles of q tile qt: keys past its last global row are causally dead
__device__ __forceinline__ int kv_tiles(const Args& a, int qt) {
  const int kv_end = min(a.S_k, a.q_offset + (qt + 1) * BQ);
  return (kv_end + BKV - 1) / BKV;
}

template <bool MULTI>
__device__ __forceinline__ void producer(uint8_t* smem, const Bars& bar,
                                         const CUtensorMap* q_map,
                                         const CUtensorMap* k_map,
                                         const CUtensorMap* v_map,
                                         const Args& a, int items) {
  int* item_slot = reinterpret_cast<int*>(smem + ITEMS);
  int nkv = 0;
  for (int ni = 0;; ++ni) {
    // items of one K/V tile each are of one length: a fixed stride of the
    // grid balances them, and the counter's atomics would buy nothing
    const int fixed = static_cast<int>(blockIdx.x + ni * gridDim.x);
    const int item = MULTI ? next_item(a, ni, items)
                           : (fixed < items ? fixed : -1);
    const int slot = ni % Q_SLOTS;
    // the consumers have read the slot's item once they release its Q
    if (ni >= Q_SLOTS) {
      hopper::mbar_wait(&bar.empty_q[slot], (ni / Q_SLOTS - 1) & 1);
    }
    item_slot[slot] = item;
    if (item < 0) {                   // the consumers stop
      hopper::mbar_arrive(&bar.full_q[slot]);
      break;
    }
    int qt, h, b;
    decode(a, item, qt, h, b);
    uint8_t* qs = smem + slot * TILE_BYTES;
    hopper::mbar_arrive_expect_tx(&bar.full_q[slot], TILE_BYTES);
    hopper::tma_load_4d(qs, q_map, &bar.full_q[slot], 0, h, qt * BQ, b);
    hopper::tma_load_4d(qs + BOX_BYTES, q_map, &bar.full_q[slot], BOX, h,
                        qt * BQ, b);
    const int n_kt = kv_tiles(a, qt);
    for (int j = 0; j < n_kt; ++j, ++nkv) {
      const int s = nkv % KV_STAGES;
      const uint32_t par = (nkv / KV_STAGES - 1) & 1;
      uint8_t* ks = smem + (Q_SLOTS + s) * TILE_BYTES;
      uint8_t* vs = smem + (Q_SLOTS + KV_STAGES + s) * TILE_BYTES;
      if (nkv >= KV_STAGES) hopper::mbar_wait(&bar.empty_k[s], par);
      hopper::mbar_arrive_expect_tx(&bar.full_k[s], TILE_BYTES);
      hopper::tma_load_4d(ks, k_map, &bar.full_k[s], 0, h, j * BKV, b);
      hopper::tma_load_4d(ks + BOX_BYTES, k_map, &bar.full_k[s], BOX, h,
                          j * BKV, b);
      if (nkv >= KV_STAGES) hopper::mbar_wait(&bar.empty_v[s], par);
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

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) hopper::fence_operand(r[i]);
}

// The softmax step of key tile k0 on a warpgroup's scores, in place: scale,
// gate2 video block, causal + key-padding mask, the new row maxima m (rows
// r0 = 16w + g and r1 = r0 + 8 of the warpgroup, global rows gr0 and gr1),
// then sc = exp(s - m), the unnormalised P in f32. Returns the factors that
// rescale the old sums (alpha) and the tile's row sums of this thread (rs).
// sc[4i + e] is (row r0, key k0 + 8i + 2t + e), sc[4i + 2 + e] row r1.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&alpha)[2],
                                             float (&rs)[2], const Args& a,
                                             int k0, int wg_row, int gr0,
                                             int vs, float g2, int t) {
  const int max_feats = a.max_feats;
  const float scale = a.scale;
  const bool edge = (vs >= 0 && k0 < vs + max_feats && k0 + BKV > vs) ||
                    k0 + BKV - 1 > a.q_offset + wg_row || k0 + BKV > a.S_k;
  float mx[2] = {m[0], m[1]};
  if (edge) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int row = gr0 + ((i & 2) ? 8 : 0);
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
  // Key 0 lies in the first tile and is visible to every row, so mx is a
  // finite score from the first tile on; exp(-inf) = 0 clears the empty
  // initial state.
  alpha[0] = __expf(m[0] - mx[0]);
  alpha[1] = __expf(m[1] - mx[1]);
  m[0] = mx[0];
  m[1] = mx[1];
  rs[0] = rs[1] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    sc[4 * i] = __expf(sc[4 * i] - m[0]);
    sc[4 * i + 1] = __expf(sc[4 * i + 1] - m[0]);
    sc[4 * i + 2] = __expf(sc[4 * i + 2] - m[1]);
    sc[4 * i + 3] = __expf(sc[4 * i + 3] - m[1]);
    rs[0] += sc[4 * i] + sc[4 * i + 1];
    rs[1] += sc[4 * i + 2] + sc[4 * i + 3];
  }
}

// keys 16kk + 2t (i = 2kk) and 16kk + 8 + 2t (i = 2kk + 1) of the f32 P:
// the bf16 A fragment registers of P V's step kk
__device__ __forceinline__ void pack_p(uint32_t (&p)[8][4],
                                       const float (&sc)[64]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    p[i >> 1][2 * (i & 1)] = flash::pack_f32(sc[4 * i], sc[4 * i + 1]);
    p[i >> 1][2 * (i & 1) + 1] = flash::pack_f32(sc[4 * i + 2], sc[4 * i + 3]);
  }
}

// o *= alpha row by row: o[4i + e] is row r0, o[4i + 2 + e] row r1
__device__ __forceinline__ void rescale(float (&o)[64],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    o[4 * i] *= alpha[0];
    o[4 * i + 1] *= alpha[0];
    o[4 * i + 2] *= alpha[1];
    o[4 * i + 3] *= alpha[1];
  }
}

// The consumer warpgroups: every item of the block in turn. Key tile 0
// runs alone (S_0, its softmax, P_0); each later tile j issues S_j,
// rescales O by tile j - 1's factors, issues O += P_{j-1} V_{j-1}, takes
// S_j's softmax while P V runs, then packs P_j; the item ends with its last
// P V. MULTI false compiles the loop over later tiles out, for calls whose
// items have one K/V tile each (S_k <= BKV: K1 at S 128), which then keep
// the single-tile path's registers to themselves.
template <bool MULTI>
__device__ __forceinline__ void consume(uint8_t* smem, const Bars& bar,
                                        const Args& a) {
  const int wg = threadIdx.x / 128;
  const int w = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int* item_slot = reinterpret_cast<const int*>(smem + ITEMS);
  uint64_t* full_q = bar.full_q;
  uint64_t* full_k = bar.full_k;
  uint64_t* full_v = bar.full_v;

  float sc[64], o[64];
  uint32_t p[8][4];
  int nkv = 0;
  for (int ni = 0;; ++ni) {
    const int slot = ni % Q_SLOTS;
    hopper::mbar_wait(&full_q[slot], (ni / Q_SLOTS) & 1);
    const int item = item_slot[slot];
    if (item < 0) break;
    int qt, h, b;
    decode(a, item, qt, h, b);
    const uint8_t* q_rows = smem + slot * TILE_BYTES + wg * 64 * 128;
    const int vs = a.video_start[b];
    const float g2 = a.gate2[h];
    const int wg_row = qt * BQ + 64 * wg;           // local, first row
    const int r0 = wg_row + 16 * w + g;             // the thread's rows
    const int r1 = r0 + 8;
    const int gr0 = a.q_offset + r0;
    const int n_kt = kv_tiles(a, qt);

    float m[2] = {-INFINITY, -INFINITY};  // running row max (rows r0, r1)
    float l[2];                           // this thread's share of the sum
    float alpha[2], rs[2];
    {                                     // key tile 0
      const int s = nkv % KV_STAGES;
      hopper::mbar_wait(&full_k[s], (nkv / KV_STAGES) & 1);
      qk(sc, q_rows, smem + (Q_SLOTS + s) * TILE_BYTES);
      hopper::wgmma_wait<0>();
      fence_all(sc);
      if (lane == 0) {
        hopper::mbar_arrive(&bar.empty_k[s]);
        // the item's last Q K^T: its Q slot goes back to the producer
        if (n_kt == 1) hopper::mbar_arrive(&bar.empty_q[slot]);
      }
      softmax_tile(sc, m, alpha, rs, a, 0, wg_row, gr0, vs, g2, t);
      l[0] = rs[0];
      l[1] = rs[1];
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.f;
      pack_p(p, sc);
      ++nkv;
    }
    for (int j = 1; MULTI && j < n_kt; ++j, ++nkv) {
      const int s = nkv % KV_STAGES;
      const int sp = (nkv - 1) % KV_STAGES;        // tile j - 1's stage
      hopper::mbar_wait(&full_k[s], (nkv / KV_STAGES) & 1);
      qk(sc, q_rows, smem + (Q_SLOTS + s) * TILE_BYTES);
      rescale(o, alpha);                           // by tile j - 1's max
      hopper::mbar_wait(&full_v[sp], ((nkv - 1) / KV_STAGES) & 1);
      pv(o, p, smem + (Q_SLOTS + KV_STAGES + sp) * TILE_BYTES);
      hopper::wgmma_wait<1>();                     // S_j; P V runs on
      fence_all(sc);
      if (lane == 0) {
        hopper::mbar_arrive(&bar.empty_k[s]);
        if (j == n_kt - 1) hopper::mbar_arrive(&bar.empty_q[slot]);
      }
      softmax_tile(sc, m, alpha, rs, a, j * BKV, wg_row, gr0, vs, g2, t);
      hopper::wgmma_wait<0>();                     // P_{j-1} V_{j-1}
      fence_all(o);
      if (lane == 0) hopper::mbar_arrive(&bar.empty_v[sp]);
      l[0] = l[0] * alpha[0] + rs[0];
      l[1] = l[1] * alpha[1] + rs[1];
      pack_p(p, sc);
    }
    {                                     // the item's last P V
      const int sp = (nkv - 1) % KV_STAGES;
      // (without MULTI, o is still the 0 of tile 0: nothing to rescale)
      if (MULTI) rescale(o, alpha);
      hopper::mbar_wait(&full_v[sp], ((nkv - 1) / KV_STAGES) & 1);
      pv(o, p, smem + (Q_SLOTS + KV_STAGES + sp) * TILE_BYTES);
      hopper::wgmma_wait<0>();
      fence_all(o);
      if (lane == 0) hopper::mbar_arrive(&bar.empty_v[sp]);
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

// The kernel body: threads(MULTI) threads, warps 0-7 the consumer
// warpgroups, warp 8 lane 0 the producer. MULTI false only where every
// item has one K/V tile (`multi_tile`).
template <bool MULTI>
__device__ __forceinline__ void fwd_body(const CUtensorMap* q_map,
                                         const CUtensorMap* k_map,
                                         const CUtensorMap* v_map,
                                         const Args& a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) &
                              1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BARS);
  const Bars bar{bars, bars + Q_SLOTS, bars + 2 * Q_SLOTS,
                 bars + 2 * Q_SLOTS + KV_STAGES,
                 bars + 2 * Q_SLOTS + 2 * KV_STAGES,
                 bars + 2 * Q_SLOTS + 3 * KV_STAGES};
  const int items = n_qtiles(a) * a.H * a.B;

  if (threadIdx.x == 0) {
    for (int i = 0; i < Q_SLOTS; ++i) {
      hopper::mbar_init(&bar.full_q[i], 1);
      hopper::mbar_init(&bar.empty_q[i], CONSUMER_WARPS);
    }
    for (int i = 0; i < KV_STAGES; ++i) {
      hopper::mbar_init(&bar.full_k[i], 1);
      hopper::mbar_init(&bar.full_v[i], 1);
      hopper::mbar_init(&bar.empty_k[i], CONSUMER_WARPS);
      hopper::mbar_init(&bar.empty_v[i], CONSUMER_WARPS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    if (MULTI) hopper::regs_dealloc<40>();
    if (threadIdx.x == 256) {
      producer<MULTI>(smem, bar, q_map, k_map, v_map, a, items);
    }
  } else {
    if (MULTI) hopper::regs_alloc<232>();
    consume<MULTI>(smem, bar, a);
  }
}

// Host: whether an item can have more than one K/V tile, which picks the
// kernel's MULTI instantiation
inline bool multi_tile(const Args& a) { return a.S_k > BKV; }

// Host: the launch of `kernel` (a __global__ wrapper of fwd_body taking
// the three maps and Args) on a persistent grid.
template <bool MULTI, typename Kernel>
inline cudaError_t launch(Kernel kernel, const CUtensorMap (&maps)[3],
                          const Args& a, cudaStream_t stream) {
  cudaError_t err = hopper::smem_opt_in(kernel, SMEM);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const long long items =
      static_cast<long long>((a.S_q + BQ - 1) / BQ) * a.H * a.B;
  if (items <= 0 || items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = items < sms ? static_cast<int>(items) : sms;
  kernel<<<grid, threads(MULTI), SMEM, stream>>>(maps[0], maps[1], maps[2],
                                                 a);
  return cudaGetLastError();
}

}  // namespace flashw
