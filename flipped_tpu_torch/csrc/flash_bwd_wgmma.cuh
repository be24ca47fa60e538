// The backward loops of K6a (dq) and K6b (dk, dv) on Hopper, for
// flash_stream_bwd.cu and for K2 (flash_text_bwd.cu): warp-specialised
// blocks, every operand tile fed by TMA through an mbarrier ring, every
// product on wgmma. What they compute: for q row i (local) at global
// position r = q_offset + i and key c, with the forward's saved lse and
// D = rowsum(dO * O) per row,
//   P[i, c]   = exp(s[i, c] - lse[i])       0 unless c <= r and c < S_k
//   dS[i, c]  = P[i, c] (dP[i, c] - D[i]),  dP = dO V^T, f32
//   dQ[i]     = scale sum_c bf16(dS[i, c]) K[c]
//   dK[c]     = scale sum_i bf16(dS[i, c]) Q[i]      over this shard's rows
//   dV[c]     = sum_i bf16(P[i, c]) dO[i]
//   dgate2    = sum over the video block of dS, one partial per 64 q rows
// with s the forward's scores (q k / sqrt(Dh) in f32 plus gate2 on the
// video block, flash_fwd_wgmma.cuh). Rows past S_q and keys past S_k come in
// as zeros (the 4-D tensor maps stop at S): a zero q or dO row gives dS = 0
// and adds nothing to dk or dv, so only keys past S_k need a mask. The loops
// keep q_offset, S_q and S_k general (K2 is their S_q = S_k, q_offset 0
// case).
//
// Blocks: THREADS threads, warps 0-7 two consumer warpgroups (setmaxnreg
// 232) and warps 8-11 a producer warpgroup (setmaxnreg 40) whose warp 8
// issues the loads; one persistent block an SM, whose producer takes the
// block's next item from a counter the grid shares (`next_item`) when it
// has issued the loads of the current one, and hands it to the consumers
// through shared memory. Items come in groups of GROUP (b, h) pairs, the
// longest first within a group: the blocks in flight share the operands
// they stream, which then come from L2 instead of HBM (in the order of
// (b, h) pairs within a length, 132 blocks stream 132 pairs' K/V, 264 MB
// at S 4096, past the 50 MB L2), and taking items as blocks free up keeps
// the blocks level (a fixed stride of the grid over such groups does not:
// each block then gets a run of neighbouring ranks, long or short).
//
//   dq_body (K6a): an item is one (b, h, 128-row q tile), 64 rows a
//     consumer warpgroup. The producer loads the item's Q and dO, then its
//     K/V tiles of DQ_BKV keys into a ring of DQ_STAGES stages, K and V on
//     barriers of their own. Per key tile S = Q K^T and dP = dO V^T are SS
//     wgmmas (all four operands K-major along Dh, 128-byte swizzle); P and
//     dS stay in registers; dQ += dS K is an RS wgmma with dS packed from
//     the accumulator layout and K read MN-major through the transpose
//     bit. lse and D of a thread's two rows are read once an item (with
//     OWN_D, K2's, D is summed from the item's dO and O, which TMA brings
//     beside Q and dO, and written out for dkv_body). A
//     warpgroup skips the key tiles past its own last row, so a row meets
//     the same key tiles, in the same order and with the same masks, where
//     ever its q tile starts: a shard's dq equals the full run's rows.
//   dkv_body (K6b): an item is one (b, h, 128-key tile), 64 keys a consumer
//     warpgroup, K and V resident for the item (in one of KV_SLOTS
//     buffers). The loop walks 64-row q steps from the first row that sees
//     the tile to S_q; the producer brings each step's Q and dO by TMA and
//     its lse and D by plain loads (their rows are S_q * 4 bytes apart, not
//     always the 16 bytes TMA needs) into a ring of STAGES stages. S^T =
//     K Q^T and dP^T = V dO^T are SS wgmmas m64n64k16; dV += P^T dO and
//     dK += dS^T Q are RS wgmmas with P^T and dS^T from registers and dO, Q
//     MN-major. Key tiles above every row write zeros.
// No atomics on the outputs (the only atomics are the item counter's):
// every output element and every dgate2 partial has one writer, so the
// result is the same from run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace flashbw {

typedef __nv_bfloat16 bf16;

constexpr int DH = 128;              // every LLaMA preset of the repo
constexpr int BOX = 64;              // Dh columns a TMA box: 128-byte rows
constexpr int ROW = 128;             // bytes of a box row
constexpr int WG_ROWS = 64;          // q rows (K6a) or keys (K6b) a warpgroup
constexpr int THREADS = 3 * 128;
// Every consumer warp arrives on the empty barriers, not one warp a
// warpgroup: where a warpgroup skips a tile or an item (no wgmma ties its
// warps together), a warp that trails the others would otherwise let the
// producer refill a stage twice and then wait on a parity that has come
// round again.
constexpr int CONSUMER_WARPS = 8;
// (b, h) pairs an item group: the items in flight on the card's 132 SMs
// share the K/V (K6a) or Q/dO (K6b) of a few heads, which L2 then holds
constexpr int GROUP = 4;

// bytes of `rows` rows x Dh, as two boxes of 64 columns
__host__ __device__ constexpr int tile_bytes(int rows) {
  return 2 * rows * ROW;
}

// K6a
constexpr int DQ_BQ = 128;           // q rows an item
constexpr int DQ_BKV = 128;          // keys a K/V tile
constexpr int DQ_STAGES = 2;
constexpr int DQ_Q = 0;                                   // Q, then dO
constexpr int DQ_K = 2 * tile_bytes(DQ_BQ);               // K stages
constexpr int DQ_V = DQ_K + DQ_STAGES * tile_bytes(DQ_BKV);
constexpr int DQ_BARS = DQ_V + DQ_STAGES * tile_bytes(DQ_BKV);
constexpr int DQ_N_BARS = 2 + 3 * DQ_STAGES;
constexpr int DQ_RED = DQ_BARS + DQ_N_BARS * 8;           // 2 x 8 floats
constexpr int DQ_ITEM = DQ_RED + 16 * 4;                  // the item
constexpr int DQ_SMEM = DQ_ITEM + 16 + 1024;
// dq_body<true> (K2): the item's rows of the forward's output O, after the
// rest, 1024-byte aligned for the 128-byte swizzle
constexpr int DQ_O = (DQ_ITEM + 16 + 1023) / 1024 * 1024;
constexpr int DQ_SMEM_OWN_D = DQ_O + tile_bytes(DQ_BQ) + 1024;

// K6b
constexpr int DKV_BK = 128;          // keys an item
constexpr int DKV_BQ = 64;           // q rows a step
constexpr int DKV_STAGE = 2 * tile_bytes(DKV_BQ);         // a step: Q, dO
// dkv_body's shared memory with KV_SLOTS buffers of an item's K and V and
// STAGES stages of q steps. K6 takes 1 and 4: K and V stay resident while
// an item's many steps run. K2 (S <= 2048, two steps an item at S 128)
// takes 2 and 2: the next item's K and V load while this one's steps run.
template <int KV_SLOTS, int STAGES>
struct Dkv {
  static constexpr int KV = 2 * tile_bytes(DKV_BK);        // a slot: K, V
  static constexpr int Q = KV_SLOTS * KV;                  // the stages
  static constexpr int STATS = Q + STAGES * DKV_STAGE;     // lse, D a stage
  static constexpr int BARS = STATS + STAGES * 2 * DKV_BQ * 4;
  static constexpr int N_BARS = 2 * KV_SLOTS + 2 * STAGES;
  static constexpr int ITEM = BARS + N_BARS * 8;           // a slot's item
  static constexpr int SMEM = ITEM + 4 * KV_SLOTS + 1024;
};

struct Args {
  const float* lse;          // (B, H, S_q)
  float* delta;              // (B, H, S_q): read, or written by dq_body<true>
  const float* gate2;        // (H,)
  const int* video_start;    // (B,)
  bf16* dq;                  // (B, S_q, H, Dh)
  float* dg2_part;           // (B, H, ceil(S_q / 64))
  bf16* dk;                  // (B, S_k, H, Dh)
  bf16* dv;
  unsigned int* sched;       // [2]: the next shared item, the blocks done
  int B, S_q, S_k, q_offset, H, max_feats;
  float scale;
};

// ---------------------------------------------------------------------------
// Products
// ---------------------------------------------------------------------------
template <bool ZERO>
__device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b) {
  if (ZERO) {
    hopper::wgmma_m64n64k16_bf16_ss_zero(d, a, b);
  } else {
    hopper::wgmma_m64n64k16_bf16_ss(d, a, b);
  }
}
template <bool ZERO>
__device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b) {
  if (ZERO) {
    hopper::wgmma_m64n128k16_bf16_ss_zero(d, a, b);
  } else {
    hopper::wgmma_m64n128k16_bf16_ss(d, a, b);
  }
}

// d = A B^T over Dh (8 steps of 16, 4 in each 64-column box; the first
// writes d): A the warpgroup's 64 rows at `a` (its second box `a_box` bytes
// on), B the N rows at `b` (second box `b_box` bytes on). Issued, not
// committed.
template <int NACC>
__device__ __forceinline__ void ss_dh(float (&d)[NACC], const uint8_t* a,
                                      int a_box, const uint8_t* b,
                                      int b_box) {
  const uint64_t da0 = hopper::desc_sw128(a);
  const uint64_t da1 = hopper::desc_sw128(a + a_box);
  const uint64_t db0 = hopper::desc_sw128(b);
  const uint64_t db1 = hopper::desc_sw128(b + b_box);
  ss<true>(d, da0, db0);
#pragma unroll
  for (int ks = 1; ks < 4; ++ks) ss<false>(d, da0 + 2 * ks, db0 + 2 * ks);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) ss<false>(d, da1 + 2 * ks, db1 + 2 * ks);
}

// d += A B over `STEPS` 16-deep steps: A from registers, B the MN-major
// tile at `b` (16 rows of the contraction = 2048 bytes a step; its two
// 64-column boxes `b_box` bytes apart). Issued, not committed.
template <int STEPS>
__device__ __forceinline__ void rs_mn(float (&d)[64],
                                      const uint32_t (&a)[STEPS][4],
                                      const uint8_t* b, int b_box) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    hopper::wgmma_m64n128k16_bf16_rs_tb(
        d, a[kk], hopper::desc_sw128_mn(b + kk * 2048, b_box));
  }
}

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) hopper::fence_operand(r[i]);
}

// x[4i + e] at (row g, column 8i + 2t + e), x[4i + 2 + e] at row g + 8:
// packed to bf16 pairs this is the A fragment of 16-column step i / 2
template <int NACC>
__device__ __forceinline__ void pack_a(uint32_t (&p)[NACC / 8][4],
                                       const float (&x)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC / 4; ++i) {
    p[i >> 1][2 * (i & 1)] = flash::pack_f32(x[4 * i], x[4 * i + 1]);
    p[i >> 1][2 * (i & 1) + 1] = flash::pack_f32(x[4 * i + 2], x[4 * i + 3]);
  }
}

// 64 rows of `acc` (row r0 = its thread's, r1 = r0 + 8) times `mul`, as
// bf16, at `base` + row * rs: each quad transposes the pairs of 32 columns
// at a time for one 16-byte store a lane (the rows are 16-byte aligned).
__device__ __forceinline__ void store_rows(const float (&acc)[64], float mul,
                                           bf16* base, long long rs, int r0,
                                           int r1, int n_rows, int t) {
#pragma unroll
  for (int j = 0; j < DH / 32; ++j) {
    uint32_t v0[4], v1[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * j + q;
      v0[q] = flash::pack_f32(acc[4 * i] * mul, acc[4 * i + 1] * mul);
      v1[q] = flash::pack_f32(acc[4 * i + 2] * mul, acc[4 * i + 3] * mul);
    }
    const uint4 w0 = hopper::quad_transpose(v0, t);
    const uint4 w1 = hopper::quad_transpose(v1, t);
    const int c = 8 * (4 * j + t);
    if (r0 < n_rows) *reinterpret_cast<uint4*>(base + r0 * rs + c) = w0;
    if (r1 < n_rows) *reinterpret_cast<uint4*>(base + r1 * rs + c) = w1;
  }
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (hopper::smem_addr(raw) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// K6a: dq and the dgate2 partials
// ---------------------------------------------------------------------------
__device__ __forceinline__ int dq_qtiles(const Args& a) {
  return (a.S_q + DQ_BQ - 1) / DQ_BQ;
}

// The producer's n-th item: the block's own index first, then the next of
// a counter the grid shares, so that a block takes an item when it is
// ready for one (greedy, longest first); -1 past the last. A block counts
// itself done when it runs past the last item, and the last one done
// resets the counter for the next launch. The counter is the caller's
// stream's, as in the forward (flash_fwd_wgmma.cuh `next_item`).
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

// item -> (rank, head, batch): items come in groups of GROUP (b, h) pairs
// (the last group may hold fewer), and within a group by rank, each rank
// over the group's pairs: rank 0, the longest loop, first
__device__ __forceinline__ void decode(const Args& a, int item, int tiles,
                                       int& rank, int& h, int& b) {
  const int bh_n = a.H * a.B;
  const int grp = item / (GROUP * tiles);
  const int in = item - grp * GROUP * tiles;
  const int size = min(GROUP, bh_n - grp * GROUP);
  rank = in / size;
  const int bh = grp * GROUP + in % size;
  h = bh % a.H;
  b = bh / a.H;
}

// item -> (q tile, head, batch), the q tiles with the most key tiles first
__device__ __forceinline__ void dq_decode(const Args& a, int item, int& qt,
                                          int& h, int& b) {
  int rank;
  decode(a, item, dq_qtiles(a), rank, h, b);
  qt = dq_qtiles(a) - 1 - rank;
}

// key tiles of q tile qt: keys past its last global row are causally dead
__device__ __forceinline__ int dq_kv_tiles(const Args& a, int qt) {
  const int kv_end = min(a.S_k, a.q_offset + (qt + 1) * DQ_BQ);
  return (kv_end + DQ_BKV - 1) / DQ_BKV;
}

struct DqBars {
  uint64_t* full_q;     // Q and dO of the item
  uint64_t* empty_q;
  uint64_t* full_k;     // [DQ_STAGES]
  uint64_t* full_v;
  uint64_t* empty_kv;
};

template <bool OWN_D>
__device__ __forceinline__ void dq_produce(uint8_t* smem, const DqBars& bar,
                                           const CUtensorMap* q_map,
                                           const CUtensorMap* do_map,
                                           const CUtensorMap* k_map,
                                           const CUtensorMap* v_map,
                                           const CUtensorMap* o_map,
                                           const Args& a, int items) {
  constexpr int QB = tile_bytes(DQ_BQ) / 2;     // one box of Q
  constexpr int KB = tile_bytes(DQ_BKV) / 2;    // one box of K
  int* item_slot = reinterpret_cast<int*>(smem + DQ_ITEM);
  int nkv = 0;
  for (int ni = 0;; ++ni) {
    const int item = next_item(a, ni, items);
    // the consumers have read the slot once they release the item's Q
    if (ni > 0) hopper::mbar_wait(bar.empty_q, (ni - 1) & 1);
    *item_slot = item;
    if (item < 0) {                   // the consumers stop
      hopper::mbar_arrive(bar.full_q);
      break;
    }
    int qt, h, b;
    dq_decode(a, item, qt, h, b);
    uint8_t* qs = smem + DQ_Q;
    uint8_t* dos = qs + tile_bytes(DQ_BQ);
    hopper::mbar_arrive_expect_tx(bar.full_q,
                                  (OWN_D ? 3 : 2) * tile_bytes(DQ_BQ));
    for (int x = 0; x < 2; ++x) {
      hopper::tma_load_4d(qs + x * QB, q_map, bar.full_q, x * BOX, h,
                          qt * DQ_BQ, b);
      hopper::tma_load_4d(dos + x * QB, do_map, bar.full_q, x * BOX, h,
                          qt * DQ_BQ, b);
      if (OWN_D) {
        hopper::tma_load_4d(smem + DQ_O + x * QB, o_map, bar.full_q,
                            x * BOX, h, qt * DQ_BQ, b);
      }
    }
    const int n_kt = dq_kv_tiles(a, qt);
    for (int j = 0; j < n_kt; ++j, ++nkv) {
      const int s = nkv % DQ_STAGES;
      if (nkv >= DQ_STAGES) {
        hopper::mbar_wait(&bar.empty_kv[s], (nkv / DQ_STAGES - 1) & 1);
      }
      uint8_t* ks = smem + DQ_K + s * tile_bytes(DQ_BKV);
      uint8_t* vs = smem + DQ_V + s * tile_bytes(DQ_BKV);
      hopper::mbar_arrive_expect_tx(&bar.full_k[s], tile_bytes(DQ_BKV));
      for (int x = 0; x < 2; ++x) {
        hopper::tma_load_4d(ks + x * KB, k_map, &bar.full_k[s], x * BOX, h,
                            j * DQ_BKV, b);
      }
      hopper::mbar_arrive_expect_tx(&bar.full_v[s], tile_bytes(DQ_BKV));
      for (int x = 0; x < 2; ++x) {
        hopper::tma_load_4d(vs + x * KB, v_map, &bar.full_v[s], x * BOX, h,
                            j * DQ_BKV, b);
      }
    }
  }
}

// D = rowsum(dO * O) of the thread's rows 16w + g and 16w + g + 8 of a
// warpgroup's 64 (at do_rows and o_rows, each two 64-column boxes `box`
// bytes apart, written by TMA with the 128-byte swizzle: the 16-byte chunk
// c of row r sits at chunk c ^ (r % 8)). The thread sums chunks 2t and
// 2t + 1 of both boxes in f32, its quad the rest; every lane of the quad
// returns the rows' sums.
__device__ __forceinline__ void row_dots(float& d0, float& d1,
                                         const uint8_t* do_rows,
                                         const uint8_t* o_rows, int box,
                                         int w, int g, int t) {
  float d[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * w + g + 8 * r;
    float acc = 0.f;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int off = x * box + row * ROW + (((2 * t + k) ^ (row & 7)) << 4);
        const uint4 dv = *reinterpret_cast<const uint4*>(do_rows + off);
        const uint4 ov = *reinterpret_cast<const uint4*>(o_rows + off);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 u = __bfloat1622float2(d2[e]);
          const float2 v = __bfloat1622float2(o2[e]);
          acc += u.x * v.x + u.y * v.y;
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    d[r] = acc;
  }
  d0 = d[0];
  d1 = d[1];
}

// The consumer warpgroups of K6a: every item of the block in turn. With
// OWN_D (K2) the row statistic D comes from the item's dO and O in shared
// memory, summed before the first key tile (between a product's issue and
// its wait, ptxas serialises the products: C7520), and is written out for
// the dk/dv pass; otherwise it is read from a.delta.
template <bool OWN_D>
__device__ __forceinline__ void dq_consume(uint8_t* smem, const DqBars& bar,
                                           const Args& a) {
  constexpr int NACC = DQ_BKV / 2;              // S and dP floats a thread
  constexpr int QB = tile_bytes(DQ_BQ) / 2;
  constexpr int KB = tile_bytes(DQ_BKV) / 2;
  const int wg = threadIdx.x / 128;
  const int w = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool leader = threadIdx.x % 128 == 0;
  const int S_q = a.S_q;
  const int S_k = a.S_k;
  const int max_feats = a.max_feats;
  const float scale = a.scale;
  const long long rs = static_cast<long long>(a.H) * DH;
  const int n64 = (S_q + WG_ROWS - 1) / WG_ROWS;
  float* red = reinterpret_cast<float*>(smem + DQ_RED);
  const int* item_slot = reinterpret_cast<const int*>(smem + DQ_ITEM);

  float sc[NACC], dp[NACC], acc[64];
  int nkv = 0;
  for (int ni = 0;; ++ni) {
    hopper::mbar_wait(bar.full_q, ni & 1);
    const int item = *item_slot;
    if (item < 0) break;
    int qt, h, b;
    dq_decode(a, item, qt, h, b);
    const int vs = a.video_start[b];
    const float g2 = a.gate2[h];
    const int wg_row = qt * DQ_BQ + WG_ROWS * wg;    // local, first row
    const int r0 = wg_row + 16 * w + g;              // the thread's rows
    const int r1 = r0 + 8;
    const int gr0 = a.q_offset + r0;
    const int gr1 = gr0 + 8;
    const long long bh = static_cast<long long>(b) * a.H + h;
    // rows past S_q: lse = D = 0 keeps P finite, and dS = P (0 - 0) = 0
    const float lse0 = r0 < S_q ? a.lse[bh * S_q + r0] : 0.f;
    const float lse1 = r1 < S_q ? a.lse[bh * S_q + r1] : 0.f;
    float d0 = 0.f, d1 = 0.f;
    if (!OWN_D) {
      d0 = r0 < S_q ? a.delta[bh * S_q + r0] : 0.f;
      d1 = r1 < S_q ? a.delta[bh * S_q + r1] : 0.f;
    }
    const uint8_t* q_rows = smem + DQ_Q + wg * WG_ROWS * ROW;
    const uint8_t* do_rows = q_rows + tile_bytes(DQ_BQ);
    const int n_kt = dq_kv_tiles(a, qt);
    // the warpgroup's key tiles: up to the one that holds its last row's
    // key, none if its rows are all past S_q
    const int last_j = wg_row < S_q
        ? min(n_kt - 1, (a.q_offset + wg_row + WG_ROWS - 1) / DQ_BKV)
        : -1;
    if (OWN_D && last_j >= 0) {   // D of the warpgroup's rows, once an item
      row_dots(d0, d1, do_rows, smem + DQ_O + wg * WG_ROWS * ROW, QB, w, g,
               t);
      if (t == 0) {
        if (r0 < S_q) a.delta[bh * S_q + r0] = d0;
        if (r1 < S_q) a.delta[bh * S_q + r1] = d1;
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float dg2 = 0.f;

    for (int j = 0; j < n_kt; ++j, ++nkv) {
      const int s = nkv % DQ_STAGES;
      const uint32_t par = (nkv / DQ_STAGES) & 1;
      const uint8_t* k_tile = smem + DQ_K + s * tile_bytes(DQ_BKV);
      const uint8_t* v_tile = smem + DQ_V + s * tile_bytes(DQ_BKV);
      // a skipped tile is waited for too: the empty arrival below must not
      // count toward the stage's previous round
      hopper::mbar_wait(&bar.full_k[s], par);
      if (j <= last_j) {
        hopper::wgmma_fence();
        ss_dh(sc, q_rows, QB, k_tile, KB);
        hopper::wgmma_commit();
        hopper::mbar_wait(&bar.full_v[s], par);
        ss_dh(dp, do_rows, QB, v_tile, KB);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        fence_all(sc);
        fence_all(dp);
        // the warpgroup's last read of Q and dO for this item
        if (j == last_j && lane == 0) hopper::mbar_arrive(bar.empty_q);

        // sc[4i + e] is (row r0, key k0 + 8i + 2t + e), sc[4i + 2 + e]
        // row r1. dS goes into dp.
        const int k0 = j * DQ_BKV;
        const bool edge =
            (vs >= 0 && k0 < vs + max_feats && k0 + DQ_BKV > vs) ||
            k0 + DQ_BKV - 1 > a.q_offset + wg_row || k0 + DQ_BKV > S_k;
        if (edge) {
#pragma unroll
          for (int i = 0; i < NACC; ++i) {
            const bool hi = (i >> 1) & 1;
            const int row = hi ? gr1 : gr0;
            const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            const bool blk = flash::in_video_block(row, col, vs, max_feats);
            float x = __fmul_rn(sc[i], scale);
            if (blk) x += g2;
            const float p = col <= row && col < S_k
                ? __expf(x - (hi ? lse1 : lse0)) : 0.f;
            const float ds = p * (dp[i] - (hi ? d1 : d0));
            if (blk) dg2 += ds;
            dp[i] = ds;
          }
        } else {
#pragma unroll
          for (int i = 0; i < NACC; ++i) {
            const bool hi = (i >> 1) & 1;
            const float p = __expf(__fmul_rn(sc[i], scale) -
                                   (hi ? lse1 : lse0));
            dp[i] = p * (dp[i] - (hi ? d1 : d0));
          }
        }
        uint32_t ds_a[DQ_BKV / 16][4];
        pack_a(ds_a, dp);
        fence_all(acc);
        hopper::wgmma_fence();
        rs_mn(acc, ds_a, k_tile, KB);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        fence_all(acc);
      }
      if (lane == 0) hopper::mbar_arrive(&bar.empty_kv[s]);
    }
    if (last_j < 0 && lane == 0) hopper::mbar_arrive(bar.empty_q);

    bf16* dqb = a.dq + static_cast<long long>(b) * S_q * rs + h * DH;
    store_rows(acc, scale, dqb, rs, r0, r1, S_q, t);
    // the warpgroup's dgate2 partial: its 64 rows are partial wg_row / 64
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      dg2 += __shfl_xor_sync(0xffffffffu, dg2, off);
    }
    float* red_i = red + (ni & 1) * 8 + wg * 4;   // two items apart: no race
    if (lane == 0) red_i[w] = dg2;
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (leader && wg_row < S_q) {
      a.dg2_part[bh * n64 + wg_row / WG_ROWS] =
          red_i[0] + red_i[1] + red_i[2] + red_i[3];
    }
  }
}

// OWN_D (K2): D comes from O (o_map) and dO, and is written to a.delta;
// otherwise a.delta holds it (o_map unused).
template <bool OWN_D>
__device__ __forceinline__ void dq_body(const CUtensorMap* q_map,
                                        const CUtensorMap* do_map,
                                        const CUtensorMap* k_map,
                                        const CUtensorMap* v_map,
                                        const CUtensorMap* o_map,
                                        const Args& a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + DQ_BARS);
  const DqBars bar{bars, bars + 1, bars + 2, bars + 2 + DQ_STAGES,
                   bars + 2 + 2 * DQ_STAGES};
  const int items = dq_qtiles(a) * a.H * a.B;
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar.full_q, 1);
    hopper::mbar_init(bar.empty_q, CONSUMER_WARPS);
    for (int s = 0; s < DQ_STAGES; ++s) {
      hopper::mbar_init(&bar.full_k[s], 1);
      hopper::mbar_init(&bar.full_v[s], 1);
      hopper::mbar_init(&bar.empty_kv[s], CONSUMER_WARPS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    hopper::regs_dealloc<40>();
    if (threadIdx.x == 256) {
      dq_produce<OWN_D>(smem, bar, q_map, do_map, k_map, v_map, o_map, a,
                        items);
    }
  } else {
    hopper::regs_alloc<232>();
    dq_consume<OWN_D>(smem, bar, a);
  }
}

// ---------------------------------------------------------------------------
// K6b: dk and dv
// ---------------------------------------------------------------------------
__device__ __forceinline__ int dkv_ktiles(const Args& a) {
  return (a.S_k + DKV_BK - 1) / DKV_BK;
}

// item -> (key tile, head, batch), the key tiles with the most q rows first
__device__ __forceinline__ void dkv_decode(const Args& a, int item, int& kt,
                                           int& h, int& b) {
  decode(a, item, dkv_ktiles(a), kt, h, b);
}

// The q steps of key tile kt: from the step that holds the first local row
// that sees its first key (global row k0) to S_q; none if no row does.
__device__ __forceinline__ int dkv_first_row(const Args& a, int kt) {
  const int lo = max(0, kt * DKV_BK - a.q_offset);
  return lo / DKV_BQ * DKV_BQ;
}
__device__ __forceinline__ int dkv_steps(const Args& a, int kt) {
  const int lo = max(0, kt * DKV_BK - a.q_offset);
  return lo < a.S_q ? (a.S_q - dkv_first_row(a, kt) + DKV_BQ - 1) / DKV_BQ
                    : 0;
}

struct DkvBars {
  uint64_t* full_kv;    // [KV_SLOTS]: K and V of an item
  uint64_t* empty_kv;
  uint64_t* full_q;     // [STAGES]: Q, dO, lse and D of a step
  uint64_t* empty_q;
};

// Warp 8: lane 0 takes the items and issues the TMA loads, every lane
// loads two rows of lse and D into the stage and arrives on its full
// barrier (33 arrivals a phase: lane 0's expect_tx and the 32 lanes'). An
// item with no q step (keys after every row) still passes through the K/V
// barriers, with no load, so that the consumers learn it and write zeros.
template <int KV_SLOTS, int STAGES>
__device__ __forceinline__ void dkv_produce(uint8_t* smem, const DkvBars& bar,
                                            const CUtensorMap* q_map,
                                            const CUtensorMap* do_map,
                                            const CUtensorMap* k_map,
                                            const CUtensorMap* v_map,
                                            const Args& a, int items) {
  using L = Dkv<KV_SLOTS, STAGES>;
  constexpr int KB = tile_bytes(DKV_BK) / 2;
  constexpr int QB = tile_bytes(DKV_BQ) / 2;
  const int lane = threadIdx.x % 32;
  int* item_slot = reinterpret_cast<int*>(smem + L::ITEM);
  int nq = 0;
  for (int ni = 0;; ++ni) {
    int item = lane == 0 ? next_item(a, ni, items) : 0;
    item = __shfl_sync(0xffffffffu, item, 0);
    const int slot = ni % KV_SLOTS;
    // the consumers have read the slot once they release its K/V
    if (ni >= KV_SLOTS) {
      hopper::mbar_wait(&bar.empty_kv[slot], (ni / KV_SLOTS - 1) & 1);
    }
    if (item < 0) {                   // the consumers stop
      if (lane == 0) {
        item_slot[slot] = item;
        hopper::mbar_arrive(&bar.full_kv[slot]);
      }
      break;
    }
    int kt, h, b;
    dkv_decode(a, item, kt, h, b);
    const int n_steps = dkv_steps(a, kt);
    if (lane == 0) {
      item_slot[slot] = item;
      if (n_steps == 0) {             // zeros: the item, and no load
        hopper::mbar_arrive(&bar.full_kv[slot]);
      } else {
        uint8_t* ks = smem + slot * L::KV;
        uint8_t* vs = ks + tile_bytes(DKV_BK);
        hopper::mbar_arrive_expect_tx(&bar.full_kv[slot], L::KV);
        for (int x = 0; x < 2; ++x) {
          hopper::tma_load_4d(ks + x * KB, k_map, &bar.full_kv[slot],
                              x * BOX, h, kt * DKV_BK, b);
          hopper::tma_load_4d(vs + x * KB, v_map, &bar.full_kv[slot],
                              x * BOX, h, kt * DKV_BK, b);
        }
      }
    }
    const long long bh = static_cast<long long>(b) * a.H + h;
    const float* lse_b = a.lse + bh * a.S_q;
    const float* d_b = a.delta + bh * a.S_q;
    const int q_first = dkv_first_row(a, kt);
    for (int st = 0; st < n_steps; ++st, ++nq) {
      const int s = nq % STAGES;
      const int q0 = q_first + st * DKV_BQ;
      if (nq >= STAGES) {
        hopper::mbar_wait(&bar.empty_q[s], (nq / STAGES - 1) & 1);
      }
      if (lane == 0) {
        uint8_t* qs = smem + L::Q + s * DKV_STAGE;
        uint8_t* dos = qs + tile_bytes(DKV_BQ);
        hopper::mbar_arrive_expect_tx(&bar.full_q[s], DKV_STAGE);
        for (int x = 0; x < 2; ++x) {
          hopper::tma_load_4d(qs + x * QB, q_map, &bar.full_q[s], x * BOX, h,
                              q0, b);
          hopper::tma_load_4d(dos + x * QB, do_map, &bar.full_q[s], x * BOX,
                              h, q0, b);
        }
      }
      // rows past S_q: lse = D = 0 keeps P finite; their zero Q and dO rows
      // add nothing to dk and dv
      float* stats = reinterpret_cast<float*>(smem + L::STATS) +
                     s * 2 * DKV_BQ;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * lane + e;
        const bool in = q0 + i < a.S_q;
        stats[i] = in ? lse_b[q0 + i] : 0.f;
        stats[DKV_BQ + i] = in ? d_b[q0 + i] : 0.f;
      }
      hopper::mbar_arrive(&bar.full_q[s]);
    }
  }
}

// The consumer warpgroups of K6b: every item of the block in turn.
template <int KV_SLOTS, int STAGES>
__device__ __forceinline__ void dkv_consume(uint8_t* smem, const DkvBars& bar,
                                            const Args& a) {
  using L = Dkv<KV_SLOTS, STAGES>;
  constexpr int KB = tile_bytes(DKV_BK) / 2;
  constexpr int QB = tile_bytes(DKV_BQ) / 2;
  const int wg = threadIdx.x / 128;
  const int w = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int S_k = a.S_k;
  const int max_feats = a.max_feats;
  const float scale = a.scale;
  const long long rs = static_cast<long long>(a.H) * DH;
  const int* item_slot = reinterpret_cast<const int*>(smem + L::ITEM);

  float st[32], dpt[32], dk[64], dv[64];
  int nq = 0;
  for (int ni = 0;; ++ni) {
    const int slot = ni % KV_SLOTS;
    hopper::mbar_wait(&bar.full_kv[slot], (ni / KV_SLOTS) & 1);
    const int item = item_slot[slot];
    if (item < 0) break;
    const uint8_t* k_rows = smem + slot * L::KV + wg * WG_ROWS * ROW;
    const uint8_t* v_rows = k_rows + tile_bytes(DKV_BK);
    int kt, h, b;
    dkv_decode(a, item, kt, h, b);
    const int kw0 = kt * DKV_BK + WG_ROWS * wg;   // the warpgroup's first key
    const int key0 = kw0 + 16 * w + g;            // the thread's keys
    const int key1 = key0 + 8;
    const int n_steps = dkv_steps(a, kt);
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
    if (n_steps > 0) {
      const int vs = a.video_start[b];
      const float g2 = a.gate2[h];
      const int q_first = dkv_first_row(a, kt);
      for (int step = 0; step < n_steps; ++step, ++nq) {
        const int s = nq % STAGES;
        const int q0 = q_first + step * DKV_BQ;
        const bool last = step == n_steps - 1;
        const uint8_t* q_tile = smem + L::Q + s * DKV_STAGE;
        const uint8_t* do_tile = q_tile + tile_bytes(DKV_BQ);
        const float* stats = reinterpret_cast<const float*>(
            smem + L::STATS) + s * 2 * DKV_BQ;
        // a skipped step is waited for too (see dq_consume)
        hopper::mbar_wait(&bar.full_q[s], (nq / STAGES) & 1);
        if (kw0 < S_k && a.q_offset + q0 + DKV_BQ - 1 >= kw0) {
          hopper::wgmma_fence();
          ss_dh(st, k_rows, KB, q_tile, QB);
          ss_dh(dpt, v_rows, KB, do_tile, QB);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          fence_all(st);
          fence_all(dpt);
          // the warpgroup's last read of K and V for this item
          if (last && lane == 0) hopper::mbar_arrive(&bar.empty_kv[slot]);

          // st[4i + e] is (key key0, q row q0 + 8i + 2t + e), st[4i + 2 + e]
          // key key1. P^T goes into st, dS^T into dpt.
          const bool edge =
              (vs >= 0 && kw0 < vs + max_feats && kw0 + WG_ROWS > vs) ||
              kw0 + WG_ROWS - 1 > a.q_offset + q0 || kw0 + WG_ROWS > S_k;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const float2 l = *reinterpret_cast<const float2*>(
                stats + 8 * c + 2 * t);
            const float2 d = *reinterpret_cast<const float2*>(
                stats + DKV_BQ + 8 * c + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * c + e;
              const float lse = (e & 1) ? l.y : l.x;
              float p;
              if (edge) {
                const int key = (e & 2) ? key1 : key0;
                const int row = a.q_offset + q0 + 8 * c + 2 * t + (e & 1);
                float x = __fmul_rn(st[i], scale);
                if (flash::in_video_block(row, key, vs, max_feats)) x += g2;
                p = key <= row && key < S_k ? __expf(x - lse) : 0.f;
              } else {
                p = __expf(__fmul_rn(st[i], scale) - lse);
              }
              st[i] = p;
              dpt[i] = p * (dpt[i] - ((e & 1) ? d.y : d.x));
            }
          }
          uint32_t p_a[4][4], ds_a[4][4];
          pack_a(p_a, st);
          pack_a(ds_a, dpt);
          fence_all(dv);
          fence_all(dk);
          hopper::wgmma_fence();
          rs_mn(dv, p_a, do_tile, QB);
          rs_mn(dk, ds_a, q_tile, QB);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          fence_all(dv);
          fence_all(dk);
        } else if (last && lane == 0) {
          hopper::mbar_arrive(&bar.empty_kv[slot]);
        }
        if (lane == 0) hopper::mbar_arrive(&bar.empty_q[s]);
      }
    } else if (lane == 0) {
      hopper::mbar_arrive(&bar.empty_kv[slot]);
    }
    if (kw0 < S_k) {
      const long long off = static_cast<long long>(b) * S_k * rs + h * DH;
      store_rows(dk, scale, a.dk + off, rs, key0, key1, S_k, t);
      store_rows(dv, 1.f, a.dv + off, rs, key0, key1, S_k, t);
    }
  }
}

// KV_SLOTS and STAGES: the shared-memory layout `Dkv` (K6: 1, 4; K2: 2, 2)
template <int KV_SLOTS, int STAGES>
__device__ __forceinline__ void dkv_body(const CUtensorMap* q_map,
                                         const CUtensorMap* do_map,
                                         const CUtensorMap* k_map,
                                         const CUtensorMap* v_map,
                                         const Args& a) {
  using L = Dkv<KV_SLOTS, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BARS);
  const DkvBars bar{bars, bars + KV_SLOTS, bars + 2 * KV_SLOTS,
                    bars + 2 * KV_SLOTS + STAGES};
  const int items = dkv_ktiles(a) * a.H * a.B;
  if (threadIdx.x == 0) {
    for (int s = 0; s < KV_SLOTS; ++s) {
      hopper::mbar_init(&bar.full_kv[s], 1);
      hopper::mbar_init(&bar.empty_kv[s], CONSUMER_WARPS);
    }
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&bar.full_q[s], 33);
      hopper::mbar_init(&bar.empty_q[s], CONSUMER_WARPS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    hopper::regs_dealloc<40>();
    if (threadIdx.x < 288) {
      dkv_produce<KV_SLOTS, STAGES>(smem, bar, q_map, do_map, k_map, v_map,
                                    a, items);
    }
  } else {
    hopper::regs_alloc<232>();
    dkv_consume<KV_SLOTS, STAGES>(smem, bar, a);
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------
// The 4-D maps of q, dout (B, S_q, H, Dh) and k, v (B, S_k, H, Dh),
// contiguous, with boxes of 64 Dh columns by q_rows or kv_rows rows of S
// in one head: rows past S come in as zeros, not as the next batch's.
inline cudaError_t make_maps(CUtensorMap (&maps)[4], const void* q,
                             const void* dout, const void* k, const void* v,
                             int B, int S_q, int S_k, int H, int q_rows,
                             int kv_rows) {
  const void* bases[4] = {q, dout, k, v};
  for (int i = 0; i < 4; ++i) {
    const uint64_t s = i < 2 ? S_q : S_k;
    const cudaError_t err = hopper::make_map_4d_bf16(
        &maps[i], bases[i], DH, H, s, B, DH, static_cast<uint64_t>(H) * DH,
        s * H * DH, BOX, i < 2 ? q_rows : kv_rows);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

inline Args make_args(const void* lse, const void* delta, const void* gate2,
                      const void* video_start, void* dq, void* dg2_part,
                      void* dk, void* dv, void* sched, int B, int S_q,
                      int S_k, int H, int q_offset, int max_feats,
                      float scale) {
  return Args{static_cast<const float*>(lse),
              static_cast<float*>(const_cast<void*>(delta)),
              static_cast<const float*>(gate2),
              static_cast<const int*>(video_start), static_cast<bf16*>(dq),
              static_cast<float*>(dg2_part), static_cast<bf16*>(dk),
              static_cast<bf16*>(dv), static_cast<unsigned int*>(sched),
              B, S_q, S_k, q_offset, H, max_feats, scale};
}

// The launch of `kernel` (a __global__ wrapper of dq_body or dkv_body
// taking the tensor maps `maps`, then Args) on a persistent grid over
// `items` work items.
template <typename Kernel, typename... Maps>
inline cudaError_t launch(Kernel kernel, const Args& a, long long items,
                          int smem, cudaStream_t stream,
                          const Maps&... maps) {
  cudaError_t err = hopper::smem_opt_in(kernel, smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  if (items <= 0 || items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = items < sms ? static_cast<int>(items) : sms;
  kernel<<<grid, THREADS, smem, stream>>>(maps..., a);
  return cudaGetLastError();
}

}  // namespace flashbw
