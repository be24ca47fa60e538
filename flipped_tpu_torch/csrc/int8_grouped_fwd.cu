// K7 for Hopper: the grouped (sub-channel) w8a8 forward of --quantize
// w8a8g / w8a8o.
//
// Replaces the TPU kernel grouped_matmul_pallas -> _kernel
// (flipped_tpu/model/pallas/quant_matmul.py:55-145). What it computes, for
// x (M, K) bf16, kq (N, K) int8 (the port's layout), scale_g (G, N) f32 with
// G = K / 128:
//   xs[m, g]  = max(amax over group g of |x[m, :]| / 127, 1e-8)   a division,
//                                              as model/int8.py:257 writes it
//   xq[m, k]  = rint(x[m, k] / xs[m, k / 128])                    half to even
//   d_g[m, n] = sum over group g of xq[m, k] * kq[n, k]           exact, int32
//   acc       = sum_g (float(d_g) * xs[m, g]) * scale_g[g, n]     f32, over the
//                                              groups in order 0..G-1
//   out[m, n] = bf16(acc)
// so that it equals the plain version (grouped_matmul_ref) bit for bit.
//
// What bounds it on an H100: the int8 products of K3 at the same shapes,
// 103-277 G multiply-adds at the 7B training shapes, compute-bound at the
// 1979 TOP/s peak (52-140 us). The fold of each group adds an int32 -> f32
// conversion, two multiplies and an add per output element and group: one
// lane-operation for every 32 products, which at the tensor cores' rate
// takes about as many issue slots of the SM's sub-partitions as the tensor
// cores take cycles. So the fold has to run under the wgmmas.
//
// Two launches on the caller's stream:
//   - the quantize pass (quant_common.cuh `quantize_rows_kernel`, one warp
//     per (row, group)), writing xq (M, K) int8 and the row scales
//     transposed, xs (G, M rounded up to 4) f32, scratch the wrapper
//     allocates;
//   - the GEMM: xq and kq are both contiguous along the contraction, so
//     both go to wgmma from shared memory exactly as TMA wrote them (SS
//     form, 128-byte swizzle), as in K3 (int8_fwd.cu). A block tiles 128
//     rows x 128 columns over 128-deep stages, one group a stage: two
//     consumer warpgroups (setmaxnreg 232) own 64 rows each and issue one
//     m64n128k32 wgmma a 32-deep step. K3's m64n256 tile holds 128 int32
//     accumulators a thread; K7 also needs the f32 sum beside them, and
//     128 + 128 do not fit beside the addressing. A thread holds two int32
//     accumulators of 64 that alternate between groups and the f32 sum
//     (192 registers): once group g's wgmmas are done, group g + 1's are
//     issued into the other accumulator (the group's first with scale-d 0,
//     so no ordinary instruction writes an accumulator) and group g is
//     folded while they run. The group loop is unrolled by two so that
//     each accumulator is a compile-time choice, and the kernel comes in
//     two instantiations for an even and an odd group count, picked on the
//     host, so that no branch sits between a wgmma and its wait. Issuing
//     group g + 1 before group g's wait (two groups in flight, the wait at
//     wgmma_wait<1>) made ptxas serialise the wgmmas (C7514, "non wgmma
//     instructions reading accumulator registers"): the fold's reads then
//     cross the loop's back edge with a wgmma in flight.
//   - one lane of a producer warpgroup (setmaxnreg 40) keeps a ring of 6
//     stages full by TMA: 16 KB of xq, 16 KB of kq, and the fold's
//     operands of the stage's group, scale_g[g, n0 .. n0 + 127] and xs[g,
//     m0 .. m0 + 127] (one contiguous box each). Every consumer warp reads
//     those with ordinary loads, so every consumer warp releases the stage.
//   - the grid is persistent (one block an SM, output tiles in turn, rows
//     fastest so that the blocks in flight share their kq tiles in L2),
//     and the ring runs on across tiles, so the next tile's loads overlap
//     this tile's epilogue. Rows past M, columns past N come in as zeros.
//   - the fold: __int2float_rn, __fmul_rn, __fmul_rn, __fadd_rn in the
//     plain version's order (an exact integer-add-and-subtract conversion
//     in place of the first read slower in a throwaway variant build).
//   - epilogue: one rounding to bf16; each quad of lanes transposes its
//     bf16 pairs so that a lane stores 8 adjacent columns (16 bytes,
//     hopper::quad_transpose), as K3 does.
// What holds it back: the 128-column tile (the registers allow no wider
// one) reads each stage's operands from L2 and shared memory once per 2 M
// products instead of K3's once per 4 M: the same GEMM without the fold
// at K3's structure with 128-column tiles reads about 20% slower than K3.
// The TPU kernel kept the (G, M, N) partial products of the batched XLA
// formulation out of HBM; here they never leave registers either.
// Not yet done (later work): a 2-CTA cluster multicasting the kq tile
// (half the L2 reads of it), fusing the quantize into the GEMM's A loads
// (each group is local to one stage), consumers that take turns so that
// one's epilogue runs under the other's wgmmas.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"
#include "quant_common.cuh"

namespace {

using quant::bf16;

constexpr int GROUP = 128;        // the group width: one stage
constexpr int BM = 128;           // rows a tile, 64 a consumer warpgroup
constexpr int BN = 128;           // columns a tile: the wgmma N
constexpr int BK = GROUP;         // contraction a stage: 128-byte rows
constexpr int STAGES = 6;
constexpr int A_BYTES = BM * BK;  // 16 KB of xq, 128B swizzle
constexpr int B_BYTES = BN * BK;  // 16 KB of kq, 128B swizzle
// the fold's operands of the stage's group g: scale_g[g, n0 .. n0 + 127],
// then xs[g, m0 .. m0 + 127] (the transposed row scales)
constexpr int S_BYTES = BN * 4;
constexpr int XS_BYTES = BM * 4;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES + 1024;
constexpr int TX_BYTES = A_BYTES + B_BYTES + S_BYTES + XS_BYTES;
constexpr int THREADS = 3 * 128;
constexpr int CONSUMER_WARPS = 8;
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
static_assert(S_BYTES + XS_BYTES <= 1024, "the fold's operands fit");

struct Ring {
  uint8_t* smem;
  uint64_t* full;
  uint64_t* empty;
  __device__ __forceinline__ uint8_t* stage(int it) const {
    return smem + (it % STAGES) * STAGE_BYTES;
  }
  __device__ __forceinline__ const float* aux(int it) const {
    return reinterpret_cast<const float*>(stage(it) + A_BYTES + B_BYTES);
  }
};

// A consumer thread's place: its warpgroup (rows wg * 64 .. + 63 of the
// tile), warp w in it, lane 4g + t.
struct Place {
  int wg, w, g, t;
};

// group `it`'s 4 wgmmas into d, the first overwriting it
__device__ __forceinline__ void issue(const Ring& ring, const Place& p,
                                      int (&d)[64], int it) {
  hopper::mbar_wait(&ring.full[it % STAGES], (it / STAGES) & 1);
  const uint8_t* st = ring.stage(it);
  const uint64_t da = hopper::desc_sw128(st + p.wg * (A_BYTES / 2));
  const uint64_t db = hopper::desc_sw128(st + A_BYTES);
  hopper::wgmma_fence();
  hopper::wgmma_m64n128k32_s8_ss_zero(d, da, db);
#pragma unroll
  for (int ks = 1; ks < BK / 32; ++ks) {
    hopper::wgmma_m64n128k32_s8_ss(d, da + 2 * ks, db + 2 * ks);
  }
  hopper::wgmma_commit();
}

// acc += (float(d) * xs[row]) * scale[col], the operands of group `it`
// read from its stage, which each warp then gives back to the producer
// (every consumer warp reads the stage with ordinary loads, so each
// arrives: one arrival a warpgroup would free the stage while the
// warpgroup's other warps still read it). d[4i + e] is at row 16w + g,
// column 8i + 2t + e; d[4i + 2 + e] at row 16w + g + 8.
__device__ __forceinline__ void fold(const Ring& ring, const Place& p,
                                     int (&d)[64], float (&acc)[64],
                                     int it) {
#pragma unroll
  for (int i = 0; i < 64; ++i) hopper::fence_operand(d[i]);
  const float* aux = ring.aux(it);
  const float* xs = aux + BN + p.wg * 64 + 16 * p.w + p.g;
  const float xv[2] = {xs[0], xs[8]};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 s = *reinterpret_cast<const float2*>(aux + 8 * i + 2 * p.t);
    const float sv[2] = {s.x, s.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 4 * i + e;
      acc[r] = __fadd_rn(
          acc[r], __fmul_rn(__fmul_rn(__int2float_rn(d[r]),
                                      xv[e >> 1]),
                            sv[e & 1]));
    }
  }
  __syncwarp();
  if (p.g == 0 && p.t == 0) hopper::mbar_arrive(&ring.empty[it % STAGES]);
}

// group `it` into cur once group it - 1's wgmmas (into prev) are done,
// then the fold of prev while cur's run
__device__ __forceinline__ void step(const Ring& ring, const Place& p,
                                     int (&cur)[64], int (&prev)[64],
                                     float (&acc)[64], int it) {
  hopper::wgmma_wait<0>();
  issue(ring, p, cur, it);
  fold(ring, p, prev, acc, it - 1);
}

__device__ __forceinline__ void epilogue(const Place& p,
                                         const float (&acc)[64],
                                         bf16* __restrict__ out, int M,
                                         int N, int m0, int n0) {
  // each quad transposes the bf16 pairs of 32 columns at a time for
  // 16-byte stores
  const int r0 = m0 + p.wg * 64 + 16 * p.w + p.g;
  const int r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < BN / 32; ++j) {
    uint32_t v0[4], v1[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * j + q;
      const __nv_bfloat162 p0 =
          __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
      const __nv_bfloat162 p1 =
          __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
      v0[q] = *reinterpret_cast<const uint32_t*>(&p0);
      v1[q] = *reinterpret_cast<const uint32_t*>(&p1);
    }
    const uint4 w0 = hopper::quad_transpose(v0, p.t);
    const uint4 w1 = hopper::quad_transpose(v1, p.t);
    const int col = n0 + 8 * (4 * j + p.t);  // the lane's 8 columns
    if (col < N) {                           // N % 8 == 0: all 8 or none
      if (r0 < M) {
        *reinterpret_cast<uint4*>(out + static_cast<long long>(r0) * N +
                                  col) = w0;
      }
      if (r1 < M) {
        *reinterpret_cast<uint4*>(out + static_cast<long long>(r1) * N +
                                  col) = w1;
      }
    }
  }
}

// The consumer warpgroups: each tile of the block in turn, its group loop
// and its epilogue; `it` counts stages over all of the block's tiles, as
// the producer does. Group g goes into d0 for even g, d1 for odd; groups
// 1, 2 are a pair, 3, 4 the next, and with an even count (EVEN) the last
// group is one step more after the pairs.
template <bool EVEN>
__device__ __forceinline__ void consume(const Ring& ring, const Place& p,
                                        bf16* __restrict__ out, int M, int N,
                                        int tiles, int m_tiles, int groups) {
  int d0[64], d1[64];
  float acc[64];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % m_tiles) * BM;
    const int n0 = (tile / m_tiles) * BN;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    issue(ring, p, d0, it);
    int gi = 1;
    for (; gi + 1 < groups; gi += 2) {
      step(ring, p, d1, d0, acc, it + gi);
      step(ring, p, d0, d1, acc, it + gi + 1);
    }
    if constexpr (EVEN) {            // gi == groups - 1
      step(ring, p, d1, d0, acc, it + gi);
      hopper::wgmma_wait<0>();
      fold(ring, p, d1, acc, it + gi);
    } else {                         // gi == groups
      hopper::wgmma_wait<0>();
      fold(ring, p, d0, acc, it + gi - 1);
    }
    it += groups;
    epilogue(p, acc, out, M, N, m0, n0);
  }
}

// Persistent grid of min(tiles, SMs) blocks of THREADS: warps 0-7 the two
// consumer warpgroups, warps 8-11 the producer warpgroup, of which one
// lane issues the TMA loads.
template <bool EVEN>
__global__ void __launch_bounds__(THREADS, 1)
int8_grouped_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                          const __grid_constant__ CUtensorMap b_map,
                          const __grid_constant__ CUtensorMap s_map,
                          const __grid_constant__ CUtensorMap xs_map,
                          bf16* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) &
                              1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const Ring ring{smem, full, empty};

  const int m_tiles = (M + BM - 1) / BM;
  const int tiles = m_tiles * ((N + BN - 1) / BN);
  const int groups = K / GROUP;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    hopper::regs_dealloc<40>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * BM;
        const int n0 = (tile / m_tiles) * BN;
        for (int kb = 0; kb < groups; ++kb, ++it) {
          const int s = it % STAGES;
          const int round = it / STAGES;
          if (round > 0) hopper::mbar_wait(&empty[s], (round - 1) & 1);
          uint8_t* st = smem + s * STAGE_BYTES;
          uint8_t* aux = st + A_BYTES + B_BYTES;
          hopper::mbar_arrive_expect_tx(&full[s], TX_BYTES);
          hopper::tma_load_2d(st, &a_map, &full[s], kb * BK, m0);
          hopper::tma_load_2d(st + A_BYTES, &b_map, &full[s], kb * BK, n0);
          hopper::tma_load_2d(aux, &s_map, &full[s], n0, kb);
          hopper::tma_load_2d(aux + S_BYTES, &xs_map, &full[s], m0, kb);
        }
      }
    }
  } else {
    hopper::regs_alloc<232>();
    const Place p{warp / 4, warp % 4, lane >> 2, lane & 3};
    consume<EVEN>(ring, p, out, M, N, tiles, m_tiles, groups);
  }
}

}  // namespace

// xq (M, K) int8 and xs (K / 128, xs_pitch(M)) f32 (the row scales,
// transposed) are scratch the wrapper allocates; x, kq and scale_g 16-byte
// aligned, K % 128 == 0, N % 8 == 0.
extern "C" int int8_grouped_fwd(const void* x, const void* kq,
                                const void* scale_g, void* xq, void* xs,
                                void* out, int M, int N, int K,
                                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % GROUP != 0 || N % 8 != 0 ||
      static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN) >
          0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = quant::launch_quantize(x, xq, xs, M, K, GROUP, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int groups = K / GROUP;
  const auto kernel = groups % 2 == 0 ? int8_grouped_wgmma_kernel<true>
                                      : int8_grouped_wgmma_kernel<false>;
  CUtensorMap a_map, b_map, s_map, xs_map;
  err = hopper::make_map_2d(&a_map, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M,
                            K, BM, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) {
    err = hopper::make_map_2d(&b_map, kq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                              N, K, BN, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == cudaSuccess) {
    err = hopper::make_map_2d(&s_map, scale_g,
                              CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, groups, N,
                              1, BN, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err == cudaSuccess) {
    err = hopper::make_map_2d(&xs_map, xs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                              4, groups, quant::xs_pitch(M), 1, BM,
                              CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err == cudaSuccess) err = hopper::smem_opt_in(kernel, SMEM);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = tiles < sms ? tiles : sms;
  kernel<<<grid, THREADS, SMEM, st>>>(a_map, b_map, s_map, xs_map,
                                      static_cast<bf16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
