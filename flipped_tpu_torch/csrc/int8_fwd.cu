// K3 for Hopper: the w8a8 per-channel forward, out = x @ dequant(W) with x
// quantized per row.
//
// Replaces the TPU kernel int8_fwd_pallas -> _fwd_kernel
// (flipped_tpu/model/pallas/quant_matmul.py:603-698). What it computes, for
// x (M, K) bf16, kq (N, K) int8 (the port's layout, K-contiguous), scale (N,)
// f32:
//   xs[m]    = max(amax_k |x[m, k]| * float32(1/127), 1e-8)
//   xq[m, k] = rint(x[m, k] / xs[m])                     half to even, int8
//   d[m, n]  = sum_k xq[m, k] * kq[n, k]                  exact, int32
//   out[m,n] = bf16((float(d) * xs[m]) * scale[n])        the JAX order,
//                                                         model/int8.py:77
//
// What bounds it on an H100: at the 7B training shapes (M 3072, K 4096 or
// 11008, N 4096 or 11008) a call is 103-277 G multiply-adds of int8 on
// 67-138 MB of operands, ~1500 operations per byte, far above the ~590 at
// which int8 tensor cores and not HBM are the limit: it is compute-bound
// (52-140 us at the 1979 TOP/s peak), and only wgmma reaches that rate.
// The eval's 320-row extend is the exception: there the weight's bytes
// bound it.
//
// Two launches on the caller's stream:
//   - the quantize pass, one 256-thread block per row: 16-byte loads of x,
//     the row kept in registers between the amax and the codes (rows up to
//     256 x 8 x QV = 12288 wide: every 7B K; a longer row reads x a second
//     time), 8 codes stored at once. It writes xq (M, K) int8 and xs (M,)
//     f32, scratch the wrapper allocates. It stays a launch of its own:
//     the amax needs the whole row before any code, as the TPU kernel
//     quantizes its whole (bm, K) row block first.
//   - the GEMM: xq (M, K) and kq (N, K) are both contiguous along the
//     contraction, the one layout 8-bit wgmma reads from shared memory, so
//     both go to wgmma exactly as TMA wrote them (SS form, no register
//     transposes; K10's kq is MN-major and needs them, wgmma_int8.cuh). A
//     block tiles 128 rows x 256 columns over 128-deep stages: two consumer
//     warpgroups (setmaxnreg 232) own 64 rows each and issue one
//     m64n256k32 wgmma a 32-deep step, 128 int32 accumulators a thread; one
//     lane of a producer warpgroup (setmaxnreg 40) keeps a ring of 4 stages
//     (16 KB of xq, 32 KB of kq each) full. The grid is persistent (one
//     block an SM, output tiles in turn, rows fastest so that the blocks
//     in flight share their kq tiles in L2), and the ring runs on across
//     tiles, so the next tile's loads overlap this tile's epilogue. Rows
//     past M, columns past N and the contraction past K come in as zeros.
//     The epilogue keeps JAX's order, __fmul_rn(__fmul_rn(float(d), xs[m]),
//     scale[n]) and one rounding to bf16; each quad of lanes transposes its
//     bf16 pairs so that a lane stores 8 adjacent columns (16 bytes) and a
//     row takes 64 contiguous bytes a store (hopper::quad_transpose). With
//     the pairs stored as they lie (4-byte stores, each warp's scattered
//     over 8 rows) the GEMM took 0.26 ms at the 7B w1/w3 shape on an H100
//     80GB HBM3, with these stores 0.17 ms (PERF.md).
// The int32 sums are exact in any order, so the result is the plain
// version's bit for bit.
// Not yet done (later work): consumers that take turns, so that one's
// epilogue runs under the other's wgmmas.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"
#include "quant_common.cuh"

namespace {

using quant::bf16;

// ---------------------------------------------------------------------------
// Quantize pass
// ---------------------------------------------------------------------------
constexpr int QTHREADS = 256;
constexpr int QV = 6;             // 8-wide vectors a thread keeps on chip

__device__ __forceinline__ void load8(const bf16* xr, int v, float f[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(xr + 8 * v);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p = __bfloat1622float2(e[j]);
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

__device__ __forceinline__ void store_codes8(int8_t* qr, int v,
                                             const float f[8], float s) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t q =
        static_cast<uint32_t>(__float2int_rn(__fdiv_rn(f[e], s))) & 0xffu;
    w[e >> 2] |= q << (8 * (e & 3));
  }
  *reinterpret_cast<uint2*>(qr + 8 * v) = make_uint2(w[0], w[1]);
}

__global__ void __launch_bounds__(QTHREADS)
int8_fwd_quantize_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq,
                         float* __restrict__ xs, int K) {
  __shared__ float red[QTHREADS / 32];
  const long long row = blockIdx.x;
  const bf16* xr = x + row * K;
  int8_t* qr = xq + row * K;
  const int nvec = K / 8;

  float keep[QV][8];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < QV; ++j) {
    const int v = threadIdx.x + j * QTHREADS;
    if (v < nvec) {
      load8(xr, v, keep[j]);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(keep[j][e]));
    }
  }
  for (int v = threadIdx.x + QV * QTHREADS; v < nvec; v += QTHREADS) {
    float f[8];
    load8(xr, v, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(f[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < QTHREADS / 32; ++w) amax = fmaxf(amax, red[w]);
  const float s = fmaxf(__fmul_rn(amax, quant::INV127), quant::EPS);
  if (threadIdx.x == 0) xs[row] = s;

#pragma unroll
  for (int j = 0; j < QV; ++j) {
    const int v = threadIdx.x + j * QTHREADS;
    if (v < nvec) store_codes8(qr, v, keep[j], s);
  }
  for (int v = threadIdx.x + QV * QTHREADS; v < nvec; v += QTHREADS) {
    float f[8];
    load8(xr, v, f);
    store_codes8(qr, v, f, s);
  }
}

// ---------------------------------------------------------------------------
// GEMM
// ---------------------------------------------------------------------------
constexpr int BM = 128;           // rows a tile, 64 a consumer warpgroup
constexpr int BN = 256;           // columns a tile: the wgmma N
constexpr int BK = 128;           // contraction a stage: 128-byte rows
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK;  // 16 KB of xq, 128B swizzle
constexpr int B_BYTES = BN * BK;  // 32 KB of kq, 128B swizzle
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int THREADS = 3 * 128;
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

// The four 32-deep steps of one stage; the tile's first stage overwrites d.
template <bool FIRST>
__device__ __forceinline__ void stage_wgmmas(int (&d)[128], uint64_t da,
                                             uint64_t db) {
  hopper::wgmma_fence();
  if (FIRST) {
    hopper::wgmma_m64n256k32_s8_ss_zero(d, da, db);
  } else {
    hopper::wgmma_m64n256k32_s8_ss(d, da, db);
  }
#pragma unroll
  for (int ks = 1; ks < BK / 32; ++ks) {
    hopper::wgmma_m64n256k32_s8_ss(d, da + 2 * ks, db + 2 * ks);
  }
  hopper::wgmma_commit();
}

// The consumer warpgroups: every tile of the block in turn, its main loop
// and its epilogue. `it` counts stages over all of the block's tiles, as
// the producer does.
__device__ __forceinline__ void consume(uint8_t* smem, uint64_t* full,
                                        uint64_t* empty,
                                        const float* __restrict__ xs,
                                        const float* __restrict__ scale,
                                        bf16* __restrict__ out, int M, int N,
                                        int tiles, int m_tiles, int nst) {
  const int wg = threadIdx.x / 128;
  const int w = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool leader = threadIdx.x % 128 == 0;

  int d[128];
  int it = 0;
  auto descs = [&](int i, uint64_t& da, uint64_t& db) {
    const int s = i % STAGES;
    hopper::mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* st = smem + s * STAGE_BYTES;
    da = hopper::desc_sw128(st + wg * (A_BYTES / 2));
    db = hopper::desc_sw128(st + A_BYTES);
  };
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % m_tiles) * BM;
    const int n0 = (tile / m_tiles) * BN;
    uint64_t da, db;
    descs(it, da, db);
    stage_wgmmas<true>(d, da, db);
    ++it;
    for (int kb = 1; kb < nst; ++kb, ++it) {
      descs(it, da, db);
      stage_wgmmas<false>(d, da, db);
      // the previous stage's wgmmas are done: its slot goes back
      hopper::wgmma_wait<1>();
      if (leader) hopper::mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    hopper::wgmma_wait<0>();
    if (leader) hopper::mbar_arrive(&empty[(it - 1) % STAGES]);
#pragma unroll
    for (int i = 0; i < 128; ++i) hopper::fence_operand(d[i]);

    // d[4i + e] at row 16w + g, column 8i + 2t + e; d[4i + 2 + e] at row
    // 16w + g + 8 (of the warpgroup's 64 rows); each quad transposes the
    // pairs of 32 columns at a time for 16-byte stores
    const int r0 = m0 + wg * 64 + 16 * w + g;
    const int r1 = r0 + 8;
    const float xs0 = r0 < M ? xs[r0] : 0.f;
    const float xs1 = r1 < M ? xs[r1] : 0.f;
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      uint32_t v0[4], v1[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * j + q;
        const int col = n0 + 8 * i + 2 * t;
        const float s0 = col < N ? scale[col] : 0.f;   // N % 8 == 0
        const float s1 = col < N ? scale[col + 1] : 0.f;
        const __nv_bfloat162 p0 = __floats2bfloat162_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(d[4 * i]), xs0), s0),
            __fmul_rn(__fmul_rn(__int2float_rn(d[4 * i + 1]), xs0), s1));
        const __nv_bfloat162 p1 = __floats2bfloat162_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(d[4 * i + 2]), xs1), s0),
            __fmul_rn(__fmul_rn(__int2float_rn(d[4 * i + 3]), xs1), s1));
        v0[q] = *reinterpret_cast<const uint32_t*>(&p0);
        v1[q] = *reinterpret_cast<const uint32_t*>(&p1);
      }
      const uint4 w0 = hopper::quad_transpose(v0, t);
      const uint4 w1 = hopper::quad_transpose(v1, t);
      const int col = n0 + 8 * (4 * j + t);    // the lane's 8 columns
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
}

// Persistent grid of min(tiles, SMs) blocks of THREADS: warps 0-7 the two
// consumer warpgroups, warps 8-11 the producer warpgroup, of which one lane
// issues the loads.
__global__ void __launch_bounds__(THREADS, 1)
int8_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                      const __grid_constant__ CUtensorMap b_map,
                      const float* __restrict__ xs,
                      const float* __restrict__ scale,
                      bf16* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) &
                              1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int m_tiles = (M + BM - 1) / BM;
  const int tiles = m_tiles * ((N + BN - 1) / BN);
  const int nst = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);     // one arrive a consumer warpgroup
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    hopper::regs_dealloc<40>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * BM;
        const int n0 = (tile / m_tiles) * BN;
        for (int kb = 0; kb < nst; ++kb, ++it) {
          const int s = it % STAGES;
          const int round = it / STAGES;
          if (round > 0) hopper::mbar_wait(&empty[s], (round - 1) & 1);
          uint8_t* st = smem + s * STAGE_BYTES;
          hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
          hopper::tma_load_2d(st, &a_map, &full[s], kb * BK, m0);
          hopper::tma_load_2d(st + A_BYTES, &b_map, &full[s], kb * BK, n0);
        }
      }
    }
  } else {
    hopper::regs_alloc<232>();
    consume(smem, full, empty, xs, scale, out, M, N, tiles, m_tiles, nst);
  }
}

}  // namespace

// xq (M, K) int8 and xs (M,) f32 are scratch the wrapper allocates; x, kq
// 16-byte aligned, K % 16 == 0 (TMA's 16-byte row pitch), N % 8 == 0.
extern "C" int int8_fwd(const void* x, const void* kq, const void* scale,
                        void* xq, void* xs, void* out, int M, int N, int K,
                        void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 8 != 0 ||
      static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN) >
          0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_fwd_quantize_kernel<<<M, QTHREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(xs), K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap a_map, b_map;
  err = hopper::make_map_2d(&a_map, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M,
                            K, BM, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) {
    err = hopper::make_map_2d(&b_map, kq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                              N, K, BN, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == cudaSuccess) {
    err = hopper::smem_opt_in(int8_fwd_wgmma_kernel, SMEM);
  }
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = tiles < sms ? tiles : sms;
  int8_fwd_wgmma_kernel<<<grid, THREADS, SMEM, st>>>(
      a_map, b_map, static_cast<const float*>(xs),
      static_cast<const float*>(scale), static_cast<bf16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
