// K1 for Hopper: causal text attention with the gate2 video-block bias, forward.
//
// Replaces the TPU kernel flash_text_attention -> _flash_kernel
// (flipped_tpu/model/pallas/flash_attention.py:59-171). What it computes, per
// (batch b, head h):
//   s[r, c] = q[r]·k[c] / sqrt(Dh)                      f32 from bf16 operands
//           + gate2[h]  where vs >= 0, r >= vs+F, vs <= c < vs+F
//                       (vs = video_start[b], F = max_feats)
//   s[r, c] = -1e30     where c > r (causal) or c >= S (key padding)
//   out[r]  = softmax(s[r]) @ v                          f32 softmax, P in bf16,
//                                                        f32 accumulation
//   lse[r]  = log sum_c exp(s[r, c])                     for the backward (K2)
//
// Layout: q, k, v, out are (B, S, H, Dh) bf16, read and written through their
// batch/sequence/head strides with no transposed or padded copies; gate2 is
// (H,) f32, video_start (B,) int32, lse (B, H, S) f32.
//
// What bounds it on an H100: at the eval shapes (S = 128, Dh = 128) one
// (b, h) pair does ~4 MFLOP of causal work on 128 KB of q/k/v/out, about 32
// FLOP per byte, far below the ~295 FLOP/byte at which bf16 tensor cores and
// not HBM become the limit; and the whole call is tens of microseconds, so
// launch latency and the tail of 512 small blocks weigh as much as the bytes.
// What the design does about it: every q/k/v byte is read from HBM once per
// q tile and out is written once, the S×S scores never leave registers, and
// causally dead K/V tiles are never loaded. Unlike the TPU kernel, which kept
// all of K/V in VMEM (hence its S <= 4096 bound), K/V stream through shared
// memory in 64-key tiles with an online (FA2-style) softmax, so there is no
// sequence bound; the ragged S edge is masked in the kernel.
//
// Blocking: one block of 4 warps per (b, h, 64-row q tile); each warp owns 16
// q rows. Products are mma.sync m16n8k16 bf16 -> f32. The score accumulator
// of the QK^T product is reused in registers as the A operand of the PV
// product (the m16n8 C layout of two adjacent n-tiles is the m16k16 A layout).
// Tiles with the longest causal loop are scheduled first.
// Not yet done (later work): cp.async/TMA double buffering of K/V, wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;  // q rows per block (4 warps x 16)
constexpr int BK = 64;  // keys per K/V tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
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

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
flash_text_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ gate2,
                      const int* __restrict__ video_start,
                      bf16* __restrict__ out, float* __restrict__ lse, int S,
                      int H, int max_feats, long long sb, long long ss,
                      long long sh, long long osb, long long oss,
                      long long osh, float scale) {
  constexpr int LDS = DH + 8;        // smem row pitch: conflict-free fragments
  constexpr int KSTEPS = DH / 16;    // k-steps of the QK^T product
  constexpr int NT_D = DH / 8;       // n-tiles of the output row
  constexpr int NT_K = BK / 8;       // n-tiles of a score tile
  constexpr int VEC_PER_ROW = DH / 8;  // 16-byte vectors per K/V row
  __shared__ __align__(16) bf16 k_s[BK * LDS];
  __shared__ __align__(16) bf16 v_s[BK * LDS];

  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // row within the 8-row group of a fragment
  const int t = lane & 3;   // thread within the quad

  const long long head_off = b * sb + h * sh;
  const bf16* qb = q + head_off;
  const bf16* kb = k + head_off;
  const bf16* vb = v + head_off;
  const int vs = video_start[b];
  const float g2 = gate2[h];

  const int r0 = q0 + warp * 16 + g;  // this thread's two rows
  const int r1 = r0 + 8;

  // Q fragments straight from global memory: read once per block.
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + t * 2;
    qf[kk][0] = r0 < S ? *reinterpret_cast<const uint32_t*>(qb + r0 * ss + c) : 0u;
    qf[kk][1] = r1 < S ? *reinterpret_cast<const uint32_t*>(qb + r1 * ss + c) : 0u;
    qf[kk][2] = r0 < S ? *reinterpret_cast<const uint32_t*>(qb + r0 * ss + c + 8) : 0u;
    qf[kk][3] = r1 < S ? *reinterpret_cast<const uint32_t*>(qb + r1 * ss + c + 8) : 0u;
  }

  float o[NT_D][4];
#pragma unroll
  for (int d = 0; d < NT_D; ++d) {
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};  // running row max (rows r0, r1)
  float l[2] = {0.f, 0.f};              // this thread's share of the row sum

  // keys past the tile's last row are causally dead
  const int kv_end = min(S, q0 + BQ);
  const int n_kt = (kv_end + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    for (int i = threadIdx.x; i < BK * VEC_PER_ROW; i += NTHREADS) {
      const int row = i / VEC_PER_ROW;
      const int vec = i % VEC_PER_ROW;
      const int key = k0 + row;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < S) {  // rows past S are zero: 0 * garbage could be NaN
        kv = *reinterpret_cast<const uint4*>(kb + key * ss + vec * 8);
        vv = *reinterpret_cast<const uint4*>(vb + key * ss + vec * 8);
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
        const int row = i < 2 ? r0 : r1;
        const int col = k0 + n * 8 + t * 2 + (i & 1);
        float s = sc[n][i] * scale;
        if (vs >= 0 && row >= vs + max_feats && col >= vs &&
            col < vs + max_feats) {
          s += g2;
        }
        if (col > row || col >= S) s = NEG_INF;
        sc[n][i] = s;
        mx[i >> 1] = fmaxf(mx[i >> 1], s);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
    }
    // Key 0 lies in the first tile and is visible to every row, so mx is a
    // finite score from the first tile on; exp(-inf) = 0 clears the empty
    // initial state.
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
  bf16* ob = out + b * osb + h * osh;
#pragma unroll
  for (int d = 0; d < NT_D; ++d) {
    const int c = d * 8 + t * 2;
    if (r0 < S) {
      *reinterpret_cast<uint32_t*>(ob + r0 * oss + c) =
          pack_f32(o[d][0] * inv0, o[d][1] * inv0);
    }
    if (r1 < S) {
      *reinterpret_cast<uint32_t*>(ob + r1 * oss + c) =
          pack_f32(o[d][2] * inv1, o[d][3] * inv1);
    }
  }
  if (t == 0) {
    float* lb = lse + (static_cast<long long>(b) * H + h) * S;
    if (r0 < S) lb[r0] = m[0] + logf(l[0]);
    if (r1 < S) lb[r1] = m[1] + logf(l[1]);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* gate2, const void* video_start, void* out,
                   void* lse, int B, int S, int H, int max_feats, long long sb,
                   long long ss, long long sh, long long osb, long long oss,
                   long long osh, float scale, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_text_fwd_kernel<DH><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(gate2),
      static_cast<const int*>(video_start), static_cast<bf16*>(out),
      static_cast<float*>(lse), S, H, max_feats, sb, ss, sh, osb, oss, osh,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_text_fwd(const void* q, const void* k, const void* v,
                              const void* gate2, const void* video_start,
                              void* out, void* lse, int B, int S, int H,
                              int Dh, int max_feats, long long sb,
                              long long ss, long long sh, long long osb,
                              long long oss, long long osh, float scale,
                              void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {  // every LLaMA preset of the repo has Dh = 128
    case 128:
      return static_cast<int>(launch<128>(q, k, v, gate2, video_start, out,
                                          lse, B, S, H, max_feats, sb, ss,
                                          sh, osb, oss, osh, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
