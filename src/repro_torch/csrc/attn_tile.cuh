// Warp-level attention tiles for Hopper, shared by paged_attention.cu and
// flash_attention.cu: tensor-core products on mma.sync.m16n8k16 with fp32
// accumulators, ldmatrix operand loads, 16-byte cp.async copies, and the
// online softmax on the mma accumulator layout, so that scores, softmax
// weights and the output accumulator stay in registers from one key tile to
// the next.
//
// Layout. A warp owns 16 query rows. In the m16n8 accumulator ("C
// fragment") lane l holds rows g = l / 4 and g + 8, columns 2·t and 2·t + 1
// with t = l % 4: c[0], c[1] for row g, c[2], c[3] for row g + 8. A score
// tile of NT·8 keys is float s[NT][4]; an output accumulator of D columns is
// float acc[D / 8][4]. The per-row statistics m and l are float[2], index 0
// for row g and 1 for row g + 8.
//
// The numerical contract of both kernels:
//   * a masked score is MASKED (-1e30), never -inf, so a row whose every key
//     so far is masked keeps m = -1e30 and p = 1 for those keys, and the
//     first live key wipes them with corr = exp(-1e30 - m) = 0, as in JAX;
//     a padding key past the end of a partition or sequence is -inf and so
//     contributes p = 0 to l and acc;
//   * p = exp(s - m) in fp32 (as exp2 of (s - m)·log2 e: fp32 rounding only)
//     enters l unrounded and is rounded to the compute dtype before PV;
//   * every sum is fp32.
//
// fp32 (the reduced configurations' dtype) runs the same fragments on CUDA
// cores: warp_scores and warp_pv compute each lane's accumulator entries
// with scalar FMAs from shared memory, so the softmax code is one path.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "sm90_tile.cuh"

namespace attn {

constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

// row stride (elements) of a D-wide tile in shared memory: rows stay
// 16-byte aligned, and for 16-bit types the stride is an odd number of
// 16-byte chunks (D + 8 with D % 16 == 0), so the eight row addresses of an
// ldmatrix phase fall in eight different bank groups
template <typename T, int D>
__host__ __device__ constexpr int tile_ld() {
  return is_f32<T>() ? D + 4 : D + 8;
}

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// cp.async, ldmatrix, mma.sync and the operand packing (sm90_tile.cuh)
using sm90::cp_async16;
using sm90::cp_async4;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::ldsm_x4;
using sm90::ldsm_x4_t;
using sm90::mma16816;
using sm90::pack2;
using sm90::smem_u32;

// a float rounded to T
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// ---------------------------------------------------------------------------
// the warp's 16 query rows
// ---------------------------------------------------------------------------

// 16-bit: the A fragments of all D/16 k-steps, loaded once into registers.
// fp32: the rows stay in shared memory and are read by warp_scores.
template <typename T, int D, bool F32 = is_f32<T>()>
struct QFrag {
  uint32_t a[D / 16][4];
  __device__ __forceinline__ void load(const T* rows, int ld, int lane) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      ldsm_x4(a[ks], rows + (lane & 15) * ld + ks * 16 + (lane >> 4) * 8);
  }
};

template <typename T, int D>
struct QFrag<T, D, true> {
  const float* rows;
  int ld;
  __device__ __forceinline__ void load(const T* r, int l, int) {
    rows = r;
    ld = l;
  }
};

// s = the warp's 16 rows · keys 0 .. NT·8 - 1 of the tile at k_s (rows of
// ld elements), fp32
template <typename T, int D, int NT>
__device__ __forceinline__ void warp_scores(float (&s)[NT][4],
                                            const QFrag<T, D>& q,
                                            const T* k_s, int ld, int lane) {
  static_assert(NT % 2 == 0, "keys come in pairs of 8-key tiles");
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.0f;
  if constexpr (!is_f32<T>()) {
    // matrix i of an x4 load: keys (i >> 1)·8.., dims (i & 1)·8.. — the
    // b0b1 / b2b3 halves of two neighbouring 8-key tiles
    const int krow = (lane >> 4) * 8 + (lane & 7);
    const int kcol = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int kp = 0; kp < NT / 2; ++kp) {
        uint32_t b[4];
        ldsm_x4(b, k_s + (kp * 16 + krow) * ld + ks * 16 + kcol);
        mma16816<T>(s[2 * kp], q.a[ks], b[0], b[1]);
        mma16816<T>(s[2 * kp + 1], q.a[ks], b[2], b[3]);
      }
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    const float* q0 = q.rows + g * q.ld;
    const float* q1 = q0 + 8 * q.ld;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(q0 + d);
      const float4 qb = *reinterpret_cast<const float4*>(q1 + d);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float4 kv = *reinterpret_cast<const float4*>(
              k_s + (nt * 8 + 2 * t + c) * ld + d);
          float x = s[nt][c], y = s[nt][2 + c];
          x = fmaf(qa.x, kv.x, x); x = fmaf(qa.y, kv.y, x);
          x = fmaf(qa.z, kv.z, x); x = fmaf(qa.w, kv.w, x);
          y = fmaf(qb.x, kv.x, y); y = fmaf(qb.y, kv.y, y);
          y = fmaf(qb.z, kv.z, y); y = fmaf(qb.w, kv.w, y);
          s[nt][c] = x;
          s[nt][2 + c] = y;
        }
    }
  }
}

// acc += p · V over keys 0 .. NT·8 - 1 of the tile at v_s; p (the
// softmax weights in the C layout) is rounded to T first. For 16-bit T
// the C fragments of two neighbouring 8-key tiles are exactly the A
// fragment of one 16-key step, so p never leaves registers.
template <typename T, int D, int NT>
__device__ __forceinline__ void warp_pv(float (&acc)[D / 8][4],
                                        const float (&p)[NT][4],
                                        const T* v_s, int ld, int lane) {
  if constexpr (!is_f32<T>()) {
    // matrix i of an x4.trans load: keys (i & 1)·8.., dims (i >> 1)·8..
    const int vrow = ((lane >> 3) & 1) * 8 + (lane & 7);
    const int vcol = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t a[4] = {
          pack2<T>(p[2 * kk][0], p[2 * kk][1]),
          pack2<T>(p[2 * kk][2], p[2 * kk][3]),
          pack2<T>(p[2 * kk + 1][0], p[2 * kk + 1][1]),
          pack2<T>(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, v_s + (kk * 16 + vrow) * ld + dp * 16 + vcol);
        mma16816<T>(acc[2 * dp], a, b[0], b[1]);
        mma16816<T>(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
  } else {
    // each lane gathers its rows' weights from the other lanes of its quad
    const int t = lane & 3, quad = lane & ~3;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const float pg0 = __shfl_sync(0xffffffffu, p[j][0], quad + src);
        const float pg1 = __shfl_sync(0xffffffffu, p[j][1], quad + src);
        const float ph0 = __shfl_sync(0xffffffffu, p[j][2], quad + src);
        const float ph1 = __shfl_sync(0xffffffffu, p[j][3], quad + src);
        const float* va = v_s + (j * 8 + 2 * src) * ld + 2 * t;
        const float* vb = va + ld;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          const float2 x = *reinterpret_cast<const float2*>(va + nt * 8);
          const float2 y = *reinterpret_cast<const float2*>(vb + nt * 8);
          acc[nt][0] = fmaf(pg1, y.x, fmaf(pg0, x.x, acc[nt][0]));
          acc[nt][1] = fmaf(pg1, y.y, fmaf(pg0, x.y, acc[nt][1]));
          acc[nt][2] = fmaf(ph1, y.x, fmaf(ph0, x.x, acc[nt][2]));
          acc[nt][3] = fmaf(ph1, y.y, fmaf(ph0, x.y, acc[nt][3]));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// online softmax on the C layout
// ---------------------------------------------------------------------------

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One key tile of the online softmax: m becomes max(m, the tile's row max),
// s becomes p = exp(s - m), acc and l are rescaled by exp(m_old - m) and l
// gains this lane's share of the row sum of p (quad_sum it at the end).
// s - m is taken before the scaling by log2 e, so a fully masked row gets
// exactly p = 1 (a fused multiply-add of -1e30 would not cancel).
template <int NT, int DN>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&acc)[DN][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
    mx = quad_max(mx);
    const float corr = exp2f((m[r] - mx) * LOG2E);
    float sum = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = exp2f((s[nt][2 * r + c] - mx) * LOG2E);
        s[nt][2 * r + c] = p;
        sum += p;
      }
    l[r] = l[r] * corr + sum;
    m[r] = mx;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[dn][2 * r] *= corr;
      acc[dn][2 * r + 1] *= corr;
    }
  }
}

}  // namespace attn
