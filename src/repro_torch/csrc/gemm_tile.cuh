// The tile loop shared by the port's float-contraction GEMMs, with the
// weight stage as a template parameter: the Hopper counterpart of the JAX
// package's stage template (src/repro/kernels/template.py, tiled_matmul
// with a weight stage and FloatContraction).
//
// Weight stages (each produces one BK x 64 weight tile in shared memory, in
// the activation dtype, from registers it loaded the step before):
//   * Int4GroupStage   — packed int4 pairs along K with fp32 group scales
//                        (and zero-points): GroupedInt4Dequant, the fused
//                        W4A16 kernel (w4a16_gemm.cu);
//   * Int8ChannelStage — int8 rows with one fp32 scale (and zero-point) per
//                        output column: ChannelInt8Dequant (w8a16_gemm.cu);
//   * DenseStage       — a (K, N) weight already in the activation dtype:
//                        DenseWeight (dense_gemm.cu, and phase 2 of the
//                        decoupled W4A16 pipeline).
//
// One block per (M tile, 64 columns, K slice); ragged M is masked in the
// kernel. bf16/fp16 activations run WMMA 16x16x16 with fp32 accumulators
// from shared memory, with the next step's operands loaded into registers
// while the tensor cores work on the current one. fp32 activations run a
// CUDA-core FMA variant of the same blocks and stages. A block writes the
// output in the activation dtype (direct, split_k == 1) or its K slice's
// fp32 partials (split_k, M, N).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <mma.h>
#include <stdint.h>

namespace gemm_tile {

using namespace nvcuda;

constexpr int BN = 64;        // output columns per block: 4 warps x 16
constexpr int THREADS = 128;
constexpr int PAD = 8;        // row padding (elements) of the 16-bit tiles

template <typename T> __device__ __forceinline__ T cvt(float v);
template <> __device__ __forceinline__ __nv_bfloat16 cvt(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half cvt(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ float cvt(float v) { return v; }

// One thread's share of a BK-row packed tile: 16 packed bytes (packed row
// pr, 16 columns at pc, so 32 weights) with their group's scales and
// zero-points. Columns past N keep zero bytes, scales and zero-points, so
// their (unstored) outputs stay finite.
struct PackedChunk {
  uint4 w = make_uint4(0, 0, 0, 0);
  float s[16] = {}, z[16] = {};

  __device__ __forceinline__ void load(const int8_t* packed,
                                       const float* scales,
                                       const float* zeros, int N, int group,
                                       int k0, int pr, int col) {
    w = *reinterpret_cast<const uint4*>(packed + (size_t)(k0 / 2 + pr) * N +
                                        col);
    const int g = (k0 + 2 * pr) / group;       // rows 2pr, 2pr+1 share it
    const float4* sp =
        reinterpret_cast<const float4*>(scales + (size_t)g * N + col);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = sp[i];
      s[4 * i] = v.x; s[4 * i + 1] = v.y; s[4 * i + 2] = v.z;
      s[4 * i + 3] = v.w;
    }
    if (zeros != nullptr) {
      const float4* zp =
          reinterpret_cast<const float4*>(zeros + (size_t)g * N + col);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = zp[i];
        z[4 * i] = v.x; z[4 * i + 1] = v.y; z[4 * i + 2] = v.z;
        z[4 * i + 3] = v.w;
      }
    }
  }

  // sign-extend both nibbles, apply zero-point and scale, round to T and
  // write rows 2pr and 2pr+1, columns pc..pc+15 of the weight tile
  template <typename T, int LD>
  __device__ __forceinline__ void dequant(T (*ws)[LD], int pr, int pc,
                                          bool has_zeros) const {
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&w);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint8_t u = bytes[j];
      float lo = static_cast<float>(
          static_cast<int8_t>(static_cast<uint8_t>(u << 4)) >> 4);
      float hi = static_cast<float>(static_cast<int8_t>(u) >> 4);
      if (has_zeros) {
        lo -= z[j];
        hi -= z[j];
      }
      ws[2 * pr][pc + j] = cvt<T>(lo * s[j]);
      ws[2 * pr + 1][pc + j] = cvt<T>(hi * s[j]);
    }
  }
};

// ---------------------------------------------------------------------------
// weight stages: init once per block, load(k0) global -> registers,
// store() registers -> the shared BK x BN tile in T
// ---------------------------------------------------------------------------

struct Int4GroupArgs {
  const int8_t* packed;       // (K/2, N)
  const float* scales;        // (K/group, N)
  const float* zeros;         // same, or nullptr
  int group;
};

template <typename T, int BK>
struct Int4GroupStage {
  using Args = Int4GroupArgs;
  static constexpr int WCH = (BK / 2) * (BN / 16);   // 16-byte chunks
  static_assert(WCH <= THREADS, "one packed chunk per thread at most");
  PackedChunk wc;
  bool owner, in;
  int pr, pc;

  __device__ __forceinline__ void init(const Args&, int N, int n0, int tid) {
    owner = tid < WCH;
    pr = tid / (BN / 16);
    pc = (tid % (BN / 16)) * 16;
    in = owner && (n0 + pc) < N;
  }
  __device__ __forceinline__ void load(const Args& a, int N, int k0, int n0) {
    if (in) wc.load(a.packed, a.scales, a.zeros, N, a.group, k0, pr, n0 + pc);
  }
  template <int LD>
  __device__ __forceinline__ void store(T (*ws)[LD], const Args& a) const {
    if (owner) wc.dequant(ws, pr, pc, a.zeros != nullptr);
  }
};

struct Int8ChannelArgs {
  const int8_t* rows;         // (K, N)
  const float* scales;        // (1, N)
  const float* zeros;         // (1, N) or nullptr
};

// (q - z) * s in fp32, rounded to T (common.dequant_channel_block). Each
// thread keeps the same 16 columns for the whole K loop, so their scales
// and zero-points are loaded once.
template <typename T, int BK>
struct Int8ChannelStage {
  using Args = Int8ChannelArgs;
  static constexpr int CPR = BN / 16;                 // chunks per tile row
  static constexpr int RSTEP = THREADS / CPR;
  static constexpr int CPT = BK / RSTEP;              // chunks per thread
  static_assert(BK % RSTEP == 0, "whole chunks per thread");
  uint4 w[CPT];
  float s[16] = {}, z[16] = {};
  int r0, c;
  bool in;

  __device__ __forceinline__ void init(const Args& a, int N, int n0,
                                       int tid) {
    c = (tid % CPR) * 16;
    r0 = tid / CPR;
    in = (n0 + c) < N;
#pragma unroll
    for (int i = 0; i < CPT; ++i) w[i] = make_uint4(0, 0, 0, 0);
    if (!in) return;
    const float4* sp = reinterpret_cast<const float4*>(a.scales + n0 + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = sp[i];
      s[4 * i] = v.x; s[4 * i + 1] = v.y; s[4 * i + 2] = v.z;
      s[4 * i + 3] = v.w;
    }
    if (a.zeros != nullptr) {
      const float4* zp = reinterpret_cast<const float4*>(a.zeros + n0 + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = zp[i];
        z[4 * i] = v.x; z[4 * i + 1] = v.y; z[4 * i + 2] = v.z;
        z[4 * i + 3] = v.w;
      }
    }
  }
  __device__ __forceinline__ void load(const Args& a, int N, int k0, int n0) {
    if (!in) return;
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      w[i] = *reinterpret_cast<const uint4*>(
          a.rows + (size_t)(k0 + r0 + i * RSTEP) * N + n0 + c);
  }
  template <int LD>
  __device__ __forceinline__ void store(T (*ws)[LD], const Args& a) const {
    const bool has_zeros = a.zeros != nullptr;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int8_t* q = reinterpret_cast<const int8_t*>(&w[i]);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float v = static_cast<float>(q[j]);
        if (has_zeros) v -= z[j];
        ws[r0 + i * RSTEP][c + j] = cvt<T>(v * s[j]);
      }
    }
  }
};

struct DenseArgs {
  const void* w;              // (K, N) in the activation dtype
};

template <typename T, int BK>
struct DenseStage {
  using Args = DenseArgs;
  static constexpr int VEC = 16 / sizeof(T);          // elements per chunk
  static constexpr int CPR = BN / VEC;
  static constexpr int RSTEP = THREADS / CPR;
  static constexpr int CPT = BK / RSTEP;
  static_assert(BK % RSTEP == 0, "whole chunks per thread");
  uint4 w[CPT];
  int r0, c;
  bool in;

  __device__ __forceinline__ void init(const Args&, int N, int n0, int tid) {
    c = (tid % CPR) * VEC;
    r0 = tid / CPR;
    in = (n0 + c) < N;
#pragma unroll
    for (int i = 0; i < CPT; ++i) w[i] = make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void load(const Args& a, int N, int k0, int n0) {
    if (!in) return;
    const T* wp = static_cast<const T*>(a.w);
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      w[i] = *reinterpret_cast<const uint4*>(
          wp + (size_t)(k0 + r0 + i * RSTEP) * N + n0 + c);
  }
  template <int LD>
  __device__ __forceinline__ void store(T (*ws)[LD], const Args&) const {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const T* v = reinterpret_cast<const T*>(&w[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) ws[r0 + i * RSTEP][c + j] = v[j];
    }
  }
};

// ---------------------------------------------------------------------------
// the tile loops
// ---------------------------------------------------------------------------

template <typename T, int BM, int BK, template <typename, int> class Stage>
__global__ void __launch_bounds__(THREADS)
tc_gemm_kernel(const T* __restrict__ x, typename Stage<T, BK>::Args wa,
               T* __restrict__ out, float* __restrict__ partials, int M,
               int N, int K, int k_slice, int direct) {
  static_assert(BM % 16 == 0 && BK % 16 == 0, "wmma tiles are 16x16x16");
  constexpr int XCH = BM * BK / 8;          // 16-byte chunks of the x tile
  constexpr int XPT = (XCH + THREADS - 1) / THREADS;

  __shared__ __align__(128) T xs[BM][BK + PAD];
  __shared__ __align__(128) T ws[BK][BN + PAD];
  __shared__ __align__(128) float cs[BM][BN + 4];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int k_begin = split * k_slice;
  const int steps = k_slice / BK;

  Stage<T, BK> st;
  st.init(wa, N, n0, tid);
  uint4 xreg[XPT];

  auto load_step = [&](int it) {
    const int k0 = k_begin + it * BK;
    st.load(wa, N, k0, n0);
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int c = tid + i * THREADS;
      xreg[i] = make_uint4(0, 0, 0, 0);
      if (c < XCH) {
        const int r = c / (BK / 8);
        const int col = (c % (BK / 8)) * 8;
        if (m0 + r < M)
          xreg[i] = *reinterpret_cast<const uint4*>(
              x + (size_t)(m0 + r) * K + k0 + col);
      }
    }
  };

  auto store_step = [&]() {
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int c = tid + i * THREADS;
      if (c < XCH) {
        const int r = c / (BK / 8);
        const int col = (c % (BK / 8)) * 8;
        *reinterpret_cast<uint4*>(&xs[r][col]) = xreg[i];
      }
    }
    st.store(ws, wa);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BM / 16];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) wmma::fill_fragment(acc[i], 0.0f);

  if (steps > 0) load_step(0);
  for (int it = 0; it < steps; ++it) {
    store_step();
    __syncthreads();
    if (it + 1 < steps) load_step(it + 1);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
      wmma::load_matrix_sync(b, &ws[kk * 16][warp * 16], BN + PAD);
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::load_matrix_sync(a, &xs[i * 16][kk * 16], BK + PAD);
        wmma::mma_sync(acc[i], a, b, acc[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
    wmma::store_matrix_sync(&cs[i * 16][warp * 16], acc[i], BN + 4,
                            wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) {
      if (direct)
        out[(size_t)m * N + n] = cvt<T>(cs[r][c]);
      else
        partials[((size_t)split * M + m) * N + n] = cs[r][c];
    }
  }
}

// fp32 activations: the same blocks and weight stages, with the product
// accumulated by FMA on the CUDA cores (the tensor cores take no fp32
// operands at fp32 precision). Thread t owns column t % BN and rows
// t / BN + j * (THREADS / BN) of the block's tile. Partials and the direct
// output are both fp32, so one store serves both (split 0 of a direct
// launch is the output itself).
template <int BM, template <typename, int> class Stage>
__global__ void __launch_bounds__(THREADS)
f32_gemm_kernel(const float* __restrict__ x,
                typename Stage<float, 32>::Args wa, float* __restrict__ out,
                int M, int N, int K, int k_slice) {
  constexpr int BK = 32;
  constexpr int RSTEP = THREADS / BN;
  constexpr int RPT = BM / RSTEP;

  __shared__ float xs[BM][BK];
  __shared__ float ws[BK][BN + 1];

  const int tid = threadIdx.x;
  const int col = tid % BN, row0 = tid / BN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int k_begin = split * k_slice;

  Stage<float, BK> st;
  st.init(wa, N, n0, tid);
  float acc[RPT] = {};
  for (int k0 = k_begin; k0 < k_begin + k_slice; k0 += BK) {
    st.load(wa, N, k0, n0);
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      xs[r][c] = m0 + r < M ? x[(size_t)(m0 + r) * K + k0 + c] : 0.0f;
    }
    st.store(ws, wa);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float w = ws[k][col];
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        acc[j] = fmaf(xs[row0 + j * RSTEP][k], w, acc[j]);
    }
    __syncthreads();
  }
  const int n = n0 + col;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int m = m0 + row0 + j * RSTEP;
    if (m < M && n < N) out[((size_t)split * M + m) * N + n] = acc[j];
  }
}

template <typename T, int BM, int BK, template <typename, int> class Stage,
          typename Args>
cudaError_t launch_tc(const void* x, const Args& wa, void* out, int M, int N,
                      int K, int split_k, int direct, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split_k);
  tc_gemm_kernel<T, BM, BK, Stage><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), wa, direct ? static_cast<T*>(out) : nullptr,
      direct ? nullptr : static_cast<float*>(out), M, N, K, K / split_k,
      direct);
  return cudaGetLastError();
}

template <typename T, template <typename, int> class Stage, typename Args>
cudaError_t dispatch_tc(const void* x, const Args& wa, void* out, int M,
                        int N, int K, int split_k, int direct,
                        cudaStream_t stream) {
  const bool bk64 = (K / split_k) % 64 == 0;
  if (M <= 16)
    return bk64 ? launch_tc<T, 16, 64, Stage>(x, wa, out, M, N, K, split_k,
                                              direct, stream)
                : launch_tc<T, 16, 32, Stage>(x, wa, out, M, N, K, split_k,
                                              direct, stream);
  return bk64 ? launch_tc<T, 32, 64, Stage>(x, wa, out, M, N, K, split_k,
                                            direct, stream)
              : launch_tc<T, 32, 32, Stage>(x, wa, out, M, N, K, split_k,
                                            direct, stream);
}

template <int BM, template <typename, int> class Stage, typename Args>
cudaError_t launch_f32(const void* x, const Args& wa, void* out, int M, int N,
                       int K, int split_k, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split_k);
  f32_gemm_kernel<BM, Stage><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), wa, static_cast<float*>(out), M, N, K,
      K / split_k);
  return cudaGetLastError();
}

// x (M, K) bf16 (dtype 0), fp16 (dtype 1) or fp32 (dtype 2). direct=1
// writes out (M, N) in the x dtype (split_k must be 1); direct=0 writes fp32
// partials (split_k, M, N). The caller guarantees K % split_k == 0,
// (K/split_k) % 32 == 0, K % 8 == 0, N % 16 == 0 and 16-byte aligned
// pointers.
template <template <typename, int> class Stage, typename Args>
cudaError_t run(int dtype, const void* x, const Args& wa, void* out, int M,
                int N, int K, int split_k, int direct, cudaStream_t stream) {
  if (dtype == 0)
    return dispatch_tc<__nv_bfloat16, Stage>(x, wa, out, M, N, K, split_k,
                                             direct, stream);
  if (dtype == 1)
    return dispatch_tc<__half, Stage>(x, wa, out, M, N, K, split_k, direct,
                                      stream);
  return M <= 16
             ? launch_f32<16, Stage>(x, wa, out, M, N, K, split_k, stream)
             : launch_f32<32, Stage>(x, wa, out, M, N, K, split_k, stream);
}

}  // namespace gemm_tile
