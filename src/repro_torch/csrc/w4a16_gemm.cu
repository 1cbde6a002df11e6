// Fused W4A16 GEMM for Hopper: C[M, N] = x[M, K] · Dequant(W[K, N]).
//
// Replaces: src/repro/kernels/w4a16_fused.py:37 `w4a16_fused`, which is
//   template.tiled_matmul (pallas_call at template.py:449 data-parallel and
//   :473 Split-K) with the GroupedInt4Dequant weight stage
//   (common.dequant_block) and FloatContraction.
//
// What bounds it on the H100: bytes. On the serving path M is the decode
//   batch (8) or a prefill chunk (32), so every packed weight byte feeds only
//   M multiply-adds per nibble: about 4·M FLOP per byte read, far below the
//   ~295 FLOP/byte the card needs before its tensor cores are the limit. The
//   least time is the packed weights (K·N/2 bytes) plus the fp32 group scales
//   over 3.35 TB/s.
//
// What the design does about it:
//   * INT4 crosses device memory once, packed: each thread loads 16 packed
//     bytes (32 weights) with one 16-byte load, sign-extends both nibbles
//     ((b << 4) >> 4 low, b >> 4 high), applies the fp32 group scale (and
//     zero-point), rounds to the activation dtype and writes the tile to
//     shared memory. The dequantized weight never exists in device memory.
//   * One block per (M tile, N tile, K slice). The K slice is the planner's
//     Split-K degree (choose_split_k with the card's 132 SMs): a decode GEMM
//     has few N tiles, so splitting K is what puts enough blocks on the SMs.
//     With split_k > 1 the block writes fp32 partials (S, M, N) that the
//     wrapper sums, as the JAX package leaves the sum to XLA.
//   * Ragged M is masked in the kernel (rows >= M load zeros and are never
//     stored) instead of padding M in device memory.
//   * The tile product runs on the tensor cores through WMMA (bf16 or fp16
//     inputs, fp32 accumulation) from shared memory. fp32 activations (the
//     reduced test configurations) take a CUDA-core FMA variant of the same
//     blocks, since the tensor cores have no full-precision fp32 product.
//   * The next step's packed bytes, scales and x tile are loaded into
//     registers while the tensor cores work on the current step, so global
//     latency overlaps the math (a two-stage register pipeline).
//   This is the simple first kernel: no TMA, no wgmma, no warp
//   specialisation yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

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

template <typename T, int BM, int BK>
__global__ void __launch_bounds__(THREADS)
w4a16_gemm_kernel(const T* __restrict__ x, const int8_t* __restrict__ packed,
                  const float* __restrict__ scales,
                  const float* __restrict__ zeros, T* __restrict__ out,
                  float* __restrict__ partials, int M, int N, int K,
                  int group, int k_slice, int direct) {
  static_assert(BM % 16 == 0 && BK % 16 == 0, "wmma tiles are 16x16x16");
  constexpr int XCH = BM * BK / 8;          // 16-byte chunks of the x tile
  constexpr int XPT = (XCH + THREADS - 1) / THREADS;
  constexpr int WCH = (BK / 2) * (BN / 16); // 16-byte chunks of packed tile

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

  // this thread's packed chunk: packed row pr of the tile, 16 columns at pc
  const bool w_owner = tid < WCH;
  const int pr = tid / (BN / 16);
  const int pc = (tid % (BN / 16)) * 16;
  const bool w_in = w_owner && (n0 + pc) < N;

  PackedChunk wc;
  uint4 xreg[XPT];

  auto load_step = [&](int it) {
    const int k0 = k_begin + it * BK;
    if (w_in) wc.load(packed, scales, zeros, N, group, k0, pr, n0 + pc);
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
    if (w_owner) wc.dequant(ws, pr, pc, zeros != nullptr);
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

// fp32 activations: the same blocks and the same packed-chunk dequant,
// with the product accumulated by FMA on the CUDA cores (the tensor cores
// take no fp32 operands at fp32 precision). Thread t owns column t % BN and
// rows t / BN + j * (THREADS / BN) of the block's tile. Partials and the
// direct output are both fp32, so one store serves both (split 0 of a
// direct launch is the output itself).
template <int BM>
__global__ void __launch_bounds__(THREADS)
w4a16_gemm_f32_kernel(const float* __restrict__ x,
                      const int8_t* __restrict__ packed,
                      const float* __restrict__ scales,
                      const float* __restrict__ zeros,
                      float* __restrict__ out, int M, int N, int K,
                      int group, int k_slice) {
  constexpr int BK = 32;
  constexpr int RSTEP = THREADS / BN;
  constexpr int RPT = BM / RSTEP;
  constexpr int WCH = (BK / 2) * (BN / 16);

  __shared__ float xs[BM][BK];
  __shared__ float ws[BK][BN + 1];

  const int tid = threadIdx.x;
  const int col = tid % BN, row0 = tid / BN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int k_begin = split * k_slice;

  const bool w_owner = tid < WCH;
  const int pr = tid / (BN / 16);
  const int pc = (tid % (BN / 16)) * 16;
  const bool w_in = w_owner && (n0 + pc) < N;

  PackedChunk wc;
  float acc[RPT] = {};
  for (int k0 = k_begin; k0 < k_begin + k_slice; k0 += BK) {
    if (w_in) wc.load(packed, scales, zeros, N, group, k0, pr, n0 + pc);
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      xs[r][c] = m0 + r < M ? x[(size_t)(m0 + r) * K + k0 + c] : 0.0f;
    }
    if (w_owner) wc.dequant(ws, pr, pc, zeros != nullptr);
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

template <typename T, int BM, int BK>
cudaError_t launch(const void* x, const void* packed, const void* scales,
                   const void* zeros, void* out, int M, int N, int K,
                   int group, int split_k, int direct, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split_k);
  w4a16_gemm_kernel<T, BM, BK><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(zeros),
      direct ? static_cast<T*>(out) : nullptr,
      direct ? nullptr : static_cast<float*>(out), M, N, K, group,
      K / split_k, direct);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* packed, const void* scales,
                     const void* zeros, void* out, int M, int N, int K,
                     int group, int split_k, int direct,
                     cudaStream_t stream) {
  const bool bk64 = (K / split_k) % 64 == 0;
  if (M <= 16) {
    return bk64 ? launch<T, 16, 64>(x, packed, scales, zeros, out, M, N, K,
                                    group, split_k, direct, stream)
                : launch<T, 16, 32>(x, packed, scales, zeros, out, M, N, K,
                                    group, split_k, direct, stream);
  }
  return bk64 ? launch<T, 32, 64>(x, packed, scales, zeros, out, M, N, K,
                                  group, split_k, direct, stream)
              : launch<T, 32, 32>(x, packed, scales, zeros, out, M, N, K,
                                  group, split_k, direct, stream);
}

template <int BM>
cudaError_t launch_f32(const void* x, const void* packed, const void* scales,
                       const void* zeros, void* out, int M, int N, int K,
                       int group, int split_k, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split_k);
  w4a16_gemm_f32_kernel<BM><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(zeros),
      static_cast<float*>(out), M, N, K, group, K / split_k);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 (dtype 0), fp16 (dtype 1) or fp32 (dtype 2); packed
// (K/2, N) int8; scales and optional zeros (K/group, N) fp32. direct=1
// writes out (M, N) in the x dtype (split_k must be 1); direct=0 writes fp32
// partials (split_k, M, N). The caller guarantees K % split_k == 0,
// (K/split_k) % 32 == 0, K % 8 == 0, N % 16 == 0, an even group size and
// 16-byte aligned pointers.
extern "C" int w4a16_gemm(const void* x, const void* packed,
                          const void* scales, const void* zeros, void* out,
                          int M, int N, int K, int group, int split_k,
                          int dtype, int direct, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<__nv_bfloat16>(x, packed, scales, zeros, out, M, N, K,
                                  group, split_k, direct, s);
  else if (dtype == 1)
    err = dispatch<__half>(x, packed, scales, zeros, out, M, N, K, group,
                           split_k, direct, s);
  else
    err = M <= 16 ? launch_f32<16>(x, packed, scales, zeros, out, M, N, K,
                                   group, split_k, s)
                  : launch_f32<32>(x, packed, scales, zeros, out, M, N, K,
                                   group, split_k, s);
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
