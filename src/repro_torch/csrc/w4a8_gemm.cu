// Fused W4A8 GEMM for Hopper: int8 per-token activations × int4 group
// weights with exact int32 sums per group:
//
//   out[m, n] = Σ_G ws[G, n] · (Σ_g xq[m, G, g]·wq[G, g, n] − z[G, n]·Σ_g xq[m, G, g])
//
// in fp32, one (S, M, N) partial per K slice (direct (M, N) at S = 1). The
// per-token activation scale and the cast stay with the caller, as the JAX
// package applies them in `finalize` outside its pallas_call.
//
// Replaces: src/repro/kernels/w4a8_fused.py:37 `w4a8_fused`
//   (template.tiled_matmul with GroupedInt4Raw and Int8GroupContraction,
//   template.py:233-256 and :341-364; pallas_call at template.py:449/:473).
//
// What bounds it on the H100: bytes. The packed weights (K·N/2) and group
//   scales dominate; int8 activations halve the x bytes of W4A16. The int8
//   tensor cores (1,979 TOP/s) would need ~590 operations per byte before
//   they were the limit; a decode GEMM does about 4·M.
//
// What the design does about it:
//   * INT4 crosses device memory once, packed: a thread loads 16 packed
//     bytes (32 weights) with one 16-byte load and sign-extends both
//     nibbles to int8 in shared memory — no float dequant; the scales stay
//     symbolic until the group ends.
//   * The product runs on the int8 tensor cores: WMMA signed char
//     16x16x16 with int32 accumulators, which stay exact within a group.
//     Every int8 fragment lives in a subtile whose rows are 32 bytes apart
//     (16 used), so each fragment pointer is 32-byte aligned as WMMA needs.
//   * At each group boundary the int32 tiles go through shared memory to
//     fp32: minus z·Σx_q (row sums of the x tile, taken while it sits in
//     shared memory) where the format has zero-points, times the group's
//     scale, into per-thread fp32 accumulators — the Pallas contraction's
//     arithmetic, term for term.
//   * One block per (M tile, 64 columns, K slice) as in the other GEMMs;
//     ragged M masked; the next step's x and packed bytes are loaded into
//     registers while the tensor cores work on the current step.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BN = 64;        // output columns per block: 4 warps x 16
constexpr int THREADS = 128;
constexpr int LDS = 32;       // bytes per row of an int8 fragment subtile

template <int BM, int BK>
__global__ void __launch_bounds__(THREADS)
w4a8_gemm_kernel(const int8_t* __restrict__ xq,
                 const int8_t* __restrict__ packed,
                 const float* __restrict__ scales,
                 const float* __restrict__ zeros, float* __restrict__ out,
                 int M, int N, int K, int group, int k_slice) {
  static_assert(BM % 16 == 0 && BK % 16 == 0 && BK <= 64, "tile shape");
  constexpr int XCH = BM * BK / 16;         // 16-byte chunks of the x tile
  constexpr int XPT = (XCH + THREADS - 1) / THREADS;
  constexpr int WCH = (BK / 2) * (BN / 16); // 16-byte chunks of packed tile
  constexpr int EPT = BM * BN / THREADS;    // fp32 outputs per thread

  __shared__ __align__(128) int8_t xs[BK / 16][BM][LDS];
  __shared__ __align__(128) int8_t ws[BN / 16][BK][LDS];
  __shared__ __align__(128) int ci[BM][BN + 4];
  __shared__ int rsum[BM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int k_begin = split * k_slice;
  const int steps = k_slice / BK;
  const bool has_zeros = zeros != nullptr;

  // this thread's packed chunk: packed row pr of the tile, the 16 columns
  // of subtile sub
  const bool w_owner = tid < WCH;
  const int pr = tid / (BN / 16);
  const int sub = tid % (BN / 16);
  const bool w_in = w_owner && (n0 + sub * 16) < N;

  uint4 wreg = make_uint4(0, 0, 0, 0);
  uint4 xreg[XPT];

  auto load_step = [&](int it) {
    const int k0 = k_begin + it * BK;
    if (w_in)
      wreg = *reinterpret_cast<const uint4*>(
          packed + (size_t)(k0 / 2 + pr) * N + n0 + sub * 16);
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int c = tid + i * THREADS;
      xreg[i] = make_uint4(0, 0, 0, 0);
      if (c < XCH) {
        const int r = c / (BK / 16), kc = c % (BK / 16);
        if (m0 + r < M)
          xreg[i] = *reinterpret_cast<const uint4*>(
              xq + (size_t)(m0 + r) * K + k0 + kc * 16);
      }
    }
  };

  auto store_step = [&]() {
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int c = tid + i * THREADS;
      if (c < XCH) {
        const int r = c / (BK / 16), kc = c % (BK / 16);
        *reinterpret_cast<uint4*>(&xs[kc][r][0]) = xreg[i];
      }
    }
    if (w_owner) {
      // sign-extend both nibbles: even K rows low, odd rows high
      const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&wreg);
      __align__(16) int8_t lo[16];
      __align__(16) int8_t hi[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint8_t u = bytes[j];
        lo[j] = static_cast<int8_t>(static_cast<uint8_t>(u << 4)) >> 4;
        hi[j] = static_cast<int8_t>(u) >> 4;
      }
      *reinterpret_cast<uint4*>(&ws[sub][2 * pr][0]) =
          *reinterpret_cast<const uint4*>(lo);
      *reinterpret_cast<uint4*>(&ws[sub][2 * pr + 1][0]) =
          *reinterpret_cast<const uint4*>(hi);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[BM / 16];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) wmma::fill_fragment(acc[i], 0);
  float facc[EPT] = {};
  int xsum = 0;                 // Σ x_q of row tid over the current group

  if (steps > 0) load_step(0);
  for (int it = 0; it < steps; ++it) {
    store_step();
    __syncthreads();
    if (it + 1 < steps) load_step(it + 1);
    if (has_zeros && tid < BM) {
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
        for (int j = 0; j < 16; ++j) xsum += xs[kc][tid][j];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                     wmma::row_major> b;
      wmma::load_matrix_sync(b, &ws[warp][kk * 16][0], LDS);
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, &xs[kk][i * 16][0], LDS);
        wmma::mma_sync(acc[i], a, b, acc[i]);
      }
    }
    const int k_end = k_begin + (it + 1) * BK;
    if (k_end % group == 0) {               // this step closes a group
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {
        wmma::store_matrix_sync(&ci[i * 16][warp * 16], acc[i], BN + 4,
                                wmma::mem_row_major);
        wmma::fill_fragment(acc[i], 0);
      }
      if (has_zeros && tid < BM) {
        rsum[tid] = xsum;
        xsum = 0;
      }
      __syncthreads();
      const size_t g = (size_t)(k_end - 1) / group;
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int idx = tid + e * THREADS;
        const int r = idx / BN, c = idx % BN, n = n0 + c;
        if (n < N) {
          float v = static_cast<float>(ci[r][c]);
          if (has_zeros)
            v -= zeros[g * N + n] * static_cast<float>(rsum[r]);
          facc[e] += v * scales[g * N + n];
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int idx = tid + e * THREADS;
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) out[((size_t)split * M + m) * N + n] = facc[e];
  }
}

template <int BM, int BK>
cudaError_t launch(const void* xq, const void* packed, const void* scales,
                   const void* zeros, void* out, int M, int N, int K,
                   int group, int split_k, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split_k);
  w4a8_gemm_kernel<BM, BK><<<grid, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(zeros),
      static_cast<float*>(out), M, N, K, group, K / split_k);
  return cudaGetLastError();
}

}  // namespace

// xq (M, K) int8; packed (K/2, N) int8; scales and optional zeros
// (K/group, N) fp32; out (split_k, M, N) fp32 (the direct result at
// split_k = 1). The caller guarantees group % 32 == 0, (K/split_k) % group
// == 0, N % 16 == 0 and 16-byte aligned pointers.
extern "C" int w4a8_gemm(const void* xq, const void* packed,
                         const void* scales, const void* zeros, void* out,
                         int M, int N, int K, int group, int split_k,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bk64 = group % 64 == 0;
  cudaError_t err;
  if (M <= 16)
    err = bk64 ? launch<16, 64>(xq, packed, scales, zeros, out, M, N, K,
                                group, split_k, s)
               : launch<16, 32>(xq, packed, scales, zeros, out, M, N, K,
                                group, split_k, s);
  else
    err = bk64 ? launch<32, 64>(xq, packed, scales, zeros, out, M, N, K,
                                group, split_k, s)
               : launch<32, 32>(xq, packed, scales, zeros, out, M, N, K,
                                group, split_k, s);
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
