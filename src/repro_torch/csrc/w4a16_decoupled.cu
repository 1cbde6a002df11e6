// Phases 1 and 3 of the decoupled W4A16 pipeline for Hopper (paper Alg. 1):
// dequant_w4 writes Dequant(W) to a (K, N) workspace in device memory, the
// dense GEMM (dense_gemm.cu, partials mode) reads it back into S fp32
// partials, and reduce_partials sums them and casts. The three launches go
// through device memory on purpose: that round trip is what the paper
// measures against the fused kernel (w4a16_gemm.cu).
//
// Replaces: src/repro/kernels/w4a16_decoupled.py:52 `dequant_w4`
//   (pallas_call at :82, common.dequant_block) and :139 `reduce_partials`
//   (pallas_call at :155); with `splitk_gemm` (:103) they make up
//   `w4a16_decoupled` (:177).
//
// What bounds them on the H100: bytes. dequant_w4 reads K·N/2 packed bytes
//   plus the group scales and writes K·N elements of the activation dtype,
//   with no arithmetic to speak of; reduce_partials reads S·M·N fp32 and
//   writes M·N. The least times are those bytes over 3.35 TB/s. Whether the
//   50 MB L2 keeps the workspace (at most 6912 x 2560 bf16 = 35.4 MB on
//   h2o-danube) between phase 1 and phase 2 is for the card to say: phase 2
//   right after phase 1 is faster than with the L2 flushed (PERF.md), and an
//   L2 evict_last hint on phase 1's stores did not make it faster still.
//
// What the design does about it:
//   * dequant_w4: a thread takes 8 columns of 4 packed rows (8 K rows) and
//     issues their four 8-byte loads before it uses the first; the group
//     scales (and zero-points) of its columns are read once per group, not
//     once per packed row. Each output row gets one 16-byte store (two in
//     fp32), so a warp writes 512 contiguous bytes of a row with one store
//     instruction and the stores fill whole 32-byte sectors (phase 1 is
//     four-fifths writes). The sign extension, zero-point and scale are the
//     plain version's arithmetic, rounded to the activation dtype.
//   * reduce_partials: a thread takes two float4s of outputs, sums each over
//     the slices in fp32 from slice 0 upward (the order of the plain
//     version), casts once and writes each four outputs with one 8-byte
//     store (16 bytes in fp32).

#include "gemm_tile.cuh"

namespace {

using gemm_tile::cvt;
using gemm_tile::load8;
using sm90::pack2;

constexpr int DQ_THREADS = 256;
constexpr int DQ_ROWS = 4;          // packed rows a thread
constexpr int DQ_COLS = 8;          // columns a thread
constexpr int RED_THREADS = 256;
constexpr int RED_VEC = 2;          // float4s of outputs a thread

template <typename T>
__global__ void __launch_bounds__(DQ_THREADS)
dequant_w4_kernel(const int8_t* __restrict__ packed,
                  const float* __restrict__ scales,
                  const float* __restrict__ zeros, T* __restrict__ out,
                  int K, int N, int group) {
  const int cpr = N / DQ_COLS;                    // column groups per row
  const long long idx = (long long)blockIdx.x * DQ_THREADS + threadIdx.x;
  const int P = K / 2;
  if (idx >= (long long)((P + DQ_ROWS - 1) / DQ_ROWS) * cpr) return;
  const int p0 = static_cast<int>(idx / cpr) * DQ_ROWS;
  const int pc = static_cast<int>(idx % cpr) * DQ_COLS;
  const int rows = min(DQ_ROWS, P - p0);
  uint2 w[DQ_ROWS];
#pragma unroll
  for (int r = 0; r < DQ_ROWS; ++r)
    if (r < rows)
      w[r] = *reinterpret_cast<const uint2*>(packed + (size_t)(p0 + r) * N +
                                             pc);
  const bool has_zeros = zeros != nullptr;
  float s[DQ_COLS], z[DQ_COLS] = {};
  int cur = -1;                                   // the group s, z hold
#pragma unroll
  for (int r = 0; r < DQ_ROWS; ++r) {
    if (r >= rows) break;
    const int gr = 2 * (p0 + r) / group;          // rows 2p, 2p+1 share it
    if (gr != cur) {
      load8(s, scales + (size_t)gr * N + pc);
      if (has_zeros) load8(z, zeros + (size_t)gr * N + pc);
      cur = gr;
    }
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&w[r]);
    __align__(16) T tile[2][DQ_COLS];
#pragma unroll
    for (int j = 0; j < DQ_COLS; ++j) {
      const uint8_t u = bytes[j];
      float lo = static_cast<float>(
          static_cast<int8_t>(static_cast<uint8_t>(u << 4)) >> 4);
      float hi = static_cast<float>(static_cast<int8_t>(u) >> 4);
      if (has_zeros) {
        lo -= z[j];
        hi -= z[j];
      }
      tile[0][j] = cvt<T>(lo * s[j]);
      tile[1][j] = cvt<T>(hi * s[j]);
    }
    constexpr int V = 16 / sizeof(T);             // elements per 16 bytes
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < DQ_COLS / V; ++i)
        *reinterpret_cast<uint4*>(out + (size_t)(2 * (p0 + r) + h) * N + pc +
                                  i * V) =
            reinterpret_cast<const uint4*>(tile[h])[i];
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, const float4& v) {
  uint2 packed2;
  packed2.x = pack2<T>(v.x, v.y);
  packed2.y = pack2<T>(v.z, v.w);
  *reinterpret_cast<uint2*>(dst) = packed2;
}
template <>
__device__ __forceinline__ void store4<float>(float* dst, const float4& v) {
  *reinterpret_cast<float4*>(dst) = v;
}

template <typename T>
__global__ void __launch_bounds__(RED_THREADS)
reduce_partials_kernel(const float* __restrict__ partials,
                       T* __restrict__ out, int S, long long MN) {
  const long long f0 =
      ((long long)blockIdx.x * RED_THREADS + threadIdx.x) * RED_VEC;
  float4 acc[RED_VEC];
#pragma unroll
  for (int v = 0; v < RED_VEC; ++v)
    if ((f0 + v) * 4 < MN)
      acc[v] = *reinterpret_cast<const float4*>(partials + (f0 + v) * 4);
  for (int s = 1; s < S; ++s)
#pragma unroll
    for (int v = 0; v < RED_VEC; ++v)
      if ((f0 + v) * 4 < MN) {
        const float4 b = *reinterpret_cast<const float4*>(
            partials + (size_t)s * MN + (f0 + v) * 4);
        acc[v].x += b.x; acc[v].y += b.y; acc[v].z += b.z; acc[v].w += b.w;
      }
#pragma unroll
  for (int v = 0; v < RED_VEC; ++v)
    if ((f0 + v) * 4 < MN) store4<T>(out + (f0 + v) * 4, acc[v]);
}

template <typename T>
cudaError_t launch_dequant(const void* packed, const void* scales,
                           const void* zeros, void* out, int K, int N,
                           int group, cudaStream_t stream) {
  const long long threads =
      (long long)((K / 2 + DQ_ROWS - 1) / DQ_ROWS) * (N / DQ_COLS);
  const unsigned blocks = static_cast<unsigned>((threads + DQ_THREADS - 1) /
                                                DQ_THREADS);
  dequant_w4_kernel<T><<<blocks, DQ_THREADS, 0, stream>>>(
      static_cast<const int8_t*>(packed), static_cast<const float*>(scales),
      static_cast<const float*>(zeros), static_cast<T*>(out), K, N, group);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reduce(const void* partials, void* out, int S, int M,
                          int N, cudaStream_t stream) {
  const long long f4 = (long long)M * N / 4;
  const long long per = (long long)RED_THREADS * RED_VEC;
  const unsigned blocks = static_cast<unsigned>((f4 + per - 1) / per);
  reduce_partials_kernel<T><<<blocks, RED_THREADS, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<T*>(out), S,
      (long long)M * N);
  return cudaGetLastError();
}

}  // namespace

// packed (K/2, N) int8; scales and optional zeros (K/group, N) fp32; out
// (K, N) bf16 (dtype 0), fp16 (1) or fp32 (2). The caller guarantees
// K % 2 == 0, N % 16 == 0, an even group dividing K and 16-byte aligned
// pointers.
extern "C" int dequant_w4(const void* packed, const void* scales,
                          const void* zeros, void* out, int K, int N,
                          int group, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_dequant<__nv_bfloat16>(packed, scales, zeros, out, K, N,
                                        group, s);
  else if (dtype == 1)
    err = launch_dequant<__half>(packed, scales, zeros, out, K, N, group, s);
  else
    err = launch_dequant<float>(packed, scales, zeros, out, K, N, group, s);
  return static_cast<int>(err);
}

// partials (S, M, N) fp32 -> out (M, N) bf16 (dtype 0), fp16 (1) or fp32
// (2). The caller guarantees (M·N) % 4 == 0 and 16-byte aligned pointers.
extern "C" int reduce_partials(const void* partials, void* out, int S, int M,
                               int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_reduce<__nv_bfloat16>(partials, out, S, M, N, s);
  else if (dtype == 1)
    err = launch_reduce<__half>(partials, out, S, M, N, s);
  else
    err = launch_reduce<float>(partials, out, S, M, N, s);
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
