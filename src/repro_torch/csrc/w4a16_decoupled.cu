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
//   h2o-danube) between phase 1 and phase 2 is for the card to say.
//
// What the design does about it:
//   * dequant_w4: one thread per 16 packed bytes (32 weights, one 16-byte
//     load), the sign extension, zero-point and scale of PackedChunk
//     (gemm_tile.cuh; the plain version's arithmetic), rounded to the
//     activation dtype and written with 16-byte stores; neighbouring
//     threads cover neighbouring columns, so loads and stores coalesce.
//   * reduce_partials: one thread per 4 outputs, float4 loads of each
//     partial slice, summed in fp32 from slice 0 upward (the order of the
//     plain version), then one cast.

#include "gemm_tile.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
dequant_w4_kernel(const int8_t* __restrict__ packed,
                  const float* __restrict__ scales,
                  const float* __restrict__ zeros, T* __restrict__ out,
                  int K, int N, int group) {
  const int cpr = N / 16;                         // packed chunks per row
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)(K / 2) * cpr) return;
  const int pr = static_cast<int>(idx / cpr);
  const int pc = static_cast<int>(idx % cpr) * 16;
  gemm_tile::PackedChunk wc;
  wc.load(packed, scales, zeros, N, group, 0, pr, pc);
  __align__(16) T tile[2][16];
  wc.dequant<T, 16>(tile, 0, 0, zeros != nullptr);
  constexpr int V = 16 / sizeof(T);               // elements per 16 bytes
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 16 / V; ++i)
      *reinterpret_cast<uint4*>(out + (size_t)(2 * pr + r) * N + pc +
                                i * V) =
          reinterpret_cast<const uint4*>(tile[r])[i];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
reduce_partials_kernel(const float* __restrict__ partials,
                       T* __restrict__ out, int S, long long MN) {
  const long long i4 = ((long long)blockIdx.x * THREADS + threadIdx.x) * 4;
  if (i4 >= MN) return;
  float4 acc = *reinterpret_cast<const float4*>(partials + i4);
  for (int s = 1; s < S; ++s) {
    const float4 v =
        *reinterpret_cast<const float4*>(partials + (size_t)s * MN + i4);
    acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
  }
  out[i4] = gemm_tile::cvt<T>(acc.x);
  out[i4 + 1] = gemm_tile::cvt<T>(acc.y);
  out[i4 + 2] = gemm_tile::cvt<T>(acc.z);
  out[i4 + 3] = gemm_tile::cvt<T>(acc.w);
}

template <typename T>
cudaError_t launch_dequant(const void* packed, const void* scales,
                           const void* zeros, void* out, int K, int N,
                           int group, cudaStream_t stream) {
  const long long chunks = (long long)(K / 2) * (N / 16);
  const unsigned blocks = static_cast<unsigned>((chunks + THREADS - 1) /
                                                THREADS);
  dequant_w4_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(packed), static_cast<const float*>(scales),
      static_cast<const float*>(zeros), static_cast<T*>(out), K, N, group);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reduce(const void* partials, void* out, int S, int M,
                          int N, cudaStream_t stream) {
  const long long mn = (long long)M * N;
  const unsigned blocks = static_cast<unsigned>((mn / 4 + THREADS - 1) /
                                                THREADS);
  reduce_partials_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<T*>(out), S, mn);
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
