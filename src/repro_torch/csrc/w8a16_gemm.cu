// Fused W8A16 GEMM for Hopper: C[M, N] = x[M, K] · Dequant(W[K, N]) with
// int8 weight rows and one fp32 scale (and zero-point) per output column.
//
// Replaces: src/repro/kernels/w8a16_fused.py:29 `w8a16_fused`
//   (template.tiled_matmul with ChannelInt8Dequant —
//   common.dequant_channel_block — and FloatContraction; pallas_call at
//   template.py:449 and :473).
//
// What bounds it on the H100: bytes. The weight is K·N int8 bytes — half
//   the dense bf16 weight, twice the packed int4 one — and at decode M it
//   feeds only ~2·M FLOP per byte, far below the tensor cores' ~295
//   FLOP/byte. The least time is K·N + 4·N bytes (plus x and the output)
//   over 3.35 TB/s.
//
// What the design does about it (the tile loop of gemm_tile.cuh with its
//   Int8Ring stage):
//   * The int8 rows cross device memory once through the 4-stage cp.async
//     ring (128 rows of 64 columns a stage; rows padded to 80 bytes so the
//     two rows of a K pair fall in different banks).
//   * Rows k and k + 1 of a column make one mma A register: each thread
//     reads eight columns of both rows with two 8-byte shared loads, turns
//     each byte into an exact fp32 (2^23 magic-number trick), computes
//     (q - z)·s in fp32 and rounds the pair to the activation dtype, as the
//     Pallas stage does before its dot. A thread keeps the same eight
//     columns for all of K, so their scales and zero-points are read once.
//   * The planner's choose_split_k returns 1 for channel formats (group =
//     K); the kernel still splits K into a cluster of blocks that sum in
//     distributed shared memory, so the output is one launch in the
//     activation dtype, and fp32 activations take the CUDA-core variant.

#include "gemm_tile.cuh"

// x (M, K) bf16 (dtype 0), fp16 (1) or fp32 (2); rows (K, N) int8; scales
// and optional zeros (1, N) fp32. direct=1 writes out (M, N) in the x
// dtype (split_k ≤ 8; 1 in fp32); direct=0 writes fp32 partials
// (split_k, M, N). batch > 1 runs an expert stack in the one launch, as
// w4a16_gemm does (w_stride in bytes of rows, s_stride in floats). bm ..
// smem: the wrapper's gemm_geometry. The caller guarantees
// (K/split_k) % 32 == 0, K % 8 == 0, N % 16 == 0 and 16-byte aligned
// pointers and strides.
extern "C" int w8a16_gemm(const void* x, const void* rows, const void* scales,
                          const void* zeros, void* out, int M, int N, int K,
                          int split_k, int dtype, int direct, int bm, int bk,
                          int stages, int ks, int cluster, int smem,
                          int batch, long long x_stride, long long w_stride,
                          long long s_stride, long long out_stride,
                          void* stream) {
  const gemm_tile::Int8ChannelArgs a{static_cast<const int8_t*>(rows),
                                     static_cast<const float*>(scales),
                                     static_cast<const float*>(zeros)};
  const gemm_tile::Launch want{bm, bk, stages, ks, cluster, smem};
  const gemm_tile::Batch b{batch, x_stride, w_stride, s_stride, out_stride};
  return static_cast<int>(
      gemm_tile::run<gemm_tile::Int8Ring, gemm_tile::Int8ChannelStage>(
          gemm_tile::INT8, dtype, x, a, out, M, N, K, split_k, direct, 0,
          zeros != nullptr, want, static_cast<cudaStream_t>(stream), b));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
