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
// What the design does about it:
//   * The int8 rows cross device memory once, as 16-byte loads (16
//     weights) taken one step ahead of the tensor cores; each thread
//     dequantizes its 16 weights as (q - z)·s in fp32 and rounds them to
//     the activation dtype in shared memory, as the Pallas stage does
//     before its dot. The dequantized weight never exists in device memory.
//   * A thread keeps the same 16 columns for the whole K loop, so their
//     scales and zero-points are read once per block.
//   * The shared tile loop of gemm_tile.cuh (Int8ChannelStage): one block
//     per (M tile, 64 columns, K slice), ragged M masked, WMMA with fp32
//     accumulation for bf16/fp16 and a CUDA-core FMA variant for fp32. The
//     planner's choose_split_k returns 1 for channel formats (group = K),
//     so the serving path launches the direct mode.

#include "gemm_tile.cuh"

// x (M, K) bf16 (dtype 0), fp16 (1) or fp32 (2); rows (K, N) int8; scales
// and optional zeros (1, N) fp32. direct=1 writes out (M, N) in the x dtype
// (split_k must be 1); direct=0 writes fp32 partials (split_k, M, N). The
// caller guarantees (K/split_k) % 32 == 0, K % 8 == 0, N % 16 == 0 and
// 16-byte aligned pointers.
extern "C" int w8a16_gemm(const void* x, const void* rows, const void* scales,
                          const void* zeros, void* out, int M, int N, int K,
                          int split_k, int dtype, int direct, void* stream) {
  const gemm_tile::Int8ChannelArgs a{static_cast<const int8_t*>(rows),
                                     static_cast<const float*>(scales),
                                     static_cast<const float*>(zeros)};
  return static_cast<int>(gemm_tile::run<gemm_tile::Int8ChannelStage>(
      dtype, x, a, out, M, N, K, split_k, direct,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
