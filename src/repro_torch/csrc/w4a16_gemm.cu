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
//   specialisation yet. The tile loop, the packed-chunk dequant
//   (PackedChunk) and the fp32 variant live in gemm_tile.cuh, shared with
//   the dense and W8A16 GEMMs; this file is the int4-group weight stage's
//   entry point.

#include "gemm_tile.cuh"

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
  const gemm_tile::Int4GroupArgs a{static_cast<const int8_t*>(packed),
                                   static_cast<const float*>(scales),
                                   static_cast<const float*>(zeros), group};
  return static_cast<int>(gemm_tile::run<gemm_tile::Int4GroupStage>(
      dtype, x, a, out, M, N, K, split_k, direct,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
