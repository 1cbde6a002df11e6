// Dense GEMM for Hopper: C[M, N] = x[M, K] · w[K, N], w already in x's
// dtype — the FP16×FP16 baseline of the paper, and phase 2 of the decoupled
// W4A16 pipeline.
//
// Replaces: src/repro/kernels/gemm.py:20 `gemm` (template.tiled_matmul with
//   DenseWeight and FloatContraction, pallas_call at template.py:449, direct
//   output) and src/repro/kernels/w4a16_decoupled.py:103 `splitk_gemm` (the
//   same composition at template.py:473 with reduce_splits=False: raw
//   (S, M, N) fp32 partials, kept even at S = 1).
//
// What bounds it on the H100: bytes. At the serving path's M (8 decode
//   slots, 32-token prefill chunks) every 2-byte weight feeds M
//   multiply-adds: about M FLOP per byte read, far below the ~295 FLOP/byte
//   the card needs before its tensor cores are the limit. The least time is
//   the dense weight (2·K·N bytes) over 3.35 TB/s — four times the packed
//   int4 bytes of the fused W4A16 kernel.
//
// What the design does about it:
//   * The weight tile crosses device memory once, as 16-byte loads that
//     neighbouring threads take from neighbouring addresses, loaded into
//     registers one step ahead of the tensor cores (the shared tile loop of
//     gemm_tile.cuh with its DenseStage).
//   * One block per (M tile, 64 columns, K slice); the K slice is the
//     planner's Split-K degree, so a decode GEMM puts enough blocks on the
//     132 SMs. Two output modes: the output in x's dtype (gemm, split 1),
//     or the K slice's fp32 partials (splitk_gemm, any S, 1 included).
//   * bf16/fp16 run WMMA with fp32 accumulation; fp32 runs the CUDA-core
//     FMA variant. No TMA, no wgmma yet.

#include "gemm_tile.cuh"

// x (M, K) and w (K, N) both bf16 (dtype 0), fp16 (1) or fp32 (2).
// direct=1 writes out (M, N) in that dtype (split_k must be 1); direct=0
// writes fp32 partials (split_k, M, N). The caller guarantees
// (K/split_k) % 32 == 0, K % 8 == 0, N % 16 == 0 and 16-byte aligned
// pointers.
extern "C" int dense_gemm(const void* x, const void* w, void* out, int M,
                          int N, int K, int split_k, int dtype, int direct,
                          void* stream) {
  const gemm_tile::DenseArgs a{w};
  return static_cast<int>(gemm_tile::run<gemm_tile::DenseStage>(
      dtype, x, a, out, M, N, K, split_k, direct,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
