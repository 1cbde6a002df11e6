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
// What the design does about it (the tile loop of gemm_tile.cuh with its
//   DenseRing stage):
//   * The weight crosses device memory once through a 4-stage cp.async ring
//     (64 K rows of 64 columns a stage, 8 KB in bf16), so up to 24 KB of
//     weights per block are in flight while the warps multiply; rows are
//     padded to an odd count of 16-byte chunks for conflict-free ldmatrix.
//   * mma.sync.m16n8k16 with the weight as the 16-row operand: its A
//     fragments come from the stage by ldmatrix.trans, x's by ldmatrix, so
//     M = 8 fills one n8 tile with no padded rows.
//   * The output tile's K is cut into a cluster of blocks that sum their
//     tiles through distributed shared memory in a fixed order, so a decode
//     GEMM puts enough blocks on the 132 SMs. Two output modes: the output
//     in x's dtype (gemm, direct), or the plan slices' fp32 partials
//     (splitk_gemm, any S, 1 included). fp32 runs the CUDA-core FMA
//     variant.

#include "gemm_tile.cuh"

// x (M, K) and w (K, N) both bf16 (dtype 0), fp16 (1) or fp32 (2).
// direct=1 writes out (M, N) in that dtype (split_k ≤ 8; 1 in fp32);
// direct=0 writes fp32 partials (split_k, M, N). bm .. smem: the wrapper's
// gemm_geometry. The caller guarantees (K/split_k) % 32 == 0, K % 8 == 0,
// N % 16 == 0 and 16-byte aligned pointers.
extern "C" int dense_gemm(const void* x, const void* w, void* out, int M,
                          int N, int K, int split_k, int dtype, int direct,
                          int bm, int bk, int stages, int ks, int cluster,
                          int smem, void* stream) {
  const gemm_tile::DenseArgs a{w};
  const gemm_tile::Launch want{bm, bk, stages, ks, cluster, smem};
  return static_cast<int>(
      gemm_tile::run<gemm_tile::DenseRing, gemm_tile::DenseStage>(
          gemm_tile::DENSE, dtype, x, a, out, M, N, K, split_k, direct, 0, 0,
          want, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
