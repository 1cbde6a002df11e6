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
//   over 3.35 TB/s: 0.3 to 3 µs per danube GEMM, so launch and load latency
//   weigh as much as bandwidth.
//
// What the design does about it (the tile loop of gemm_tile.cuh with its
// Int4Ring stage):
//   * INT4 crosses device memory once, packed, through a 4-stage cp.async
//     ring in shared memory (128 K rows of 64 columns a stage, with the
//     stage's group scales and zero-points), so up to three stages of
//     packed bytes per block are in flight while the warps work.
//   * The dequant happens in registers, straight into mma.sync A fragments:
//     a packed byte holds rows 2p and 2p+1 of one column, the K pair of one
//     32-bit A register ("swap AB": the weight is the 16-row operand, the
//     tokens the 8-wide one). Each nibble becomes an exact fp32 by the 2^23
//     magic-number trick; (q - z)·s in fp32 and one round to the activation
//     dtype per pair, as the plain version does. No dequantized tile is
//     written anywhere.
//   * Split-K inside the kernel: the plan's split_k slices, cut further
//     while the card has fewer than two blocks per SM, run as one
//     thread-block cluster along K whose blocks sum their tiles through
//     distributed shared memory in slice order and write the output in the
//     activation dtype once (direct mode, split_k ≤ 8), so a GEMM is one
//     device op. With direct=0 the kernel writes the plan slices' fp32
//     partials (split_k, M, N) instead.
//   * An MoE layer's expert stack (E GEMMs of one shape: x (E, M, K) against
//     packed (E, K/2, N); JAX vmaps the planned execute over the experts,
//     one pallas_call with an extra grid axis) is one launch: the expert
//     index rides gridDim.y beside the M tiles, each block moves its
//     operands by the expert's strides, and the sub heuristic counts all
//     E·tiles, so olmoe's 64 experts fill the card without a K split.
//     Capacity rows of an expert that no token took are zero rows of x,
//     computed like any other.
//   * Ragged M and N tails are masked in the kernel; fp32 activations (the
//     reduced test configurations) take the CUDA-core FMA variant.

#include "gemm_tile.cuh"

// x (M, K) bf16 (dtype 0), fp16 (dtype 1) or fp32 (dtype 2); packed
// (K/2, N) int8; scales and optional zeros (K/group, N) fp32. direct=1
// writes out (M, N) in the x dtype (split_k ≤ 8; 1 in fp32); direct=0
// writes fp32 partials (split_k, M, N). batch > 1 runs an expert stack in
// the one launch: GEMM e reads x + e·x_stride (elements), packed +
// e·w_stride (bytes), scales and zeros + e·s_stride (floats) and writes
// out + e·out_stride (elements; the partials are then (split_k, batch, M,
// N)). bm .. smem: the wrapper's gemm_geometry. The caller guarantees
// K % split_k == 0, (K/split_k) % 32 == 0, K % 8 == 0, N % 16 == 0, an
// even group size dividing K and 16-byte aligned pointers and strides.
extern "C" int w4a16_gemm(const void* x, const void* packed,
                          const void* scales, const void* zeros, void* out,
                          int M, int N, int K, int group, int split_k,
                          int dtype, int direct, int bm, int bk, int stages,
                          int ks, int cluster, int smem, int batch,
                          long long x_stride, long long w_stride,
                          long long s_stride, long long out_stride,
                          void* stream) {
  int shift = -1;
  for (int s = 0; s < 31; ++s)
    if (group == (1 << s)) shift = s;
  const gemm_tile::Int4GroupArgs a{static_cast<const int8_t*>(packed),
                                   static_cast<const float*>(scales),
                                   static_cast<const float*>(zeros), group,
                                   shift};
  const gemm_tile::Launch want{bm, bk, stages, ks, cluster, smem};
  const gemm_tile::Batch b{batch, x_stride, w_stride, s_stride, out_stride};
  return static_cast<int>(
      gemm_tile::run<gemm_tile::Int4Ring, gemm_tile::Int4GroupStage>(
          gemm_tile::INT4, dtype, x, a, out, M, N, K, split_k, direct, group,
          zeros != nullptr, want, static_cast<cudaStream_t>(stream), b));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
