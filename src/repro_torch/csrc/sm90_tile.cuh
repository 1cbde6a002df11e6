// Warp-level building blocks shared by the port's tensor-core kernels (the
// attention tiles of attn_tile.cuh and the GEMM tile loop of gemm_tile.cuh):
// 16-byte cp.async copies with zero-fill and their commit/wait groups,
// ldmatrix operand loads, mma.sync.m16n8k16 with fp32 accumulators and
// mma.sync.m16n8k32 on int8 with int32 accumulators, and the fp32 -> 16-bit
// pair packing of an mma operand register.
//
// Fragment layout of mma.sync.m16n8k16 (row.col), g = lane / 4, t = lane % 4:
//   A (16 x 16): a[0] = (row g, cols 2t, 2t+1), a[1] = (row g + 8, same),
//                a[2] = (row g, cols 2t+8, 2t+9), a[3] = (row g + 8, same);
//   B (16 x 8):  b0 = (rows 2t, 2t+1, col g), b1 = (rows 2t+8, 2t+9, col g);
//   C (16 x 8):  c[0], c[1] = (row g, cols 2t, 2t+1), c[2], c[3] = row g + 8.
// Each 32-bit operand register holds two 16-bit values, the lower column
// (A) or row (B) in its low half.
//
// mma.sync.m16n8k32 (s8, row.col): each register holds four int8 values of
// consecutive K, the lowest K in the low byte:
//   A (16 x 32): a[0] = (row g, k 4t .. 4t+3), a[1] = (row g + 8, same),
//                a[2] = (row g, k 16+4t .. 16+4t+3), a[3] = (row g + 8, same);
//   B (32 x 8):  b0 = (k 4t .. 4t+3, col g), b1 = (k 16+4t .. 16+4t+3, col g);
//   C (16 x 8):  int32, as for m16n8k16.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------

// 16 bytes global → shared; when !pred nothing is read and the 16 bytes
// are zero-filled (src stays a valid address all the same)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's committed groups are in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// the same with the count known at compile time (any depth of ring)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// tensor-core operands and products
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// two 8x8 matrices: lanes 0-7 address the rows of the first, 8-15 those of
// the second (the other lanes' addresses are not read)
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// c += a · b for one m16n8k16 tile, fp32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16816<__half>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a · b for one m16n8k32 tile of signed int8, int32 accumulators
// (exact: no saturation is asked for, and int32 sums of int8 products do not
// overflow within a scale group)
__device__ __forceinline__ void mma16832_s8(int (&c)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to T, packed low | high (the A-fragment pair order)
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo,
                                                                float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace sm90
