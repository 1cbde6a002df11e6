// The tile loop shared by the port's float-contraction GEMMs, with the
// weight stage as a template parameter: the Hopper counterpart of the JAX
// package's stage template (src/repro/kernels/template.py, tiled_matmul
// with a weight stage and FloatContraction; pallas_call at :449 and :473).
//
// Weight stages ("rings": how one stage of weights is copied into shared
// memory and turned into mma A fragments):
//   * Int4Ring  — packed int4 pairs along K with fp32 group scales (and
//                 zero-points): GroupedInt4Dequant, the fused W4A16 kernel
//                 (w4a16_gemm.cu);
//   * Int8Ring  — int8 rows with one fp32 scale (and zero-point) per output
//                 column: ChannelInt8Dequant (w8a16_gemm.cu);
//   * DenseRing — a (K, N) weight already in the activation dtype:
//                 DenseWeight (dense_gemm.cu, and phase 2 of the decoupled
//                 W4A16 pipeline).
//
// What bounds it on the H100: bytes. On the serving path M is the decode
// batch (8) or a prefill chunk (32): each weight element feeds M
// multiply-adds, about M FLOP per byte of a dense bf16 weight and 4·M per
// byte of packed int4, far below the ~295 FLOP/byte at which the tensor
// cores become the limit. The least time is the weight bytes over 3.35
// TB/s, a few microseconds per danube GEMM, so the loop has to keep enough
// bytes in flight from the first cycle and enough blocks on the 132 SMs.
//
// The design (bf16/fp16 activations):
//   * A ring of STAGES shared-memory stages filled by 16-byte cp.async with
//     zero-fill: each stage holds BK rows of the block's 64 weight columns
//     (with the int4 group scales and zero-points of those rows) and the
//     matching BK columns of x, so up to STAGES - 1 stages of weights are in
//     flight while the warps work on the oldest; one __syncthreads per stage.
//     Each thread sets up its copies' pointers once and advances them by a
//     stage, so issuing a stage costs a few instructions per 16 bytes.
//   * mma.sync.m16n8k16 with the weight as the 16-row operand ("swap AB":
//     outᵀ = Wᵀ · xᵀ). Weight columns fill the 16 rows, tokens the 8-wide
//     side, so M = 8 is one n8 tile with no padded rows and M = 32 four.
//     x fragments come from the stage by ldmatrix.
//   * Int4 and int8 weights are dequantized straight into A-fragment
//     registers: one packed byte holds rows 2p and 2p+1 of a column, which
//     is exactly the K pair of one 32-bit A register. Each nibble (or int8)
//     becomes an exact fp32 by the 2^23 magic-number trick, then (q - z)·s
//     in fp32 and one round to the activation dtype per pair — the plain
//     version's arithmetic. The columns a thread needs are permuted (col())
//     so that its eight columns are eight consecutive bytes: one 8-byte
//     shared load per K pair, its group scales read beside it. A full
//     stage's k steps are dequantized together, without branches, so their
//     instruction streams interleave: this dequant is the largest part of
//     the loop's time (PERF.md). Dense weights go through ldmatrix.trans.
//   * The four warps of a block split each stage's 16-row k steps and sum
//     their accumulators in shared memory in warp order. Blocks along K
//     ("ks" per output tile: the plan's split_k times "sub") form a thread-
//     block cluster and sum their tiles through distributed shared memory
//     in a fixed order: within a plan slice, then the slices in slice order
//     (direct mode: one cast to the activation dtype), or one fp32 partial
//     per plan slice (partials mode, the decoupled pipeline's phase 2).
//     Each block of the cluster sums an equal share of the tile, loading
//     every block's values for it at once.
//   * The block geometry (tile rows, stage depth, sub, cluster, shared
//     memory) is make_geometry(), mirrored by the wrappers' gemm_geometry
//     (kernels/gemm.py); the launcher refuses a launch whose sizes differ.
//     The W4A8 kernel (w4a8_gemm.cu) takes its geometry from there too, and
//     its end (the warps' sum, the cluster's K sum, the output) from
//     finish_tile.
//   * An expert stack (an MoE layer's E GEMMs of one shape) is one launch:
//     the expert index is folded into gridDim.y (M tiles x E; gridDim.z
//     keeps the K blocks of a cluster, so the blocks of one cluster always
//     share an expert), and each block moves its operands by the expert's
//     strides (Batch). Partials are then (split_k, E, M, N).
// Ragged edges stay in the kernel: rows past M and columns past N load
// zeros and are never stored; a K slice that is a multiple of 32 but not of
// BK ends in a zero-filled stage whose empty 16-row steps are skipped.
//
// fp32 activations (the reduced test configurations) run f32_gemm_kernel:
// the CUDA-core FMA variant with register weight stages (Int4GroupStage,
// Int8ChannelStage, DenseStage), one block per (M tile, 64 columns, K
// slice), writing fp32 partials (split_k, M, N) or the output.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_tile.cuh"

namespace gemm_tile {

namespace cg = cooperative_groups;
using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::ldsm_x2;
using sm90::ldsm_x4_t;
using sm90::mma16816;
using sm90::pack2;

constexpr int BN = 64;        // output columns per block: 4 m16 tiles
constexpr int THREADS = 128;  // a block of the fp32 variant
constexpr int WARPS = 4;      // warps of a tensor-core block
constexpr int TC_THREADS = 32 * WARPS;

template <typename T> __device__ __forceinline__ T cvt(float v);
template <> __device__ __forceinline__ __nv_bfloat16 cvt(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half cvt(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ float cvt(float v) { return v; }

// One thread's share of a BK-row packed tile: 16 packed bytes (packed row
// pr, 16 columns at pc, so 32 weights) with their group's scales and
// zero-points. Columns past N keep zero bytes, scales and zero-points, so
// their (unstored) outputs stay finite.
struct PackedChunk {
  uint4 w = make_uint4(0, 0, 0, 0);
  float s[16] = {}, z[16] = {};

  __device__ __forceinline__ void load(const int8_t* packed,
                                       const float* scales,
                                       const float* zeros, int N, int group,
                                       int k0, int pr, int col) {
    w = *reinterpret_cast<const uint4*>(packed + (size_t)(k0 / 2 + pr) * N +
                                        col);
    const int g = (k0 + 2 * pr) / group;       // rows 2pr, 2pr+1 share it
    const float4* sp =
        reinterpret_cast<const float4*>(scales + (size_t)g * N + col);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = sp[i];
      s[4 * i] = v.x; s[4 * i + 1] = v.y; s[4 * i + 2] = v.z;
      s[4 * i + 3] = v.w;
    }
    if (zeros != nullptr) {
      const float4* zp =
          reinterpret_cast<const float4*>(zeros + (size_t)g * N + col);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = zp[i];
        z[4 * i] = v.x; z[4 * i + 1] = v.y; z[4 * i + 2] = v.z;
        z[4 * i + 3] = v.w;
      }
    }
  }

  // sign-extend both nibbles, apply zero-point and scale, round to T and
  // write rows 2pr and 2pr+1, columns pc..pc+15 of the weight tile
  template <typename T, int LD>
  __device__ __forceinline__ void dequant(T (*ws)[LD], int pr, int pc,
                                          bool has_zeros) const {
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&w);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint8_t u = bytes[j];
      float lo = static_cast<float>(
          static_cast<int8_t>(static_cast<uint8_t>(u << 4)) >> 4);
      float hi = static_cast<float>(static_cast<int8_t>(u) >> 4);
      if (has_zeros) {
        lo -= z[j];
        hi -= z[j];
      }
      ws[2 * pr][pc + j] = cvt<T>(lo * s[j]);
      ws[2 * pr + 1][pc + j] = cvt<T>(hi * s[j]);
    }
  }
};

// ---------------------------------------------------------------------------
// the weights' operands, and the fp32 variant's register weight stages:
// init once per block, load(k0) global -> registers, store() registers ->
// the shared BK x BN tile in T
// ---------------------------------------------------------------------------

struct Int4GroupArgs {
  const int8_t* packed;       // (K/2, N)
  const float* scales;        // (K/group, N)
  const float* zeros;         // same, or nullptr
  int group;
  int gshift;                 // log2(group) for a power of two, else -1
};

template <typename T, int BK>
struct Int4GroupStage {
  using Args = Int4GroupArgs;
  static constexpr int WCH = (BK / 2) * (BN / 16);   // 16-byte chunks
  static_assert(WCH <= THREADS, "one packed chunk per thread at most");
  PackedChunk wc;
  bool owner, in;
  int pr, pc;

  __device__ __forceinline__ void init(const Args&, int N, int n0, int tid) {
    owner = tid < WCH;
    pr = tid / (BN / 16);
    pc = (tid % (BN / 16)) * 16;
    in = owner && (n0 + pc) < N;
  }
  __device__ __forceinline__ void load(const Args& a, int N, int k0, int n0) {
    if (in) wc.load(a.packed, a.scales, a.zeros, N, a.group, k0, pr, n0 + pc);
  }
  template <int LD>
  __device__ __forceinline__ void store(T (*ws)[LD], const Args& a) const {
    if (owner) wc.dequant(ws, pr, pc, a.zeros != nullptr);
  }
};

struct Int8ChannelArgs {
  const int8_t* rows;         // (K, N)
  const float* scales;        // (1, N)
  const float* zeros;         // (1, N) or nullptr
};

// (q - z) * s in fp32, rounded to T (common.dequant_channel_block). Each
// thread keeps the same 16 columns for the whole K loop, so their scales
// and zero-points are loaded once.
template <typename T, int BK>
struct Int8ChannelStage {
  using Args = Int8ChannelArgs;
  static constexpr int CPR = BN / 16;                 // chunks per tile row
  static constexpr int RSTEP = THREADS / CPR;
  static constexpr int CPT = BK / RSTEP;              // chunks per thread
  static_assert(BK % RSTEP == 0, "whole chunks per thread");
  uint4 w[CPT];
  float s[16] = {}, z[16] = {};
  int r0, c;
  bool in;

  __device__ __forceinline__ void init(const Args& a, int N, int n0,
                                       int tid) {
    c = (tid % CPR) * 16;
    r0 = tid / CPR;
    in = (n0 + c) < N;
#pragma unroll
    for (int i = 0; i < CPT; ++i) w[i] = make_uint4(0, 0, 0, 0);
    if (!in) return;
    const float4* sp = reinterpret_cast<const float4*>(a.scales + n0 + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = sp[i];
      s[4 * i] = v.x; s[4 * i + 1] = v.y; s[4 * i + 2] = v.z;
      s[4 * i + 3] = v.w;
    }
    if (a.zeros != nullptr) {
      const float4* zp = reinterpret_cast<const float4*>(a.zeros + n0 + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = zp[i];
        z[4 * i] = v.x; z[4 * i + 1] = v.y; z[4 * i + 2] = v.z;
        z[4 * i + 3] = v.w;
      }
    }
  }
  __device__ __forceinline__ void load(const Args& a, int N, int k0, int n0) {
    if (!in) return;
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      w[i] = *reinterpret_cast<const uint4*>(
          a.rows + (size_t)(k0 + r0 + i * RSTEP) * N + n0 + c);
  }
  template <int LD>
  __device__ __forceinline__ void store(T (*ws)[LD], const Args& a) const {
    const bool has_zeros = a.zeros != nullptr;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int8_t* q = reinterpret_cast<const int8_t*>(&w[i]);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float v = static_cast<float>(q[j]);
        if (has_zeros) v -= z[j];
        ws[r0 + i * RSTEP][c + j] = cvt<T>(v * s[j]);
      }
    }
  }
};

struct DenseArgs {
  const void* w;              // (K, N) in the activation dtype
};

template <typename T, int BK>
struct DenseStage {
  using Args = DenseArgs;
  static constexpr int VEC = 16 / sizeof(T);          // elements per chunk
  static constexpr int CPR = BN / VEC;
  static constexpr int RSTEP = THREADS / CPR;
  static constexpr int CPT = BK / RSTEP;
  static_assert(BK % RSTEP == 0, "whole chunks per thread");
  uint4 w[CPT];
  int r0, c;
  bool in;

  __device__ __forceinline__ void init(const Args&, int N, int n0, int tid) {
    c = (tid % CPR) * VEC;
    r0 = tid / CPR;
    in = (n0 + c) < N;
#pragma unroll
    for (int i = 0; i < CPT; ++i) w[i] = make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void load(const Args& a, int N, int k0, int n0) {
    if (!in) return;
    const T* wp = static_cast<const T*>(a.w);
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      w[i] = *reinterpret_cast<const uint4*>(
          wp + (size_t)(k0 + r0 + i * RSTEP) * N + n0 + c);
  }
  template <int LD>
  __device__ __forceinline__ void store(T (*ws)[LD], const Args&) const {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const T* v = reinterpret_cast<const T*>(&w[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) ws[r0 + i * RSTEP][c + j] = v[j];
    }
  }
};

// ---------------------------------------------------------------------------
// an expert stack: ``count`` GEMMs of one shape in one launch. Operand e
// lies e strides past operand 0: elements of x, of the weight payload
// (bytes of int4 pairs or int8 rows, elements of a dense weight), of the
// scales and zero-points, and of the output (direct or one partials slice)
// ---------------------------------------------------------------------------

struct Batch {
  int count;
  long long x, w, s, out;
};

constexpr Batch ONE_GEMM{1, 0, 0, 0, 0};

template <typename T>
__device__ __forceinline__ Int4GroupArgs at_batch(Int4GroupArgs a,
                                                  long long e,
                                                  const Batch& b) {
  a.packed += e * b.w;
  a.scales += e * b.s;
  if (a.zeros != nullptr) a.zeros += e * b.s;
  return a;
}

template <typename T>
__device__ __forceinline__ Int8ChannelArgs at_batch(Int8ChannelArgs a,
                                                    long long e,
                                                    const Batch& b) {
  a.rows += e * b.w;
  a.scales += e * b.s;
  if (a.zeros != nullptr) a.zeros += e * b.s;
  return a;
}

template <typename T>
__device__ __forceinline__ DenseArgs at_batch(DenseArgs a, long long e,
                                              const Batch& b) {
  a.w = static_cast<const T*>(a.w) + e * b.w;
  return a;
}

// ---------------------------------------------------------------------------
// the geometry of a tensor-core launch (mirrored by kernels/gemm.py
// gemm_geometry, field for field)
// ---------------------------------------------------------------------------

// INT4, INT8, DENSE: the float-contraction rings below. W4A8: the integer
// contraction of w4a8_gemm.cu.
enum Kind { INT4 = 0, INT8 = 1, DENSE = 2, W4A8 = 3 };

constexpr int STAGES = 4;         // ring depth
constexpr int MAX_CLUSTER = 8;    // portable thread-block cluster size
constexpr int RED_LD = BN + 4;    // row stride (floats) of the warps' sums
constexpr int INT8_LD = BN + 16;  // row stride (bytes) of an int8 stage:
                                  // rows 2t and 2t + 1 of a k step fall in
                                  // distinct banks
constexpr int MAX_SMEM = 227 * 1024;

__host__ __device__ constexpr int align128(int n) {
  return (n + 127) / 128 * 128;
}

__host__ __device__ constexpr int ring_bk(int kind) {
  return kind == DENSE ? 64 : 128;
}

// group-scale rows an int4 stage of bk rows can touch (its first row is a
// multiple of 32), at most one per K pair
__host__ __device__ constexpr int scale_rows(int bk, int group) {
  return (bk - 2) / group + 2 < bk / 2 ? (bk - 2) / group + 2 : bk / 2;
}

// bytes of one stage's weight part (the int4 group scale and zero-point
// rows included) and of its x part
__host__ __device__ constexpr int weight_bytes(int kind, int bk, int elem,
                                               int sr, int zeros) {
  return kind == INT4 ? align128(bk / 2 * BN)
                            + align128(sr * BN * 4) * (zeros ? 2 : 1)
       : kind == INT8 ? align128(bk * INT8_LD)
                      : align128(bk * (BN + 8) * elem);
}

__host__ __device__ constexpr int x_bytes(int bm, int bk, int elem) {
  return align128(bm * (bk + 8) * elem);
}

// the W4A8 kernel's units: 128 K rows of packed int4 weights, their group
// scales (and zero-points), the int8 x tile (144-byte rows) and its Σx_q
// per group; each warp runs its own W4A8_STAGES of them
constexpr int W4A8_BK = 128;
constexpr int W4A8_STAGES = 2;
constexpr int XQ_LD = W4A8_BK + 16;

__host__ __device__ constexpr int w4a8_stage_bytes(int bm, int sr,
                                                   int zeros) {
  return align128(W4A8_BK / 2 * BN) + align128(sr * BN * 4) * (zeros ? 2 : 1)
         + align128(bm * XQ_LD) + align128(bm * sr * 4);
}

struct Geometry {
  int bm, bk, stages;
  int ks;        // blocks along K per output tile: split_k * sub
  int sub;       // blocks per plan slice
  int cluster;   // blocks per cluster along K (ks direct, sub partials)
  int gx, gy, gz;  // gy: M tiles x the batch's GEMMs
  int sr;        // int4 group-scale rows per stage
  int stage_bytes, smem;
};

// false for a launch the kernels do not take. fp32 (elem 4) takes the
// CUDA-core variant: its fixed blocks, no ring, no cluster. Otherwise M
// picks the tile rows (8, 16 or 32 tokens); sub doubles while the card has
// fewer than two blocks per SM (counting the tiles of all ``batch`` GEMMs),
// the K slices stay multiples of 32 and a cluster stays within MAX_CLUSTER
// blocks. The batch's GEMMs stack along gridDim.y.
inline bool make_geometry(Geometry& g, int kind, int M, int N, int K, int S,
                          int elem, int direct, int group, int zeros,
                          int sms, int batch = 1) {
  if (M < 1 || N < 16 || N % 16 || S < 1 || K % S || (K / S) % 32 ||
      batch < 1 || (kind == W4A8 && batch != 1))
    return false;
  if (kind == W4A8) {
    // every dtype on the int8 tensor cores; a group is whole in one block's
    // K rows and one warp's unit, so its int32 sum is exact
    if ((group != 32 && group != 64 && group != 128) || (K / S) % group ||
        (direct && S > MAX_CLUSTER))
      return false;
    g.gx = (N + BN - 1) / BN;
    g.bm = M <= 8 ? 8 : M <= 16 ? 16 : 32;
    g.bk = W4A8_BK;
    g.stages = W4A8_STAGES;
    const int tiles = g.gx * ((M + g.bm - 1) / g.bm);
    const int cap = direct ? MAX_CLUSTER / S : MAX_CLUSTER;
    int sub = 1;
    while (sub * 2 <= cap && K % (S * sub * 2) == 0 &&
           (K / (S * sub * 2)) % group == 0 && tiles * S * sub < 2 * sms)
      sub *= 2;
    g.sub = sub;
    g.ks = S * sub;
    g.cluster = direct ? g.ks : sub;
    g.sr = W4A8_BK / group;
    g.stage_bytes = w4a8_stage_bytes(g.bm, g.sr, zeros);
    const int ring = WARPS * g.stages * g.stage_bytes;
    const int red = WARPS * g.bm * RED_LD * 4;
    g.smem = (ring > red ? ring : red) + align128(2 * g.bm * 4);
    if (g.smem > MAX_SMEM) return false;
    g.gy = (M + g.bm - 1) / g.bm;
    g.gz = g.ks;
    return true;
  }
  if (kind == INT4 && (group < 2 || group % 2 || K % group)) return false;
  g.gx = (N + BN - 1) / BN;
  if (elem == 4) {
    if (direct && S != 1) return false;
    g.bm = M <= 16 ? 16 : 32;
    g.bk = 32;
    g.stages = 1;
    g.sub = 1;
    g.ks = S;
    g.cluster = 1;
    g.sr = 0;
    g.stage_bytes = 0;
    g.smem = 0;
  } else {
    if (direct && S > MAX_CLUSTER) return false;
    g.bm = M <= 8 ? 8 : M <= 16 ? 16 : 32;
    g.bk = ring_bk(kind);
    g.stages = STAGES;
    const long long tiles =
        (long long)g.gx * ((M + g.bm - 1) / g.bm) * batch;
    const int cap = direct ? MAX_CLUSTER / S : MAX_CLUSTER;
    int sub = 1;
    while (sub * 2 <= cap && K % (S * sub * 2) == 0 &&
           (K / (S * sub * 2)) % 32 == 0 && tiles * S * sub < 2 * sms)
      sub *= 2;
    g.sub = sub;
    g.ks = S * sub;
    g.cluster = direct ? g.ks : sub;
    g.sr = kind == INT4 ? scale_rows(g.bk, group) : 0;
    g.stage_bytes = weight_bytes(kind, g.bk, elem, g.sr, zeros)
                    + x_bytes(g.bm, g.bk, elem);
    const int ring = g.stages * g.stage_bytes;
    const int red = WARPS * g.bm * RED_LD * 4;
    g.smem = ring > red ? ring : red;
    if (g.smem > MAX_SMEM) return false;
  }
  if ((long long)((M + g.bm - 1) / g.bm) * batch > 65535) return false;
  g.gy = (M + g.bm - 1) / g.bm * batch;
  g.gz = g.ks;
  return true;
}

// what the tensor-core kernel needs of the geometry at run time
struct TcParams {
  int M, N, K;
  int L;            // K rows per block (K / ks)
  int sub, cluster, direct;
  int sr, stage_bytes, wbytes;
  Batch batch;      // the stack's strides (ONE_GEMM: a single GEMM)
  int m_tiles;      // M tiles of one GEMM: blockIdx.y = e * m_tiles + tile
  long long slice;  // output elements between plan slices of the partials
};

// ---------------------------------------------------------------------------
// ring stages. Each thread sets up its share of a stage's 16-byte copies
// once (start(): source pointers, shared-memory offsets, column masks) and
// load() issues them for the next stage and advances the pointers, so a
// stage costs a few instructions per copy. rows is the count of the
// stage's K rows inside the block's slice (the rest are zero-filled).
// frags() turns k step j = warp + WARPS·jj (16 K rows) of a landed stage into
// the A fragments of the block's four m16 column tiles; col(tile, r) is the
// block column of A row r of a tile.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// byte i of u as the low byte of 2^23's bit pattern: the exact fp32
// 2^23 + byte
__device__ __forceinline__ float magic_byte(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i));
}

// the low nibbles (lo) and high nibbles (hi) of u's four bytes, each as
// q + 8 in its own byte (the xor turns the signed nibble q into q + 8)
__device__ __forceinline__ void nibbles(uint32_t u, uint32_t& lo,
                                        uint32_t& hi) {
  lo = (u ^ 0x88888888u) & 0x0F0F0F0Fu;
  hi = ((u >> 4) ^ 0x08080808u) & 0x0F0F0F0Fu;
}

// columns of the int stages: thread g of a warp owns the eight block
// columns 8g .. 8g + 7 (A rows g and g + 8 of the four column tiles)
__device__ __forceinline__ int int_col(int tile, int r) {
  return 8 * (r & 7) + 2 * tile + (r >> 3);
}

template <typename T>
struct Int4Ring {
  using Args = Int4GroupArgs;
  static constexpr int BK = ring_bk(INT4);
  static constexpr int W_BYTES = align128(BK / 2 * BN);
  static constexpr int RSTEP = TC_THREADS / 4;      // packed rows per pass
  static constexpr int WCH = BK / 2 / RSTEP;     // packed chunks a thread
  static constexpr bool INT_COLS = true;
  const int8_t* wsrc;         // the thread's first packed chunk, next stage
  int wrow, wdst;
  bool wcol;
  int frag, kfrag;            // its first K pair: byte offset, K row

  __device__ __forceinline__ static int group_of(const Args& a, int k) {
    return a.gshift >= 0 ? k >> a.gshift : k / a.group;
  }
  __device__ __forceinline__ static int col(int tile, int r) {
    return int_col(tile, r);
  }

  // packed row r, columns 8g .. 8g + 7: two threads per 16-byte chunk;
  // rows with bit 1 set swap their 32-byte halves, so a half-warp's four
  // rows hit four bank groups
  __device__ __forceinline__ static int w_off(int r, int g) {
    return r * BN + ((((g >> 1) ^ (r & 2)) << 4) | ((g & 1) << 3));
  }

  __device__ __forceinline__ void start(const Args& a, const TcParams& p,
                                        int n0, int kb, int tid) {
    const int ch = tid & 3;
    wrow = tid >> 2;
    wcol = n0 + 16 * ch < p.N;
    wsrc = a.packed + (size_t)(kb / 2 + wrow) * p.N + n0 + 16 * ch;
    wdst = wrow * BN + ((ch ^ (wrow & 2)) << 4);
    const int lane = tid & 31, warp = tid >> 5;
    frag = w_off(8 * warp + (lane & 3), lane >> 2);
    kfrag = 2 * (8 * warp + (lane & 3));
  }

  __device__ __forceinline__ void load(uint8_t* st, const Args& a,
                                       const TcParams& p, int n0, int k0,
                                       int rows, int tid) {
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const bool ok = wcol && 2 * (wrow + i * RSTEP) < rows;
      cp_async16(st + wdst + i * RSTEP * BN,
                 ok ? wsrc + (size_t)i * RSTEP * p.N : a.packed, ok);
    }
    wsrc += (size_t)(BK / 2) * p.N;
    // group rows glo .. ghi of the scales, then of the zero-points
    const int glo = group_of(a, k0), ghi = group_of(a, k0 + rows - 1);
    float* sc = reinterpret_cast<float*>(st + W_BYTES);
    const int per = p.sr * (BN / 4);
    const int chunks = a.zeros != nullptr ? 2 * per : per;
    for (int c = tid; c < chunks; c += TC_THREADS) {
      const int which = c >= per;
      const int i = (c - which * per) >> 4, ch = c & 15;
      const bool ok = glo + i <= ghi && n0 + 4 * ch < p.N;
      const float* base = which ? a.zeros : a.scales;
      cp_async16(sc + (which * p.sr + i) * BN + 4 * ch,
                 ok ? base + (size_t)(glo + i) * p.N + n0 + 4 * ch : base,
                 ok);
    }
  }

  // the group scales (and zero-points) of each K pair are read from the
  // stage beside its packed bytes: no branch, so the k steps of a stage
  // interleave
  __device__ __forceinline__ void frags(uint32_t (&af)[4][4],
                                        const uint8_t* st, const Args& a,
                                        const TcParams& p, int k0, int jj,
                                        int lane) {
    const int g = lane >> 2;
    const float* sc = reinterpret_cast<const float*>(st + W_BYTES);
    const int glo = group_of(a, k0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // packed row 8j + t + 4h: K rows 16j + 2t + 8h (low nibbles) and
      // the next one
      const uint2 w = *reinterpret_cast<const uint2*>(
          st + frag + (8 * WARPS * jj + 4 * h) * BN);
      const float* row =
          sc + (group_of(a, k0 + kfrag + 16 * WARPS * jj + 8 * h) - glo) * BN
          + 8 * g;
      float s[8], z[8];
      load8(s, row);
      if (a.zeros != nullptr) load8(z, row + p.sr * BN);
      uint32_t lo4[2], hi4[2];
      nibbles(w.x, lo4[0], hi4[0]);
      nibbles(w.y, lo4[1], hi4[1]);
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        // exact: 2^23 + (q + 8) - (2^23 + 8)
        float lo = magic_byte(lo4[b >> 2], b & 3) - 8388616.0f;
        float hi = magic_byte(hi4[b >> 2], b & 3) - 8388616.0f;
        if (a.zeros != nullptr) {
          lo -= z[b];
          hi -= z[b];
        }
        af[b >> 1][(b & 1) + 2 * h] = pack2<T>(lo * s[b], hi * s[b]);
      }
    }
  }
};

template <typename T>
struct Int8Ring {
  using Args = Int8ChannelArgs;
  static constexpr int BK = ring_bk(INT8);
  static constexpr int RSTEP = TC_THREADS / 4;      // rows per pass
  static constexpr int WCH = BK / RSTEP;         // chunks a thread
  static constexpr bool INT_COLS = true;
  float s[8], z[8];           // the thread's eight columns, for all of K
  const int8_t* wsrc;
  int wrow, wdst;
  bool wcol;
  int frag;                   // its rows 2t, 2t + 1 of the warp's k step

  __device__ __forceinline__ static int col(int tile, int r) {
    return int_col(tile, r);
  }

  __device__ __forceinline__ void start(const Args& a, const TcParams& p,
                                        int n0, int kb, int tid) {
    const int ch = tid & 3;
    wrow = tid >> 2;
    wcol = n0 + 16 * ch < p.N;
    wsrc = a.rows + (size_t)(kb + wrow) * p.N + n0 + 16 * ch;
    wdst = wrow * INT8_LD + 16 * ch;
    const int lane = tid & 31, warp = tid >> 5;
    frag = (16 * warp + 2 * (lane & 3)) * INT8_LD + 8 * (lane >> 2);
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = z[i] = 0.0f;
    const int c = n0 + 8 * (lane >> 2);
    if (c < p.N) {
      load8(s, a.scales + c);
      if (a.zeros != nullptr) load8(z, a.zeros + c);
    }
  }

  __device__ __forceinline__ void load(uint8_t* st, const Args& a,
                                       const TcParams& p, int, int,
                                       int rows, int) {
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const bool ok = wcol && wrow + i * RSTEP < rows;
      cp_async16(st + wdst + i * RSTEP * INT8_LD,
                 ok ? wsrc + (size_t)i * RSTEP * p.N : a.rows, ok);
    }
    wsrc += (size_t)BK * p.N;
  }

  // rows 16j + 2t (+1) and 16j + 2t + 8 (+1), the thread's eight columns
  // of each: byte b of rows k and k + 1 make one A register
  __device__ __forceinline__ void frags(uint32_t (&af)[4][4],
                                        const uint8_t* st, const Args& a,
                                        const TcParams&, int, int jj, int) {
    const uint8_t* base = st + frag + 16 * WARPS * jj * INT8_LD;
    uint32_t w[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint2 v = *reinterpret_cast<const uint2*>(
          base + ((i & 1) + 8 * (i >> 1)) * INT8_LD);
      w[i][0] = v.x ^ 0x80808080u;
      w[i][1] = v.y ^ 0x80808080u;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        // exact: 2^23 + (q + 128) - (2^23 + 128)
        float lo = magic_byte(w[2 * h][b >> 2], b & 3) - 8388736.0f;
        float hi = magic_byte(w[2 * h + 1][b >> 2], b & 3) - 8388736.0f;
        if (a.zeros != nullptr) {
          lo -= z[b];
          hi -= z[b];
        }
        af[b >> 1][(b & 1) + 2 * h] = pack2<T>(lo * s[b], hi * s[b]);
      }
  }
};

template <typename T>
struct DenseRing {
  using Args = DenseArgs;
  static constexpr int BK = ring_bk(DENSE);
  static constexpr int LD = BN + 8;  // odd count of 16-byte chunks a row
  static constexpr int RSTEP = TC_THREADS / 8;      // rows per pass
  static constexpr int WCH = BK / RSTEP;         // chunks a thread
  static constexpr bool INT_COLS = false;
  const T* wsrc;
  int wrow, wdst;
  bool wcol;
  int frag;

  __device__ __forceinline__ static int col(int tile, int r) {
    return 16 * tile + r;
  }

  __device__ __forceinline__ void start(const Args& a, const TcParams& p,
                                        int n0, int kb, int tid) {
    const int ch = tid & 7;
    wrow = tid >> 3;
    wcol = n0 + 8 * ch < p.N;
    wsrc = static_cast<const T*>(a.w) + (size_t)(kb + wrow) * p.N + n0
           + 8 * ch;
    wdst = (wrow * LD + 8 * ch) * sizeof(T);
    // matrix i of an x4.trans load: K rows (i >> 1)·8 .., columns
    // (i & 1)·8 .. of the tile, i.e. a[0] .. a[3] of Wᵀ
    const int lane = tid & 31, warp = tid >> 5;
    frag = (16 * warp + (lane & 7) + ((lane >> 4) << 3)) * LD
           + ((lane >> 3) & 1) * 8;
  }

  __device__ __forceinline__ void load(uint8_t* st, const Args& a,
                                       const TcParams& p, int, int,
                                       int rows, int) {
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const bool ok = wcol && wrow + i * RSTEP < rows;
      cp_async16(st + wdst + i * RSTEP * LD * sizeof(T),
                 ok ? wsrc + (size_t)i * RSTEP * p.N : a.w, ok);
    }
    wsrc += (size_t)BK * p.N;
  }

  __device__ __forceinline__ void frags(uint32_t (&af)[4][4],
                                        const uint8_t* st, const Args&,
                                        const TcParams&, int, int jj, int) {
    const T* w = reinterpret_cast<const T*>(st) + frag + 16 * WARPS * jj * LD;
#pragma unroll
    for (int tile = 0; tile < 4; ++tile) ldsm_x4_t(af[tile], w + 16 * tile);
  }
};

// one thread's share of a stage's x tile: BM token rows of BK + 8 elements
// (an odd count of 16-byte chunks), rows past M and K rows past the slice
// zero-filled
template <typename T, int BM, int BK>
struct XTile {
  static constexpr int CPR = BK / 8;             // chunks a row
  static constexpr int XCH = BM * CPR;
  static constexpr int XPT = (XCH + TC_THREADS - 1) / TC_THREADS;
  const T* src[XPT];
  int dst[XPT], kc[XPT];      // dst < 0: no chunk (XCH < TC_THREADS)
  bool live[XPT];

  __device__ __forceinline__ void start(const T* x, const TcParams& p,
                                        int m0, int kb, int tid) {
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int c = tid + i * TC_THREADS, r = c / CPR;
      kc[i] = 8 * (c % CPR);
      live[i] = c < XCH && m0 + r < p.M;
      src[i] = x + (size_t)(live[i] ? m0 + r : 0) * p.K + kb + kc[i];
      dst[i] = c < XCH ? (r * (BK + 8) + kc[i]) * (int)sizeof(T) : -1;
    }
  }

  __device__ __forceinline__ void load(uint8_t* xs, const T* x, int rows) {
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      if (dst[i] < 0) continue;
      const bool ok = live[i] && kc[i] < rows;
      cp_async16(xs + dst[i], ok ? src[i] : x, ok);
      src[i] += BK;
    }
  }
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The end of a tensor-core block: acc[tile][nt][i] is each warp's fp32
// tile (accumulator row r of a column tile is block column col(tile, r), its
// column 2t (+1) of n8 tile nt is token 8nt + 2t (+1)). The four warps' tiles
// are summed in shared memory in warp order (smem: at least WARPS·BM·RED_LD
// floats, free), then the cluster's K slices: each plan slice the sum of its
// sub blocks in rank order; direct mode sums the slices in slice order,
// multiplies row m by row_scale[m] when given (shared memory) and casts once
// to T; partials mode writes its one plan slice in fp32. Each block of the
// cluster takes an equal share of the tile's float4s.
template <typename T, int BM, class R>
__device__ __forceinline__ void finish_tile(const float (&acc)[4][BM / 8][4],
                                            uint8_t* smem, const TcParams& p,
                                            int n0, int m0, int kz,
                                            T* __restrict__ out,
                                            float* __restrict__ partials,
                                            const float* row_scale) {
  constexpr int NT = BM / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* red = reinterpret_cast<float*>(smem);
  {
    const int g = lane >> 2, t = lane & 3;
    float* mine = red + warp * BM * RED_LD;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {             // token 8nt + 2t + e
        float* row = mine + (8 * nt + 2 * t + e) * RED_LD;
        if constexpr (R::INT_COLS) {
          // columns 8g + 2·tile + (i >> 1): eight in a row
          float v[8];
#pragma unroll
          for (int tile = 0; tile < 4; ++tile) {
            v[2 * tile] = acc[tile][nt][e];
            v[2 * tile + 1] = acc[tile][nt][2 + e];
          }
          *reinterpret_cast<float4*>(row + 8 * g) =
              make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(row + 8 * g + 4) =
              make_float4(v[4], v[5], v[6], v[7]);
        } else {
#pragma unroll
          for (int tile = 0; tile < 4; ++tile) {
            row[R::col(tile, g)] = acc[tile][nt][e];
            row[R::col(tile, g + 8)] = acc[tile][nt][2 + e];
          }
        }
      }
  }
  __syncthreads();
  for (int f = tid; f < BM * BN / 4; f += TC_THREADS) {
    float* v = red + (f / (BN / 4)) * RED_LD + (f % (BN / 4)) * 4;
    float4 sum = *reinterpret_cast<const float4*>(v);
#pragma unroll
    for (int w = 1; w < WARPS; ++w)
      sum = add4(sum, *reinterpret_cast<const float4*>(v + w * BM * RED_LD));
    *reinterpret_cast<float4*>(v) = sum;
  }
  __syncthreads();

  cg::cluster_group cluster = cg::this_cluster();
  if (p.cluster > 1) cluster.sync();
  const int rank = p.cluster > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  constexpr int F = BM * BN / 4;                 // float4s of the tile
  const int share = (F + p.cluster - 1) / p.cluster;
  const int f_end = min(F, (rank + 1) * share);
  for (int f = rank * share + tid; f < f_end; f += TC_THREADS) {
    const int m = f / (BN / 4), c = (f % (BN / 4)) * 4;
    if (m0 + m >= p.M || n0 + c >= p.N) continue;
    float* mine = red + m * RED_LD + c;
    // every block's float4 at once, then the sum: each plan slice the sum
    // of its sub blocks in rank order (sub is a power of two), the slices
    // in slice order
    float4 q[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < p.cluster)
        q[r] = *reinterpret_cast<const float4*>(
            p.cluster > 1 ? cluster.map_shared_rank(mine, r) : mine);
    float4 v = q[0], part = q[0];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < p.cluster) {
        const int j = r & (p.sub - 1);           // block j of its slice
        part = j == 0 ? q[r] : add4(part, q[r]);
        if (j == p.sub - 1) v = r == p.sub - 1 ? part : add4(v, part);
      }
    const size_t o = (size_t)(m0 + m) * p.N + n0 + c;
    if (p.direct) {
      if (row_scale != nullptr) {
        const float rs = row_scale[m];
        v = make_float4(__fmul_rn(v.x, rs), __fmul_rn(v.y, rs),
                        __fmul_rn(v.z, rs), __fmul_rn(v.w, rs));
      }
      if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<float4*>(out + o) = v;
      } else {
        uint2 packed;
        packed.x = pack2<T>(v.x, v.y);
        packed.y = pack2<T>(v.z, v.w);
        *reinterpret_cast<uint2*>(out + o) = packed;
      }
    } else {
      *reinterpret_cast<float4*>(
          partials + (size_t)(kz / p.sub) * p.slice + o) = v;
    }
  }
  if (p.cluster > 1) cluster.sync();  // no block leaves while read
}

// ---------------------------------------------------------------------------
// the tensor-core tile loop
// ---------------------------------------------------------------------------

// One block: BM tokens x 64 columns x the L rows of K slice blockIdx.z.
template <typename T, int BM, template <typename> class Ring>
__global__ void __launch_bounds__(TC_THREADS)
tc_gemm_kernel(const T* __restrict__ x, typename Ring<T>::Args wa,
               T* __restrict__ out, float* __restrict__ partials,
               TcParams p) {
  using R = Ring<T>;
  constexpr int BK = R::BK, NT = BM / 8, XLD = BK + 8;
  constexpr int KSW = BK / 16 / WARPS;           // k steps a warp a stage
  static_assert(BK % (16 * WARPS) == 0, "whole k steps for every warp");
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = (blockIdx.y % p.m_tiles) * BM;
  const int kz = blockIdx.z;
  const int kb = kz * p.L;
  const int steps = (p.L + BK - 1) / BK;
  if (p.batch.count > 1) {       // this block's GEMM of the stack
    const long long e = blockIdx.y / p.m_tiles;
    x += e * p.batch.x;
    wa = at_batch<T>(wa, e, p.batch);
    if (out != nullptr) out += e * p.batch.out;
    if (partials != nullptr) partials += e * p.batch.out;
  }

  R ring;
  ring.start(wa, p, n0, kb, tid);
  XTile<T, BM, BK> xt;
  xt.start(x, p, m0, kb, tid);
  auto issue = [&](int it) {
    if (it < steps) {
      uint8_t* st = smem + (it % STAGES) * p.stage_bytes;
      const int rows = min(BK, p.L - it * BK);
      ring.load(st, wa, p, n0, kb + it * BK, rows, tid);
      xt.load(st + p.wbytes, x, rows);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  float acc[4][NT][4];
#pragma unroll
  for (int tile = 0; tile < 4; ++tile)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[tile][nt][i] = 0.0f;
  // the thread's x rows of an ldmatrix.x2 (lanes 0-7 k 0-7, 8-15 k 8-15)
  const int xfrag = (lane & 7) * XLD + 16 * warp + ((lane >> 3) & 1) * 8;

  for (int it = 0; it < steps; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();              // stage it landed; stage it - 1 is free
    issue(it + STAGES - 1);
    const uint8_t* st = smem + (it % STAGES) * p.stage_bytes;
    const T* xs = reinterpret_cast<const T*>(st + p.wbytes);
    const int k0 = kb + it * BK;
    const int rows = min(BK, p.L - it * BK);
    auto step = [&](const uint32_t (&af)[4][4], int jj) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[2];
        ldsm_x2(b, xs + xfrag + 8 * nt * XLD + 16 * WARPS * jj);
#pragma unroll
        for (int tile = 0; tile < 4; ++tile)
          mma16816<T>(acc[tile][nt], af[tile], b[0], b[1]);
      }
    };
    if (rows == BK) {             // a full stage: the warp's k steps at once
      uint32_t af[KSW][4][4];
#pragma unroll
      for (int jj = 0; jj < KSW; ++jj)
        ring.frags(af[jj], st, wa, p, k0, jj, lane);
#pragma unroll
      for (int jj = 0; jj < KSW; ++jj) step(af[jj], jj);
    } else {                      // the slice's tail: its 16-row steps only
#pragma unroll
      for (int jj = 0; jj < KSW; ++jj)
        if (16 * (warp + WARPS * jj) < rows) {
          uint32_t af[4][4];
          ring.frags(af, st, wa, p, k0, jj, lane);
          step(af, jj);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                // the ring is free: reuse it
  finish_tile<T, BM, R>(acc, smem, p, n0, m0, kz, out, partials, nullptr);
}

// fp32 activations: the same blocks and weight stages, with the product
// accumulated by FMA on the CUDA cores (the tensor cores take no fp32
// operands at fp32 precision). Thread t owns column t % BN and rows
// t / BN + j * (THREADS / BN) of the block's tile. Partials and the direct
// output are both fp32, so one store serves both (split 0 of a direct
// launch is the output itself).
template <int BM, template <typename, int> class Stage>
__global__ void __launch_bounds__(THREADS)
f32_gemm_kernel(const float* __restrict__ x,
                typename Stage<float, 32>::Args wa, float* __restrict__ out,
                int M, int N, int K, int k_slice, Batch batch, int m_tiles,
                long long slice) {
  constexpr int BK = 32;
  constexpr int RSTEP = THREADS / BN;
  constexpr int RPT = BM / RSTEP;

  __shared__ float xs[BM][BK];
  __shared__ float ws[BK][BN + 1];

  const int tid = threadIdx.x;
  const int col = tid % BN, row0 = tid / BN;
  const int n0 = blockIdx.x * BN;
  const int m0 = (blockIdx.y % m_tiles) * BM;
  const int split = blockIdx.z;
  const int k_begin = split * k_slice;
  if (batch.count > 1) {
    const long long e = blockIdx.y / m_tiles;
    x += e * batch.x;
    wa = at_batch<float>(wa, e, batch);
    out += e * batch.out;
  }

  Stage<float, BK> st;
  st.init(wa, N, n0, tid);
  float acc[RPT] = {};
  for (int k0 = k_begin; k0 < k_begin + k_slice; k0 += BK) {
    st.load(wa, N, k0, n0);
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      xs[r][c] = m0 + r < M ? x[(size_t)(m0 + r) * K + k0 + c] : 0.0f;
    }
    st.store(ws, wa);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float w = ws[k][col];
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        acc[j] = fmaf(xs[row0 + j * RSTEP][k], w, acc[j]);
    }
    __syncthreads();
  }
  const int n = n0 + col;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int m = m0 + row0 + j * RSTEP;
    if (m < M && n < N) out[(size_t)split * slice + (size_t)m * N + n] =
        acc[j];
  }
}

template <int BM, template <typename, int> class Stage, typename Args>
cudaError_t launch_f32(const void* x, const Args& wa, void* out, int M, int N,
                       int K, int split_k, const Batch& batch,
                       long long slice, cudaStream_t stream) {
  const int m_tiles = (M + BM - 1) / BM;
  dim3 grid((N + BN - 1) / BN, m_tiles * batch.count, split_k);
  f32_gemm_kernel<BM, Stage><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), wa, static_cast<float*>(out), M, N, K,
      K / split_k, batch, m_tiles, slice);
  return cudaGetLastError();
}

// the geometry the wrapper computed (gemm_geometry), checked against
// make_geometry's before any launch
struct Launch {
  int bm, bk, stages, ks, cluster, smem;
};

// the launchers have internal linkage: each kernel library keeps its own
// launch state (the shared-memory attribute set so far, the SM count)
namespace {

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <typename T, int BM, template <typename> class Ring>
cudaError_t launch_tc(const void* x, const typename Ring<T>::Args& wa,
                      void* out, const Geometry& g, int M, int N, int K,
                      int direct, const Batch& batch, long long slice,
                      cudaStream_t stream) {
  auto kernel = tc_gemm_kernel<T, BM, Ring>;
  static int allowed = 48 * 1024;       // dynamic shared memory set so far
  if (g.smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (err != cudaSuccess) return err;
    allowed = g.smem;
  }
  const TcParams p{M, N, K, K / g.ks, g.sub, g.cluster, direct, g.sr,
                   g.stage_bytes,
                   g.stage_bytes - x_bytes(BM, Ring<T>::BK, sizeof(T)),
                   batch, g.gy / batch.count, slice};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = g.cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.gx, g.gy, g.gz);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = g.cluster > 1 ? 1 : 0;
  T* o = direct ? static_cast<T*>(out) : nullptr;
  float* parts = direct ? nullptr : static_cast<float*>(out);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), wa, o, parts, p);
  const cudaError_t last = cudaGetLastError();   // read and cleared
  return err != cudaSuccess ? err : last;
}

template <typename T, template <typename> class Ring>
cudaError_t dispatch_tc(const void* x, const typename Ring<T>::Args& wa,
                        void* out, const Geometry& g, int M, int N, int K,
                        int direct, const Batch& batch, long long slice,
                        cudaStream_t stream) {
  switch (g.bm) {
    case 8:
      return launch_tc<T, 8, Ring>(x, wa, out, g, M, N, K, direct, batch,
                                   slice, stream);
    case 16:
      return launch_tc<T, 16, Ring>(x, wa, out, g, M, N, K, direct, batch,
                                    slice, stream);
    case 32:
      return launch_tc<T, 32, Ring>(x, wa, out, g, M, N, K, direct, batch,
                                    slice, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// x (M, K) bf16 (dtype 0), fp16 (dtype 1) or fp32 (dtype 2). direct=1
// writes out (M, N) in the x dtype (split_k ≤ MAX_CLUSTER for bf16/fp16,
// 1 for fp32); direct=0 writes fp32 partials (split_k, M, N). A batch of
// count > 1 runs count such GEMMs in the one launch, each operand at its
// stride (out: each GEMM's (M, N) output or one partials slice of it, the
// partials then (split_k, count, M, N)). The caller guarantees
// K % split_k == 0, (K/split_k) % 32 == 0, K % 8 == 0, N % 16 == 0 and
// 16-byte aligned pointers and strides, and passes the geometry of its
// gemm_geometry, which must equal make_geometry's.
template <template <typename> class Ring,
          template <typename, int> class Stage, typename Args>
cudaError_t run(int kind, int dtype, const void* x, const Args& wa,
                void* out, int M, int N, int K, int split_k, int direct,
                int group, int zeros, const Launch& want,
                cudaStream_t stream, Batch batch = ONE_GEMM) {
  Geometry g;
  if (dtype < 0 || dtype > 2 ||
      !make_geometry(g, kind, M, N, K, split_k, dtype == 2 ? 4 : 2, direct,
                     group, zeros, sm_count(), batch.count))
    return cudaErrorInvalidValue;
  if (g.bm != want.bm || g.bk != want.bk || g.stages != want.stages ||
      g.ks != want.ks || g.cluster != want.cluster || g.smem != want.smem)
    return cudaErrorInvalidValue;       // the wrapper's geometry disagrees
  if (batch.count == 1) batch.out = (long long)M * N;
  const long long slice = batch.count * batch.out;
  if (dtype == 0)
    return dispatch_tc<__nv_bfloat16, Ring>(x, wa, out, g, M, N, K, direct,
                                            batch, slice, stream);
  if (dtype == 1)
    return dispatch_tc<__half, Ring>(x, wa, out, g, M, N, K, direct, batch,
                                     slice, stream);
  return g.bm == 16 ? launch_f32<16, Stage>(x, wa, out, M, N, K, split_k,
                                            batch, slice, stream)
                    : launch_f32<32, Stage>(x, wa, out, M, N, K, split_k,
                                            batch, slice, stream);
}

}  // namespace

}  // namespace gemm_tile
