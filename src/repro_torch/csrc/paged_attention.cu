// Paged-attention partials for Hopper: one pass over the pooled KV pages a
// slot's block table names, for decode (q_len = 1) and chunked prefill
// (q_len = C).
//
// Replaces: src/repro/kernels/paged_attention.py:148 `_pooled_partials`
//   (pallas_call at :236, kernel body _make_kernel :92-145, KV stages
//   template.DensePages / Int8ChannelPages), entered via
//   fused_paged_attention :273 and fused_chunk_attention :314. The combine
//   epilogue (_combine :261) and the chunk's own C x C segment stay in
//   PyTorch, as they sit outside the pallas_call in JAX.
//
// What bounds it on the H100: bytes. Each cached token is read once per
//   query tile and contributes 4·D FLOP per query row; with G = 4 query
//   heads per kv-head a decode step does ~2 FLOP per KV byte and a 32-token
//   chunk ~64, both far below the card's ~295 FLOP/byte. The least time is
//   the referenced pages (K, V, scales, position tags) over 3.35 TB/s.
//
// What the design does about it:
//   * The block table is walked inside the kernel: one block per
//     (slot·kv-head, Q tile, page partition) reads its own table entries
//     (there is no scalar prefetch on a GPU; a -1 entry is the null block 0)
//     and streams its P pages through shared memory 32 tokens at a time.
//     The gathered window never exists in device memory.
//   * kv8_channel pages are dequantized while they are staged (int8 × fp32
//     per-(token, head) scale, rounded to the compute dtype exactly like
//     kv_dequantize), so int8 is what crosses device memory.
//   * Split-K over pages (the planner's kv_partitions) puts B·Hkv·Q_tiles·S
//     blocks on the SMs; each writes unnormalized (acc, m, l) partials.
//   * Masking is positional on the pool's page_pos tags: kpos >= 0,
//     kpos <= qpos, kpos < start (and kpos > qpos - window), with masked
//     scores set to -1e30 — not -inf — so fully masked tiles behave as in
//     JAX: a partition with no live key keeps m = -1e30 and cancels in the
//     combine through exp(-1e30 - m_max) = 0.
//   * One warp per query row (Tq·G rows, up to 128 per block): lane j
//     scores key j of the staged 32, the warp takes the batch max and sum by
//     shuffles, and each lane accumulates the output dims d ≡ lane (mod 32).
//     Query rows and their running (m, l, acc) live in shared memory.
//   This is the simple first kernel (scalar FMA, no tensor cores, no TMA).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int KB = 32;           // keys staged per batch (one per lane)
constexpr int MAX_D = 256;       // head_dim limit: 8 output dims per lane
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f(float v) { return v; }
template <> __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f(__half v) {
  return __half2float(v);
}

// round a float to T and back: the value a cast to the compute dtype keeps
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <> __device__ __forceinline__ float round_to<__half>(float v) {
  return __half2float(__float2half_rn(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const T* __restrict__ q, const int* __restrict__ positions,
                  const int* __restrict__ start,
                  const void* __restrict__ k_pool,
                  const void* __restrict__ v_pool,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ page_pos,
                  const int* __restrict__ tables, float* __restrict__ acc_out,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  int Hkv, int C, int Tq, int G, int D, int ps, int T_tab,
                  int P, int window, int quantized) {
  extern __shared__ float smem[];
  const int QG = Tq * G;
  const int Dp = D | 1;                  // odd stride: conflict-free columns
  float* q_s = smem;                     // QG x D
  float* acc_s = q_s + QG * D;           // QG x D
  float* m_s = acc_s + QG * D;           // QG
  float* l_s = m_s + QG;                 // QG
  float* k_s = l_s + QG;                 // KB x Dp
  float* v_s = k_s + KB * Dp;            // KB x Dp
  int* kpos_s = reinterpret_cast<int*>(v_s + KB * Dp);  // KB
  int* qpos_s = kpos_s + KB;                            // QG

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int qt = blockIdx.y, QT = gridDim.y;
  const int s = blockIdx.z, S = gridDim.z;

  const size_t row0 = ((size_t)(b * Hkv + h) * QT + qt) * QG;
  for (int i = tid; i < QG * D; i += THREADS) {
    q_s[i] = to_f(q[row0 * D + i]);
    acc_s[i] = 0.0f;
  }
  for (int r = tid; r < QG; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.0f;
    qpos_s[r] = positions[(size_t)b * C + qt * Tq + r / G];
  }
  const int st = start[b];
  const int* tbl = tables + (size_t)b * T_tab + (size_t)s * P;
  const int nkeys = P * ps;

  for (int kb0 = 0; kb0 < nkeys; kb0 += KB) {
    const int nk = min(KB, nkeys - kb0);
    __syncthreads();   // the previous batch is consumed (and init is done)
    for (int idx = tid; idx < nk * D; idx += THREADS) {
      const int j = idx / D, d = idx - j * D;
      const int key = kb0 + j;
      int page = tbl[key / ps];
      page = page < 0 ? 0 : page;                       // null block
      const size_t tok = (size_t)page * ps + key % ps;
      const size_t e = (tok * Hkv + h) * D + d;
      float kv, vv;
      if (quantized) {
        const float ks = k_scale[tok * Hkv + h], vs = v_scale[tok * Hkv + h];
        kv = round_to<T>(
            static_cast<float>(static_cast<const int8_t*>(k_pool)[e]) * ks);
        vv = round_to<T>(
            static_cast<float>(static_cast<const int8_t*>(v_pool)[e]) * vs);
      } else {
        kv = to_f(static_cast<const T*>(k_pool)[e]);
        vv = to_f(static_cast<const T*>(v_pool)[e]);
      }
      k_s[j * Dp + d] = kv;
      v_s[j * Dp + d] = vv;
    }
    for (int j = tid; j < nk; j += THREADS) {
      const int key = kb0 + j;
      int page = tbl[key / ps];
      page = page < 0 ? 0 : page;
      kpos_s[j] = page_pos[(size_t)page * ps + key % ps];
    }
    __syncthreads();

    for (int r = warp; r < QG; r += WARPS) {
      const int qp = qpos_s[r];
      float sc = -INFINITY;                  // lanes past the batch: no key
      if (lane < nk) {
        const float* qr = q_s + r * D;
        const float* kr = k_s + lane * Dp;
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        const int kp = kpos_s[lane];
        bool valid = kp >= 0 && kp <= qp && kp < st;
        if (window) valid = valid && kp > qp - window;
        sc = valid ? dot : NEG_INF;
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(sc));
      const float p = expf(sc - m_new);
      const float corr = expf(m_prev - m_new);
      const float psum = warp_sum(p);
      const float pc = round_to<T>(p);       // p cast to the V dtype
      float a[MAX_D / 32];
#pragma unroll
      for (int i = 0; i < MAX_D / 32; ++i) {
        const int d = lane + 32 * i;
        a[i] = d < D ? acc_s[r * D + d] * corr : 0.0f;
      }
      for (int j = 0; j < nk; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pc, j);
        const float* vr = v_s + j * Dp;
#pragma unroll
        for (int i = 0; i < MAX_D / 32; ++i) {
          const int d = lane + 32 * i;
          if (d < D) a[i] = fmaf(pj, vr[d], a[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < MAX_D / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc_s[r * D + d] = a[i];
      }
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + psum;
      }
    }
  }
  __syncthreads();

  const size_t out0 = (((size_t)(b * Hkv + h) * QT + qt) * S + s) * QG;
  for (int i = tid; i < QG * D; i += THREADS) acc_out[out0 * D + i] = acc_s[i];
  for (int r = tid; r < QG; r += THREADS) {
    m_out[out0 + r] = m_s[r];
    l_out[out0 + r] = l_s[r];
  }
}

size_t smem_bytes(int QG, int D) {
  const int Dp = D | 1;
  return sizeof(float) * (2 * (size_t)QG * D + 2 * QG + 2 * (size_t)KB * Dp)
         + sizeof(int) * (KB + QG);
}

template <typename T>
cudaError_t launch(const void* q, const int* positions, const int* start,
                   const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* page_pos, const int* tables, float* acc,
                   float* m, float* l, int B, int Hkv, int C, int Tq, int G,
                   int D, int ps, int T_tab, int S, int P, int window,
                   int quantized, cudaStream_t stream) {
  const size_t smem = smem_bytes(Tq * G, D);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hkv, C / Tq, S);
  paged_attn_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), positions, start, k_pool, v_pool, k_scale,
      v_scale, page_pos, tables, acc, m, l, Hkv, C, Tq, G, D, ps, T_tab, P,
      window, quantized);
  return cudaGetLastError();
}

}  // namespace

// q (B, Hkv, C/Tq, Tq·G, D) in the compute dtype (0 bf16, 1 fp16, 2 fp32);
// positions (B, C) and start (B,) int32; k/v pools (nb, ps, Hkv, D) in the
// compute dtype, or int8 with fp32 scales (nb, ps, Hkv) when quantized;
// page_pos (nb, ps) int32; tables (B, T_tab) int32 (-1 = null block) with
// T_tab = S·P. Writes acc (B, Hkv, C/Tq, S, Tq·G, D) and m, l
// (B, Hkv, C/Tq, S, Tq·G), fp32. The caller guarantees D <= 256 and a
// shared-memory footprint the card can hold.
extern "C" int paged_attention_partials(
    const void* q, const void* positions, const void* start,
    const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* page_pos, const void* tables, void* acc,
    void* m, void* l, int B, int Hkv, int C, int Tq, int G, int D, int ps,
    int T_tab, int S, int P, int window, int quantized, int dtype,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(positions);
  const int* sta = static_cast<const int*>(start);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* pp = static_cast<const int*>(page_pos);
  const int* tb = static_cast<const int*>(tables);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  cudaError_t err;
  if (dtype == 0)
    err = launch<__nv_bfloat16>(q, pos, sta, k_pool, v_pool, ks, vs, pp, tb,
                                a, mm, ll, B, Hkv, C, Tq, G, D, ps, T_tab, S,
                                P, window, quantized, st);
  else if (dtype == 1)
    err = launch<__half>(q, pos, sta, k_pool, v_pool, ks, vs, pp, tb, a, mm,
                         ll, B, Hkv, C, Tq, G, D, ps, T_tab, S, P, window,
                         quantized, st);
  else
    err = launch<float>(q, pos, sta, k_pool, v_pool, ks, vs, pp, tb, a, mm,
                        ll, B, Hkv, C, Tq, G, D, ps, T_tab, S, P, window,
                        quantized, st);
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
