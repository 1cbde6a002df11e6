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
//   * One block of 8 warps per (slot·kv-head, Q tile, page partition), the
//     planner's grid. The partition's table entries are read once into
//     shared memory (a -1 entry is the null block 0), and its keys stream
//     through a ring of shared-memory stages (`kb` keys each, 2-3 stages in
//     flight) filled by 16-byte cp.async: a token's head slice is D·2 bytes
//     (ten copies at D = 80). Every thread issues copies; no copy waits for
//     compute. The gathered window never exists in device memory.
//   * kv8_channel pages cross device memory as int8 with their fp32
//     per-(token, head) scales and are converted in shared memory after
//     they land (int8 × scale in fp32, rounded to the compute dtype, as
//     kv_dequantize does).
//   * Tensor cores (attn_tile.cuh): a warp owns 16 query rows, held as
//     mma A fragments in registers; QKᵀ and PV run on mma.sync.m16n8k16
//     over 16-key sub-tiles, with the scores, the softmax weights and the
//     output accumulator in registers. Chunks (Tq·G = 128 rows) put one row
//     group on each warp. Decode (G = 4 rows, padded to one 16-row tile)
//     puts the warps on different sub-tiles of each stage instead and
//     merges their (m, l, acc) in shared memory at the end; mixed shapes
//     split the warps between row groups and key groups.
//   * Masking is positional on the pool's page_pos tags: kpos >= 0,
//     kpos <= qpos, kpos < start (and kpos > qpos - window), with masked
//     scores set to -1e30 — not -inf — so fully masked tiles behave as in
//     JAX: a partition with no live key keeps m = -1e30 and cancels in the
//     combine through exp(-1e30 - m_max) = 0. Keys past the partition's end
//     (its last stage is partial) are -inf and never enter l.
//   * fp32 (the reduced configurations) runs the same blocks, with the
//     products on CUDA cores (attn_tile.cuh).
//   The shared-memory layout is mirrored by kernels/paged_attention.py
//   (paged_geometry), which also picks kb, the stage count and the key
//   groups; the launcher refuses a footprint that differs from it.

#include "attn_tile.cuh"

namespace {

using namespace attn;

constexpr int THREADS = 256;          // 8 warps

struct Args {
  const void* q;                  // (B, Hkv, QT, QG, D), compute dtype
  const int* positions;           // (B, C)
  const int* start;               // (B,)
  const void* k_pool;             // (nb, ps, Hkv, D)
  const void* v_pool;
  const float* k_scale;           // (nb, ps, Hkv) when quantized
  const float* v_scale;
  const int* page_pos;            // (nb, ps)
  const int* tables;              // (B, T_tab)
  float* acc;                     // (B, Hkv, QT, S, QG, D)
  float* m;                       // (B, Hkv, QT, S, QG)
  float* l;
  int Hkv, C, Tq, G, ps, T_tab, P, window, kb, stages, key_groups;
};

// byte offsets into dynamic shared memory, 128-aligned. Per stage (offsets
// within a stage): K and V tiles in the compute dtype, or, quantized, raw
// int8 K and V and their scales; then the stage's position tags. The
// merge area of the key groups reuses the ring once the keys are done.
struct Layout {
  size_t tbl, q, ring, stage, k, v, ksc, vsc, kpos, deq_k, deq_v, merge,
      bytes;
};

template <typename T, int D, bool QUANT>
__host__ __device__ inline Layout layout(int QG, int kb, int stages, int P,
                                         int key_groups) {
  constexpr int LD = tile_ld<T, D>();
  constexpr size_t E = sizeof(T);
  const size_t rows = (QG + 15) / 16 * 16;
  const size_t tile = align128(E * kb * LD);
  Layout L{};
  size_t off = 0;
  L.tbl = off; off = align128(off + 4 * (size_t)P);
  L.q = off; off = align128(off + E * rows * LD);
  L.ring = off;
  size_t so = 0;
  if (QUANT) {
    L.k = so; so = align128(so + (size_t)kb * D);
    L.v = so; so = align128(so + (size_t)kb * D);
    L.ksc = so; so = align128(so + 4 * (size_t)kb);
    L.vsc = so; so = align128(so + 4 * (size_t)kb);
  } else {
    L.k = so; so += tile;
    L.v = so; so += tile;
  }
  L.kpos = so; so = align128(so + 4 * (size_t)kb);
  L.stage = so;
  off += stages * so;
  if (QUANT) {
    L.deq_k = off; off += tile;
    L.deq_v = off; off += tile;
  }
  L.merge = L.ring;
  if (key_groups > 1) {
    const size_t need = align128(4 * (size_t)key_groups * rows * (D + 2));
    if (L.ring + need > off) off = L.ring + need;
  }
  L.bytes = off;
  return L;
}

// stage `st` of the partition's keys into ring slot `slot`: this thread's
// share of the 16-byte copies (zero-filled past the partition's end)
template <typename T, int D, bool QUANT>
__device__ __forceinline__ void load_stage(const Args& a, const Layout& L,
                                           unsigned char* smem,
                                           const int* tbl, int h, int st,
                                           int slot, int nkeys) {
  constexpr int LD = tile_ld<T, D>();
  unsigned char* base = smem + L.ring + (size_t)slot * L.stage;
  const int key0 = st * a.kb;
  if constexpr (QUANT) {
    constexpr int CH = D / 16;                        // 16 int8 a copy
    const int8_t* kp = static_cast<const int8_t*>(a.k_pool);
    const int8_t* vp = static_cast<const int8_t*>(a.v_pool);
    for (int i = threadIdx.x; i < a.kb * CH; i += THREADS) {
      const int j = i / CH, c = i - j * CH, key = key0 + j;
      const bool ok = key < nkeys;
      const size_t tok = ok ? (size_t)tbl[key / a.ps] * a.ps + key % a.ps : 0;
      const size_t e = (tok * a.Hkv + h) * D + c * 16;
      cp_async16(base + L.k + j * D + c * 16, kp + e, ok);
      cp_async16(base + L.v + j * D + c * 16, vp + e, ok);
    }
    for (int j = threadIdx.x; j < a.kb; j += THREADS) {
      const int key = key0 + j;
      const bool ok = key < nkeys;
      const size_t tok = ok ? (size_t)tbl[key / a.ps] * a.ps + key % a.ps : 0;
      cp_async4(base + L.ksc + 4 * j, a.k_scale + tok * a.Hkv + h, ok);
      cp_async4(base + L.vsc + 4 * j, a.v_scale + tok * a.Hkv + h, ok);
      cp_async4(base + L.kpos + 4 * j, a.page_pos + tok, ok);
    }
  } else {
    constexpr int CE = 16 / sizeof(T);                // elements a copy
    constexpr int CH = D / CE;
    const T* kp = static_cast<const T*>(a.k_pool);
    const T* vp = static_cast<const T*>(a.v_pool);
    T* ks = reinterpret_cast<T*>(base + L.k);
    T* vs = reinterpret_cast<T*>(base + L.v);
    for (int i = threadIdx.x; i < a.kb * CH; i += THREADS) {
      const int j = i / CH, c = i - j * CH, key = key0 + j;
      const bool ok = key < nkeys;
      const size_t tok = ok ? (size_t)tbl[key / a.ps] * a.ps + key % a.ps : 0;
      const size_t e = (tok * a.Hkv + h) * D + c * CE;
      cp_async16(ks + j * LD + c * CE, kp + e, ok);
      cp_async16(vs + j * LD + c * CE, vp + e, ok);
    }
    for (int j = threadIdx.x; j < a.kb; j += THREADS) {
      const int key = key0 + j;
      const bool ok = key < nkeys;
      const size_t tok = ok ? (size_t)tbl[key / a.ps] * a.ps + key % a.ps : 0;
      cp_async4(base + L.kpos + 4 * j, a.page_pos + tok, ok);
    }
  }
}

// int8 × fp32 scale → T for one landed stage, eight elements a thread step
template <typename T, int D>
__device__ __forceinline__ void dequant_stage(const unsigned char* raw,
                                              const float* scale, T* out,
                                              int kb) {
  constexpr int LD = tile_ld<T, D>();
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < kb * CH; i += THREADS) {
    const int j = i / CH, c = i - j * CH;
    const uint2 w = *reinterpret_cast<const uint2*>(raw + j * D + c * 8);
    const int8_t* b = reinterpret_cast<const int8_t*>(&w);
    const float sc = scale[j];
    alignas(16) T v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = from_f<T>(__fmul_rn(static_cast<float>(b[e]), sc));
    T* dst = out + j * LD + c * 8;
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    } else {
      reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(v)[0];
      reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(v)[1];
    }
  }
}

template <typename T, int D, bool QUANT>
__global__ void __launch_bounds__(THREADS) paged_attn_kernel(const Args a) {
  constexpr int LD = tile_ld<T, D>();
  constexpr int DN = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int QG = a.Tq * a.G;
  const Layout L = layout<T, D, QUANT>(QG, a.kb, a.stages, a.P,
                                       a.key_groups);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.Hkv, h = blockIdx.x % a.Hkv;
  const int qt = blockIdx.y, QT = gridDim.y;
  const int s = blockIdx.z, S = gridDim.z;
  const int RW = (QG + 15) / 16, KW = a.key_groups;
  const int rows = RW * 16;
  const int rg = warp % RW, kw = warp / RW;
  const bool active = warp < RW * KW;
  const int nkeys = a.P * a.ps;
  const int nstages = (nkeys + a.kb - 1) / a.kb;

  int* tbl = reinterpret_cast<int*>(smem + L.tbl);
  const int* trow = a.tables + (size_t)b * a.T_tab + (size_t)s * a.P;
  for (int i = tid; i < a.P; i += THREADS) {
    const int page = trow[i];
    tbl[i] = page < 0 ? 0 : page;                       // null block
  }
  __syncthreads();

  // group 0: the Q tile (rows past QG zero-filled) and stage 0
  T* q_s = reinterpret_cast<T*>(smem + L.q);
  {
    constexpr int CE = 16 / sizeof(T), CH = D / CE;
    const size_t row0 = ((size_t)(b * a.Hkv + h) * QT + qt) * QG;
    const T* qsrc = static_cast<const T*>(a.q) + row0 * D;
    for (int i = tid; i < rows * CH; i += THREADS) {
      const int r = i / CH, c = i - r * CH;
      cp_async16(q_s + r * LD + c * CE, qsrc + (r < QG ? r : 0) * D + c * CE,
                 r < QG);
    }
  }
  for (int st = 0; st < a.stages - 1; ++st) {
    if (st < nstages) load_stage<T, D, QUANT>(a, L, smem, tbl, h, st, st,
                                              nkeys);
    cp_async_commit();
  }

  // this lane's two query rows and their positions
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rg * 16 + g + 8 * r;
    qpos[r] = row < QG ? a.positions[(size_t)b * a.C + qt * a.Tq + row / a.G]
                       : -1;
  }
  const int st_pos = a.start[b];

  QFrag<T, D> qf;
  float m[2] = {MASKED, MASKED}, l[2] = {0.0f, 0.0f};
  float acc[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int nsub = a.kb / 16;
  for (int st = 0; st < nstages; ++st) {
    cp_async_wait(a.stages - 2);     // this thread's copies of stage st
    __syncthreads();                 // everyone's; slot (st - 1) is free
    const int nxt = st + a.stages - 1;
    if (nxt < nstages)
      load_stage<T, D, QUANT>(a, L, smem, tbl, h, nxt, nxt % a.stages,
                              nkeys);
    cp_async_commit();

    unsigned char* base = smem + L.ring + (size_t)(st % a.stages) * L.stage;
    const int* kpos = reinterpret_cast<const int*>(base + L.kpos);
    const T* k_t;
    const T* v_t;
    if constexpr (QUANT) {
      T* dk = reinterpret_cast<T*>(smem + L.deq_k);
      T* dv = reinterpret_cast<T*>(smem + L.deq_v);
      dequant_stage<T, D>(base + L.k,
                          reinterpret_cast<const float*>(base + L.ksc), dk,
                          a.kb);
      dequant_stage<T, D>(base + L.v,
                          reinterpret_cast<const float*>(base + L.vsc), dv,
                          a.kb);
      __syncthreads();
      k_t = dk;
      v_t = dv;
    } else {
      k_t = reinterpret_cast<const T*>(base + L.k);
      v_t = reinterpret_cast<const T*>(base + L.v);
    }
    if (st == 0) qf.load(q_s + rg * 16 * LD, LD, lane);
    if (!active) continue;

    for (int sub = kw; sub < nsub; sub += KW) {
      const int key0 = st * a.kb + sub * 16;
      if (key0 >= nkeys) break;
      float sc[2][4];
      warp_scores<T, D, 2>(sc, qf, k_t + sub * 16 * LD, LD, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = sub * 16 + nt * 8 + 2 * t + c;
          const int kp = kpos[j];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int qp = qpos[r];
            bool ok = kp >= 0 && kp <= qp && kp < st_pos;
            if (a.window) ok = ok && kp > qp - a.window;
            float& x = sc[nt][2 * r + c];
            x = st * a.kb + j >= nkeys ? -INFINITY : (ok ? x : MASKED);
          }
        }
      softmax_step<2, DN>(sc, m, l, acc);
      warp_pv<T, D, 2>(acc, sc, v_t + sub * 16 * LD, LD, lane);
    }
  }
  cp_async_wait(0);
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);

  const size_t out0 = (((size_t)(b * a.Hkv + h) * QT + qt) * S + s) * QG;
  if (KW == 1) {
    if (!active) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rg * 16 + g + 8 * r;
      if (row >= QG) continue;
      float* dst = a.acc + (out0 + row) * D + 2 * t;
#pragma unroll
      for (int nt = 0; nt < DN; ++nt)
        *reinterpret_cast<float2*>(dst + nt * 8) =
            make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
      if (t == 0) {
        a.m[out0 + row] = m[r];
        a.l[out0 + row] = l[r];
      }
    }
    return;
  }

  // key groups: merge the partial (m, l, acc) of each row group's warps
  __syncthreads();                   // the ring is no longer read
  float* mg_acc = reinterpret_cast<float*>(smem + L.merge);
  float* mg_m = mg_acc + (size_t)KW * rows * D;
  float* mg_l = mg_m + (size_t)KW * rows;
  if (active) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rg * 16 + g + 8 * r;
      float* dst = mg_acc + ((size_t)kw * rows + row) * D + 2 * t;
#pragma unroll
      for (int nt = 0; nt < DN; ++nt)
        *reinterpret_cast<float2*>(dst + nt * 8) =
            make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
      if (t == 0) {
        mg_m[kw * rows + row] = m[r];
        mg_l[kw * rows + row] = l[r];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < QG * D; i += THREADS) {
    const int row = i / D, d = i - row * D;
    float mx = MASKED;
    for (int k = 0; k < KW; ++k) mx = fmaxf(mx, mg_m[k * rows + row]);
    float sum = 0.0f;
    for (int k = 0; k < KW; ++k)
      sum += mg_acc[((size_t)k * rows + row) * D + d]
             * expf(mg_m[k * rows + row] - mx);
    a.acc[(out0 + row) * D + d] = sum;
  }
  for (int row = tid; row < QG; row += THREADS) {
    float mx = MASKED;
    for (int k = 0; k < KW; ++k) mx = fmaxf(mx, mg_m[k * rows + row]);
    float sum = 0.0f;
    for (int k = 0; k < KW; ++k)
      sum += mg_l[k * rows + row] * expf(mg_m[k * rows + row] - mx);
    a.m[out0 + row] = mx;
    a.l[out0 + row] = sum;
  }
}

template <typename T, int D, bool QUANT>
cudaError_t launch(const Args& a, int B, int QT, int S, int smem,
                   cudaStream_t stream) {
  const Layout L = layout<T, D, QUANT>(a.Tq * a.G, a.kb, a.stages, a.P,
                                       a.key_groups);
  if (L.bytes != static_cast<size_t>(smem))   // the wrapper's geometry
    return cudaErrorInvalidValue;             // disagrees with this layout
  cudaError_t err = cudaFuncSetAttribute(
      paged_attn_kernel<T, D, QUANT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * a.Hkv, QT, S);
  paged_attn_kernel<T, D, QUANT><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_q(const Args& a, int quantized, int B, int QT, int S,
                     int smem, cudaStream_t st) {
  return quantized ? launch<T, D, true>(a, B, QT, S, smem, st)
                   : launch<T, D, false>(a, B, QT, S, smem, st);
}

template <typename T>
cudaError_t launch_d(const Args& a, int D, int quantized, int B, int QT,
                     int S, int smem, cudaStream_t st) {
  switch (D) {
    case 32: return launch_q<T, 32>(a, quantized, B, QT, S, smem, st);
    case 64: return launch_q<T, 64>(a, quantized, B, QT, S, smem, st);
    case 80: return launch_q<T, 80>(a, quantized, B, QT, S, smem, st);
    case 96: return launch_q<T, 96>(a, quantized, B, QT, S, smem, st);
    case 128: return launch_q<T, 128>(a, quantized, B, QT, S, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hkv, C/Tq, Tq·G, D) in the compute dtype (0 bf16, 1 fp16, 2 fp32);
// positions (B, C) and start (B,) int32; k/v pools (nb, ps, Hkv, D) in the
// compute dtype, or int8 with fp32 scales (nb, ps, Hkv) when quantized;
// page_pos (nb, ps) int32; tables (B, T_tab) int32 (-1 = null block) with
// T_tab = S·P. Writes acc (B, Hkv, C/Tq, S, Tq·G, D) and m, l
// (B, Hkv, C/Tq, S, Tq·G), fp32. kb (keys a stage), stages, key_groups and
// smem (bytes) come from the wrapper's paged_geometry; D is one of 32, 64,
// 80, 96, 128 and Tq·G <= 128.
extern "C" int paged_attention_partials(
    const void* q, const void* positions, const void* start,
    const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* page_pos, const void* tables, void* acc,
    void* m, void* l, int B, int Hkv, int C, int Tq, int G, int D, int ps,
    int T_tab, int S, int P, int window, int quantized, int dtype, int kb,
    int stages, int key_groups, int smem, void* stream) {
  Args a{q, static_cast<const int*>(positions),
         static_cast<const int*>(start), k_pool, v_pool,
         static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale),
         static_cast<const int*>(page_pos), static_cast<const int*>(tables),
         static_cast<float*>(acc), static_cast<float*>(m),
         static_cast<float*>(l), Hkv, C, Tq, G, ps, T_tab, P, window, kb,
         stages, key_groups};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int QT = C / Tq;
  cudaError_t err;
  if (dtype == 0)
    err = launch_d<__nv_bfloat16>(a, D, quantized, B, QT, S, smem, st);
  else if (dtype == 1)
    err = launch_d<__half>(a, D, quantized, B, QT, S, smem, st);
  else
    err = launch_d<float>(a, D, quantized, B, QT, S, smem, st);
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
