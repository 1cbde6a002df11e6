// Flash-attention forward for Hopper: causal / sliding-window / non-causal
// GQA attention over (B, S, H, D) tensors, one online-softmax pass, plus the
// per-row log-sum-exp that the gradient recomputes P from.
//
// Replaces: src/repro/kernels/flash_attention.py:81 `flash_attention`
//   (pallas_call at :115, kernel body _make_kernel :29-74): the same
//   function term for term. Scores are q·kᵀ accumulated in fp32 and then
//   multiplied by D^-0.5; masks kpos < Skv, kpos <= qpos (causal) and
//   kpos > qpos - window; masked scores -1e30 (never -inf); online softmax
//   in fp32; p cast to v's dtype before the PV product, summed in fp32;
//   the output acc / max(l, 1e-30) cast to q's dtype. Query head h reads
//   KV head h / G, the Pallas kernel's kv_row index map.
//
// What bounds it on the H100: operations. At the training shapes (S 2048
//   to 8192, D = 80, G = 4) a query tile reuses every K/V byte it stages
//   for 128 query rows, so the QKᵀ and PV products (4·D FLOP per unmasked
//   (q, k) pair) are ~100x the bytes of q, k, v and o; the least time is
//   those FLOPs over 989 TFLOP/s (bf16 tensor cores).
//
// What the design does about it (FlashAttention-2's shape on mma.sync):
//   * One block of 8 warps per (b, query head, 128-row query tile), two
//     blocks to an SM in bf16; each warp owns 16 query rows end to end.
//     Its Q rows are mma A fragments in registers; QKᵀ and PV run on
//     mma.sync.m16n8k16 (attn_tile.cuh) over 64-key tiles, and the scores,
//     the softmax weights (repacked from the accumulator layout into A
//     fragments) and the 16 x D fp32 output accumulator never leave
//     registers.
//   * K/V tiles arrive by 16-byte cp.async into a ring of 2-3
//     shared-memory stages (padded rows: ldmatrix without bank conflicts),
//     straight from the strided (B, S, H, D) layout, so the next tiles load
//     while the current one is multiplied; ragged edges (S not a multiple
//     of the tile, Sq != Skv) are zero-filled and masked by position, keys
//     past Skv with -inf.
//   * Only the key tiles that some row of the block can see are loaded
//     (half the work at S = 8192 with window 4096), and a warp skips the
//     tiles its own 16 rows cannot see; masks are applied only on tiles
//     that straddle an edge. Heavy causal tiles launch first, and the G
//     query heads of one KV head and query tile are neighbouring blocks, so
//     their K/V come from L2 rather than four times from device memory.
//   * fp32 (the reduced configurations) runs the same blocks, with the
//     products on CUDA cores (attn_tile.cuh).
//   Not yet: wgmma, TMA, a producer warp (see PERF.md). The shared-memory
//   layout is mirrored by kernels/flash_attention.py (flash_geometry),
//   which also picks the stage count; the launcher refuses a footprint that
//   differs from it.

#include "attn_tile.cuh"

namespace {

using namespace attn;

constexpr int THREADS = 256;     // 8 warps x 16 query rows
constexpr int BQ = 128;          // query rows per block
constexpr int BK = 64;           // keys per KV tile
constexpr int NT = BK / 8;       // 8-key mma tiles per KV tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;                        // (B, Sq, Hq, D), contiguous
  float* lse;                     // (B, Hq, Sq)
  long long qs[3], ks[3], vs[3];  // (b, s, h) strides in elements
  int B, Sq, Skv, Hq, Hkv, causal, window, stages;
  float scale;
};

// byte offsets: the Q tile, then the ring of (K, V) stages
struct Layout {
  size_t q, ring, k, v, stage, bytes;
};

template <typename T, int D>
__host__ __device__ inline Layout layout(int stages) {
  constexpr int LD = tile_ld<T, D>();
  const size_t tile = align128(sizeof(T) * (size_t)BK * LD);
  Layout L{};
  L.q = 0;
  L.ring = align128(sizeof(T) * (size_t)BQ * LD);
  L.k = 0;
  L.v = tile;
  L.stage = 2 * tile;
  L.bytes = L.ring + stages * L.stage;
  return L;
}

// rows row0 .. row0 + n - 1 of one head into an (n, LD) tile, 16 bytes a
// copy; rows >= S are zero-filled
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* base,
                                          long long stride, int row0, int n,
                                          int S) {
  constexpr int LD = tile_ld<T, D>();
  constexpr int CE = 16 / sizeof(T), CH = D / CE;
  for (int i = threadIdx.x; i < n * CH; i += THREADS) {
    const int r = i / CH, c = i - r * CH, s = row0 + r;
    const bool ok = s < S;
    cp_async16(dst + r * LD + c * CE, base + (ok ? s : 0) * stride + c * CE,
               ok);
  }
}

// two blocks to an SM where their shared memory fits (16-bit, D <= 96):
// at most 128 registers a thread (a few bytes spill at D = 80), faster on
// the H100 than one block of 164 registers; 32-row warps (two m-tiles,
// each K/V fragment feeding two products) need 255 registers, spill
// more and were slower still (PERF.md, PR 14)
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, (!is_f32<T>() && D <= 96) ? 2 : 1)
    flash_fwd_kernel(const Args a) {
  constexpr int LD = tile_ld<T, D>();
  constexpr int DN = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout<T, D>(a.stages);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // block order: query head within its KV group fastest, then KV head,
  // batch, and query tiles from the heaviest (last) causal tile down
  const int G = a.Hq / a.Hkv, QT = (a.Sq + BQ - 1) / BQ;
  int idx = blockIdx.x;
  const int gi = idx % G; idx /= G;
  const int hk = idx % a.Hkv; idx /= a.Hkv;
  const int b = idx % a.B;
  const int qt = QT - 1 - idx / a.B;
  const int hq = hk * G + gi;
  const int q0 = qt * BQ;

  const T* qb = static_cast<const T*>(a.q) + b * a.qs[0] + hq * a.qs[2];
  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[2];
  T* q_s = reinterpret_cast<T*>(smem + L.q);

  // the key tiles any row of this block can see
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int k_hi = a.causal ? min(a.Skv, q_last + 1) : a.Skv;
  const int kt_lo = k_lo / BK;
  const int ntiles = max(0, (k_hi + BK - 1) / BK - kt_lo);

  auto load_tile = [&](int i) {
    unsigned char* base = smem + L.ring + (size_t)(i % a.stages) * L.stage;
    const int k0 = (kt_lo + i) * BK;
    load_rows<T, D>(reinterpret_cast<T*>(base + L.k), kb, a.ks[1], k0, BK,
                    a.Skv);
    load_rows<T, D>(reinterpret_cast<T*>(base + L.v), vb, a.vs[1], k0, BK,
                    a.Skv);
  };

  // group 0: the Q tile and KV tile 0; then tiles 1 .. stages - 2
  load_rows<T, D>(q_s, qb, a.qs[1], q0, BQ, a.Sq);
  for (int i = 0; i < a.stages - 1; ++i) {
    if (i < ntiles) load_tile(i);
    cp_async_commit();
  }

  // this warp's rows and the key range they can see
  const int r_first = q0 + warp * 16;
  const int r_last = min(r_first + 15, a.Sq - 1);
  const bool rows_live = r_first < a.Sq;
  const int w_lo = a.window > 0 ? max(0, r_first - a.window + 1) : 0;
  const int w_hi = a.causal ? min(a.Skv, r_last + 1) : a.Skv;
  const int qpos[2] = {r_first + g, r_first + g + 8};

  QFrag<T, D> qf;
  float m[2] = {MASKED, MASKED}, l[2] = {0.0f, 0.0f};
  float acc[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait(a.stages - 2);     // this thread's copies of tile i
    __syncthreads();                 // everyone's; the oldest slot is free
    if (i + a.stages - 1 < ntiles) load_tile(i + a.stages - 1);
    cp_async_commit();
    if (i == 0) qf.load(q_s + warp * 16 * LD, LD, lane);

    const int k0 = (kt_lo + i) * BK;
    if (!rows_live || k0 >= w_hi || k0 + BK <= w_lo) continue;
    const unsigned char* base =
        smem + L.ring + (size_t)(i % a.stages) * L.stage;
    const T* k_t = reinterpret_cast<const T*>(base + L.k);
    const T* v_t = reinterpret_cast<const T*>(base + L.v);

    float s[NT][4];
    warp_scores<T, D, NT>(s, qf, k_t, LD, lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= a.scale;
    const bool edge = k0 + BK > a.Skv
        || (a.causal && k0 + BK - 1 > r_first)
        || (a.window > 0 && k0 <= r_last - a.window);
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
          const int qp = qpos[e >> 1];
          bool ok = true;
          if (a.causal) ok = kpos <= qp;
          if (a.window > 0) ok = ok && kpos > qp - a.window;
          s[nt][e] = kpos >= a.Skv ? -INFINITY : (ok ? s[nt][e] : MASKED);
        }
    }
    softmax_step<NT, DN>(s, m, l, acc);
    warp_pv<T, D, NT>(acc, s, v_t, LD, lane);
  }
  cp_async_wait(0);

  // o = acc / max(l, 1e-30) in q's dtype; lse = m + log(l)
  T* ob = static_cast<T*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    const int qp = qpos[r];
    if (qp >= a.Sq) continue;
    const float den = fmaxf(lr, 1e-30f);
    T* orow = ob + ((static_cast<long long>(b) * a.Sq + qp) * a.Hq + hq) * D
              + 2 * t;
#pragma unroll
    for (int nt = 0; nt < DN; ++nt) {
      const float x = acc[nt][2 * r] / den, y = acc[nt][2 * r + 1] / den;
      if constexpr (is_f32<T>())
        *reinterpret_cast<float2*>(orow + nt * 8) = make_float2(x, y);
      else
        *reinterpret_cast<uint32_t*>(orow + nt * 8) = pack2<T>(x, y);
    }
    if (t == 0)
      a.lse[(static_cast<long long>(b) * a.Hq + hq) * a.Sq + qp] =
          m[r] + logf(lr);
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int smem, cudaStream_t stream) {
  if (layout<T, D>(a.stages).bytes != static_cast<size_t>(smem))
    return cudaErrorInvalidValue;     // the wrapper's geometry disagrees
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)((a.Sq + BQ - 1) / BQ) * a.B * a.Hq;
  flash_fwd_kernel<T, D><<<static_cast<unsigned>(blocks), THREADS, smem,
                           stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, int D, int smem, cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(a, smem, st);
    case 64: return launch<T, 64>(a, smem, st);
    case 80: return launch<T, 80>(a, smem, st);
    case 96: return launch<T, 96>(a, smem, st);
    case 128: return launch<T, 128>(a, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), all bf16 (dtype 0) or fp32
// (dtype 2), given by their (b, s, h) strides in elements (the last dim
// contiguous). Writes o (B, Sq, Hq, D) contiguous in that dtype and lse
// (B, Hq, Sq) fp32. stages and smem (bytes) come from the wrapper's
// flash_geometry; D is one of 32, 64, 80, 96, 128, Hq % Hkv == 0, rows are
// 16-byte aligned.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    int causal, int window, float scale, int dtype, int stages, int smem,
    void* stream) {
  Args a{q, k, v, o, static_cast<float*>(lse),
         {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
         B, Sq, Skv, Hq, Hkv, causal, window, stages, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch_d<__nv_bfloat16>(a, D, smem, st)
                               : launch_d<float>(a, D, smem, st);
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
