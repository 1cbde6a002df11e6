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
//   for 64 query rows, so the QKᵀ and PV products (4·D FLOP per unmasked
//   (q, k) pair) are ~100x the bytes of q, k, v and o; the least time is
//   those FLOPs over 989 TFLOP/s (bf16 tensor cores).
//
// What the design does about it (the simple first kernel):
//   * One block of 4 warps per (b, query head, 64-row query tile) walks
//     64-key tiles from the first one its window reaches to the last one
//     causality lets it see; tiles masked for every row of the block are
//     never loaded (half the work at S = 8192 with window 4096). Heavy
//     causal tiles launch first.
//   * Q, K and V tiles are staged in shared memory with 16-byte loads
//     straight from the (B, S, H, D) layout through its strides (no
//     transposed copies); ragged edges (S not a multiple of 64, Sq != Skv)
//     load zeros and are masked by position.
//   * bf16: QKᵀ and PV on WMMA 16x16x16 fragments with fp32 accumulators;
//     each warp owns 16 query rows end to end (scores, softmax, rescale,
//     PV), so only the K/V staging needs the whole block. The score tile
//     and the output accumulator are fp32 in shared memory (~82 KB at
//     D = 80, ~113 KB at D = 128: dynamic shared memory).
//   * fp32 runs the same blocks on CUDA-core FMAs (the reduced configs).
//   No TMA, no wgmma, no pipelining of the K/V loads yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int THREADS = 128;     // 4 warps x 16 query rows
constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per KV tile
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;                        // (B, Sq, Hq, D), contiguous
  float* lse;                     // (B, Hq, Sq)
  long long qs[3], ks[3], vs[3];  // (b, s, h) strides in elements
  int Sq, Skv, Hq, Hkv, D, causal, window;
  float scale;
};

// shared-memory layout (byte offsets, 128-aligned); leading dimensions in
// elements. fp32 tiles use odd strides (conflict-free column walks of the
// FMA loops); 16-bit tiles pad by 8 elements (WMMA needs multiples of 8)
struct Layout {
  int ldt, lds, ldp, ldo;
  size_t q, k, v, s, p, o, m, l, bytes;
};

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

template <typename T>
__host__ __device__ inline Layout layout(int D) {
  constexpr bool F32 = std::is_same<T, float>::value;
  Layout L;
  L.ldt = F32 ? D + 1 : D + 8;
  L.lds = F32 ? BK + 1 : BK + 4;
  L.ldp = F32 ? BK + 1 : BK + 8;
  L.ldo = F32 ? D + 1 : D + 4;
  size_t off = 0;
  L.q = off; off = align128(off + sizeof(T) * BQ * L.ldt);
  L.k = off; off = align128(off + sizeof(T) * BK * L.ldt);
  L.v = off; off = align128(off + sizeof(T) * BK * L.ldt);
  L.s = off; off = align128(off + sizeof(float) * BQ * L.lds);
  if (F32) {
    L.p = L.s;                    // fp32 p overwrites its score in place
  } else {
    L.p = off; off = align128(off + sizeof(T) * BQ * L.ldp);
  }
  L.o = off; off = align128(off + sizeof(float) * BQ * L.ldo);
  L.m = off; off = align128(off + sizeof(float) * BQ);
  L.l = off; off = align128(off + sizeof(float) * BQ);
  L.bytes = off;
  return L;
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

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
  return __float2bfloat16_rn(v);
}

// rows row0 .. row0+63 of one head into a (64, ld) tile; rows >= S are 0
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* base,
                                           long long ss, int row0, int S,
                                           int D) {
  if constexpr (std::is_same<T, float>::value) {
    for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
      const int r = i / D, d = i - r * D, s = row0 + r;
      dst[r * ld + d] = s < S ? base[s * ss + d] : 0.0f;
    }
  } else {
    const int chunks = D / 8;                    // 16 bytes each
    for (int i = threadIdx.x; i < 64 * chunks; i += THREADS) {
      const int r = i / chunks, c = i - r * chunks, s = row0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (s < S)
        val = *reinterpret_cast<const uint4*>(base + s * ss + c * 8);
      *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = val;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Args a) {
  constexpr bool F32 = std::is_same<T, float>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D;
  const Layout L = layout<T>(D);
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* Os = reinterpret_cast<float*>(smem + L.o);
  float* Ms = reinterpret_cast<float*>(smem + L.m);
  float* Ls = reinterpret_cast<float*>(smem + L.l);

  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16;
  const int qt = gridDim.x - 1 - blockIdx.x;     // heavy causal tiles first
  const int b = blockIdx.y / a.Hq, hq = blockIdx.y % a.Hq;
  const int hk = hq / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;

  const T* qb = static_cast<const T*>(a.q) + b * a.qs[0] + hq * a.qs[2];
  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[2];

  stage_rows<T>(Qs, L.ldt, qb, a.qs[1], q0, a.Sq, D);
  for (int i = tid; i < BQ * L.ldo; i += THREADS) Os[i] = 0.0f;
  for (int r = tid; r < BQ; r += THREADS) {
    Ms[r] = NEG_INF;
    Ls[r] = 0.0f;
  }

  // the key tiles any row of this block can see
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int k_hi = a.causal ? min(a.Skv, q_last + 1) : a.Skv;
  const int kt_lo = k_lo / BK, kt_hi = (k_hi + BK - 1) / BK;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // the previous tile is consumed
    stage_rows<T>(Ks, L.ldt, kb, a.ks[1], k0, a.Skv, D);
    stage_rows<T>(Vs, L.ldt, vb, a.vs[1], k0, a.Skv, D);
    __syncthreads();

    // raw scores q·kᵀ of this warp's 16 rows x 64 keys, fp32
    if constexpr (F32) {
      const int r = r0 + (lane & 15), c0 = (lane >> 4) * 32;
      float acc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float qv = Qs[r * L.ldt + d];
#pragma unroll
        for (int j = 0; j < 32; ++j)
          acc[j] = fmaf(qv, Ks[(c0 + j) * L.ldt + d], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) Ss[r * L.lds + c0 + j] = acc[j];
    } else {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[BK / 16];
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(c[n], 0.0f);
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> qa;
        wmma::load_matrix_sync(qa, Qs + r0 * L.ldt + kk * 16, L.ldt);
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> kb_;
          wmma::load_matrix_sync(kb_, Ks + n * 16 * L.ldt + kk * 16, L.ldt);
          wmma::mma_sync(c[n], qa, kb_, c[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BK / 16; ++n)
        wmma::store_matrix_sync(Ss + r0 * L.lds + n * 16, c[n], L.lds,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time across the warp (2 keys a lane)
    T* Ps = reinterpret_cast<T*>(smem + L.p);
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr, qpos = q0 + r;
      float sv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h, kpos = k0 + c;
        const float s = Ss[r * L.lds + c] * a.scale;
        bool ok = kpos < a.Skv;
        if (a.causal) ok = ok && kpos <= qpos;
        if (a.window > 0) ok = ok && kpos > qpos - a.window;
        sv[h] = ok ? s : NEG_INF;
      }
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(sv[0], sv[1])));
      const float p0 = expf(sv[0] - m_new), p1 = expf(sv[1] - m_new);
      const float corr = expf(m_prev - m_new);
      const float psum = warp_sum(p0 + p1);
      if constexpr (F32) {
        Ss[r * L.lds + lane] = p0;
        Ss[r * L.lds + lane + 32] = p1;
      } else {
        Ps[r * L.ldp + lane] = from_f<T>(p0);        // p in v's dtype
        Ps[r * L.ldp + lane + 32] = from_f<T>(p1);
      }
      for (int d = lane; d < D; d += 32) Os[r * L.ldo + d] *= corr;
      __syncwarp();
      if (lane == 0) {
        Ms[r] = m_new;
        Ls[r] = Ls[r] * corr + psum;
      }
    }
    __syncwarp();

    // acc += p · v for this warp's 16 rows
    if constexpr (F32) {
      const int r = r0 + (lane & 15), dh = lane >> 4;
      float o[MAX_D / 2];
#pragma unroll
      for (int i = 0; i < MAX_D / 2; ++i) {
        const int d = dh + 2 * i;
        o[i] = d < D ? Os[r * L.ldo + d] : 0.0f;
      }
      for (int j = 0; j < BK; ++j) {
        const float pj = Ss[r * L.lds + j];
        const float* vr = Vs + j * L.ldt;
#pragma unroll
        for (int i = 0; i < MAX_D / 2; ++i) {
          const int d = dh + 2 * i;
          if (d < D) o[i] = fmaf(pj, vr[d], o[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < MAX_D / 2; ++i) {
        const int d = dh + 2 * i;
        if (d < D) Os[r * L.ldo + d] = o[i];
      }
    } else {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>
          pa[BK / 16];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(pa[kk], Ps + r0 * L.ldp + kk * 16, L.ldp);
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
        wmma::load_matrix_sync(c, Os + r0 * L.ldo + n * 16, L.ldo,
                               wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, Vs + kk * 16 * L.ldt + n * 16, L.ldt);
          wmma::mma_sync(c, pa[kk], vf, c);
        }
        wmma::store_matrix_sync(Os + r0 * L.ldo + n * 16, c, L.ldo,
                                wmma::mem_row_major);
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // o = acc / max(l, 1e-30) in q's dtype; lse = m + log(l)
  T* ob = static_cast<T*>(a.o);
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr, qpos = q0 + r;
    if (qpos >= a.Sq) break;
    const float l = Ls[r];
    const float den = fmaxf(l, 1e-30f);
    T* orow = ob + ((static_cast<long long>(b) * a.Sq + qpos) * a.Hq + hq) * D;
    for (int d = lane; d < D; d += 32)
      orow[d] = from_f<T>(Os[r * L.ldo + d] / den);
    if (lane == 0)
      a.lse[(static_cast<long long>(b) * a.Hq + hq) * a.Sq + qpos] =
          Ms[r] + logf(l);
  }
}

template <typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = layout<T>(a.D).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + BQ - 1) / BQ, B * a.Hq);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), all bf16 (dtype 0) or fp32
// (dtype 2), given by their (b, s, h) strides in elements (the last dim
// contiguous). Writes o (B, Sq, Hq, D) contiguous in that dtype and lse
// (B, Hq, Sq) fp32. The caller guarantees D % 16 == 0, D <= 128,
// Hq % Hkv == 0, 16-byte aligned rows and B·Hq <= 65535.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int B, int Sq, int Skv, int Hq, int Hkv, int D,
    int causal, int window, float scale, int dtype, void* stream) {
  Args a{q, k, v, o, static_cast<float*>(lse),
         {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
         Sq, Skv, Hq, Hkv, D, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch<__nv_bfloat16>(a, B, st)
                               : launch<float>(a, B, st);
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
