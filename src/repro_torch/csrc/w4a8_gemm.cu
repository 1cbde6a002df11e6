// Fused W4A8 GEMM for Hopper: per-token int8 activations × int4 group
// weights with exact int32 sums per group:
//
//   out[m, n] = xs[m] · Σ_G ws[G, n] · (Σ_g xq[m, G, g]·wq[G, g, n]
//                                        − z[G, n]·Σ_g xq[m, G, g])
//
// with xq, xs = quantize_activations_int8(x) (s = max(amax / 127, 1e-8) by
// IEEE division, round half to even, clamp to ±127), cast to x's dtype. Two
// launches: quantize_rows_kernel, then w4a8_gemm_kernel.
//
// Replaces: src/repro/kernels/w4a8_fused.py:37 `w4a8_fused`
//   (template.tiled_matmul with GroupedInt4Raw and Int8GroupContraction,
//   template.py:233-256 and :341-364; pallas_call at template.py:449/:473),
//   together with the activation quantize before it and its `finalize`
//   (× the token scale, cast) after it.
//
// What bounds it on the H100: bytes. The packed weights (K·N/2) and group
//   scales dominate; a decode GEMM does about 4·M int8 operations per byte,
//   against the ~590 the int8 tensor cores (1,979 TOP/s) need before they
//   are the limit. At danube's shapes that is 0.3 to 3 µs, so first-data
//   latency and the count of launches weigh as much as bandwidth.
//
// What the design does about it:
//   * The quantize is one small kernel (a block per token row): the row's
//     amax, its scale, x_q, and Σx_q per (token, group), which the GEMM's
//     zero-point term needs, computed once and not per block. The GEMM is
//     launched as its programmatic dependent: its blocks start while the
//     quantize runs and put their first weight units in flight before they
//     wait for x_q (griddepcontrol). Quantizing inside the GEMM instead (each
//     block its own slice, the amax across its cluster) was slower at M = 8
//     and 32 (PERF.md): every column block repeats the divisions, and the
//     amax pass sits before the first product.
//   * mma.sync.m16n8k32 on int8 with the weight as the 16-row A operand and
//     the tokens as the 8-wide B operand ("swap AB"): M = 8 is one n8 tile.
//     B fragments of x_q come from the unit by ldmatrix.
//   * The weight is unpacked in registers with SIMD byte operations: a
//     thread owns the block's eight adjacent columns 8g .. 8g+7 (int_col),
//     so one 8-byte shared load of a packed row feeds eight A registers; the
//     nibbles become signed int8 by xor, and, __vsub4 and __byte_perm (about
//     one instruction per weight, no float). Packed rows are stored permuted
//     and half-swapped so that a half-warp's four rows hit four bank groups.
//   * Each warp runs its own units of 128 K rows (units w, w + 4, .. of the
//     block's slice), W4A8_STAGES deep in a cp.async ring of its own with no
//     block barrier, so a block keeps up to eight units in flight. A unit
//     holds whole scale groups (group 32, 64 or 128), so a warp's int32
//     accumulators hold a group's exact sum; at the group's last k step it
//     folds (acc − z·Σx_q)·s into fp32 accumulators in registers, the Pallas
//     contraction's arithmetic term for term (no FMA contraction). The four
//     warps' fp32 tiles are summed in warp order at the end.
//   * The K blocks of an output tile form a thread-block cluster and sum
//     their tiles in slice order through distributed shared memory, then
//     multiply by xs[m] and cast (finish_tile of gemm_tile.cuh): the output
//     is written once, in x's dtype. Beyond MAX_CLUSTER slices the kernel
//     writes fp32 partials, which the wrapper sums, scales and casts.
//   * Ragged M and N are masked; a slice's last unit may be short (its rows
//     a multiple of the group), its missing k steps skipped.

#include "gemm_tile.cuh"

namespace {

using gemm_tile::BN;
using gemm_tile::TC_THREADS;
using gemm_tile::W4A8_BK;
using gemm_tile::W4A8_STAGES;
using gemm_tile::WARPS;
using gemm_tile::XQ_LD;
using gemm_tile::align128;
using sm90::cp_async16;
using sm90::cp_async4;
using sm90::cp_async_commit;
using sm90::ldsm_x2;
using sm90::mma16832_s8;

// the columns of finish_tile: thread g's eight adjacent columns
struct IntCols {
  static constexpr bool INT_COLS = true;
  __device__ __forceinline__ static int col(int tile, int r) {
    return gemm_tile::int_col(tile, r);
  }
};

struct Params {
  gemm_tile::TcParams tc;     // M, N, K, L (K rows a block), sub, cluster,
                              // direct
  int gshift, sr;             // log2 of the scale group, groups a unit
  int stage_bytes;
  int off_z, off_xq, off_tok;  // offsets in a unit's stage
  int rows_off;               // the block's row scales
  int zeros;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// the plain version's quantizer, bit for bit: IEEE division, half to even,
// clamp to ±127
__device__ __forceinline__ int quant8(float v, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f),
                                127.0f));
}

// packed row pr of a unit sits at row pr ^ ((pr >> 1) & 1) of the stage,
// its 32-byte halves swapped when bit 2 of pr is set: the four rows 2t (or
// 2t + 1) that a half-warp reads at once land in four bank groups
__device__ __forceinline__ int w_off(int pr, int byte) {
  return (pr ^ ((pr >> 1) & 1)) * BN + (byte ^ (((pr >> 2) & 1) << 5));
}

// four columns' nibbles of packed rows 2t (u) and 2t + 1 (v), as four A
// registers: register j holds column j's k 4t .. 4t+3 as signed int8
__device__ __forceinline__ void unpack4(uint32_t u, uint32_t v,
                                        uint32_t* r) {
  // each nibble q as q + 8 in its own byte
  const uint32_t lu = (u ^ 0x88888888u) & 0x0F0F0F0Fu;
  const uint32_t hu = ((u >> 4) ^ 0x08080808u) & 0x0F0F0F0Fu;
  const uint32_t lv = (v ^ 0x88888888u) & 0x0F0F0F0Fu;
  const uint32_t hv = ((v >> 4) ^ 0x08080808u) & 0x0F0F0F0Fu;
  const uint32_t pu0 = __byte_perm(lu, hu, 0x5140);   // lu0 hu0 lu1 hu1
  const uint32_t pu1 = __byte_perm(lu, hu, 0x7362);   // lu2 hu2 lu3 hu3
  const uint32_t pv0 = __byte_perm(lv, hv, 0x5140);
  const uint32_t pv1 = __byte_perm(lv, hv, 0x7362);
  r[0] = __vsub4(__byte_perm(pu0, pv0, 0x5410), 0x08080808u);
  r[1] = __vsub4(__byte_perm(pu0, pv0, 0x7632), 0x08080808u);
  r[2] = __vsub4(__byte_perm(pu1, pv1, 0x5410), 0x08080808u);
  r[3] = __vsub4(__byte_perm(pu1, pv1, 0x7632), 0x08080808u);
}

// x_q, xs and Σx_q per group of one token row: one block a row, the row
// read once into registers (CPT 16-byte chunks a thread). It lets the GEMM
// launch as soon as it starts (griddepcontrol.launch_dependents); the GEMM
// waits for its results where it needs them.
constexpr int Q_THREADS = 256;
constexpr int Q_MAX_CPT = 16;                   // K·elem ≤ 64 KB a row

template <typename T, int CPT>
__global__ void __launch_bounds__(Q_THREADS)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, int* __restrict__ tok, int K,
                     int group) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ float red[Q_THREADS / 32];
  constexpr int PER = 16 / sizeof(T);           // elements a chunk
  const int m = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const int chunks = K / PER;
  const uint4* row = reinterpret_cast<const uint4*>(x + (size_t)m * K);
  uint4 v[CPT];
  float a = 0.0f;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = tid + Q_THREADS * i;
    if (c < chunks) {
      v[i] = row[c];
      const T* e = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
      for (int j = 0; j < PER; ++j) a = fmaxf(a, fabsf(to_float(e[j])));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  if (lane == 0) red[warp] = a;
  __syncthreads();
  a = red[0];
#pragma unroll
  for (int w = 1; w < Q_THREADS / 32; ++w) a = fmaxf(a, red[w]);
  const float s = fmaxf(__fdiv_rn(a, 127.0f), 1e-8f);
  if (tid == 0) xs[m] = s;
  // a group is group / PER consecutive chunks, so consecutive lanes
  const int span = group / PER;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = tid + Q_THREADS * i;
    int sum = 0;
    if (c < chunks) {
      const T* e = reinterpret_cast<const T*>(&v[i]);
      uint32_t w[2] = {0, 0};
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int q = quant8(to_float(e[j]), s);
        sum += q;
        w[j / 4] |= (uint32_t)(q & 0xFF) << (8 * (j % 4));
      }
      int8_t* dst = xq + (size_t)m * K + (size_t)c * PER;
      if (PER == 8)
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
      else
        *reinterpret_cast<uint32_t*>(dst) = w[0];
    }
    if (Q_THREADS * i < chunks) {               // uniform across the block
      for (int o = 1; o < span; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (c < chunks && (lane & (span - 1)) == 0)
        tok[(size_t)m * (K / group) + c / span] = sum;
    }
  }
}

// One block: BM tokens x 64 columns x the L rows of K block blockIdx.z; T
// is the output's dtype (x's). xq (M, K), tok (M, K/group) and xs (M) come
// from quantize_rows_kernel.
template <typename T, int BM>
__global__ void __launch_bounds__(TC_THREADS)
w4a8_gemm_kernel(const int8_t* __restrict__ xq, const int* __restrict__ tok,
                 const float* __restrict__ xs,
                 const int8_t* __restrict__ packed,
                 const float* __restrict__ scales,
                 const float* __restrict__ zeros, T* __restrict__ out,
                 float* __restrict__ partials, Params p) {
  constexpr int NT = BM / 8;
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kz = blockIdx.z;
  const int M = p.tc.M, N = p.tc.N, K = p.tc.K, L = p.tc.L;
  const int kb = kz * L;
  const int units = (L + W4A8_BK - 1) / W4A8_BK;
  const int mine = units > warp ? (units - warp + WARPS - 1) / WARPS : 0;
  const int G = K >> p.gshift;                  // groups along K
  float* row_scale = reinterpret_cast<float*>(smem + p.rows_off);
  uint8_t* ring = smem + warp * W4A8_STAGES * p.stage_bytes;

  // this lane's share of a unit's weight copies, set up once
  const int wch = lane & 3;
  const bool wcol = n0 + 16 * wch < N;
  const int8_t* wsrc = packed + (size_t)(lane >> 2) * N + n0 + 16 * wch;
  const int wdst = w_off(lane >> 2, 16 * wch);

  // a unit of this warp (its (i % STAGES)-th stage): the weight part
  // (packed rows, group scale and zero-point rows) and the x part (x_q and
  // Σx_q), which is ready only once the quantize kernel has finished
  auto issue_w = [&](int i) {
    if (i >= mine) return;
    const int u = warp + WARPS * i;
    const int k0 = kb + W4A8_BK * u;
    const int rows = min(W4A8_BK, L - W4A8_BK * u);
    uint8_t* st = ring + (i % W4A8_STAGES) * p.stage_bytes;
    const int8_t* src = wsrc + (size_t)(k0 / 2) * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {               // packed rows lane/4 + 8j
      const bool ok = wcol && 2 * ((lane >> 2) + 8 * j) < rows;
      cp_async16(st + wdst + 8 * j * BN, ok ? src + (size_t)8 * j * N
                                             : packed, ok);
    }
    const int g0 = k0 >> p.gshift;
    const int per = p.sr * (BN / 4);
    for (int c = lane; c < (p.zeros ? 2 : 1) * per; c += 32) {
      const int which = c >= per;
      const int i2 = (c - which * per) >> 4, ch = c & 15;
      const bool ok = (i2 << p.gshift) < rows && n0 + 4 * ch < N;
      const float* base = which ? zeros : scales;
      cp_async16(st + (which ? p.off_z : W4A8_BK / 2 * BN)
                     + (i2 * BN + 4 * ch) * 4,
                 ok ? base + (size_t)(g0 + i2) * N + n0 + 4 * ch : base, ok);
    }
  };
  auto issue_x = [&](int i) {
    if (i < mine) {
      const int u = warp + WARPS * i;
      const int k0 = kb + W4A8_BK * u;
      const int rows = min(W4A8_BK, L - W4A8_BK * u);
      uint8_t* st = ring + (i % W4A8_STAGES) * p.stage_bytes;
      const int g0 = k0 >> p.gshift;
      for (int c = lane; c < BM * (W4A8_BK / 16); c += 32) {
        const int r = c >> 3, kc = 16 * (c & 7);
        const bool ok = m0 + r < M && kc < rows;
        cp_async16(st + p.off_xq + r * XQ_LD + kc,
                   ok ? xq + (size_t)(m0 + r) * K + k0 + kc : xq, ok);
      }
      for (int c = lane; c < BM * p.sr; c += 32) {
        const int r = c / p.sr, i2 = c % p.sr;
        const bool ok = m0 + r < M && (i2 << p.gshift) < rows;
        cp_async4(st + p.off_tok + c * 4,
                  ok ? tok + (size_t)(m0 + r) * G + g0 + i2 : tok, ok);
      }
    }
    cp_async_commit();
  };
  // the first units' weights go in flight before the quantize kernel has
  // finished; x_q, Σx_q and the row scales are read only after it
#pragma unroll
  for (int i = 0; i < W4A8_STAGES; ++i) issue_w(i);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < W4A8_STAGES; ++i) issue_x(i);
  if (tid < BM) row_scale[tid] = m0 + tid < M ? xs[m0 + tid] : 0.0f;

  float facc[4][NT][4];
  int iacc[4][NT][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        facc[a][nt][i] = 0.0f;
        iacc[a][nt][i] = 0;
      }
  // the lane's A rows: packed rows 2t and 2t + 1 of a k step, bytes 8g ..
  const int a_lo = w_off(2 * t, 8 * g), a_hi = w_off(2 * t + 1, 8 * g);
  // its ldmatrix rows: lanes 0-7 tokens at k 0, lanes 8-15 at k 16
  const int b_off = (lane & 7) * XQ_LD + ((lane >> 3) & 1) * 16;

  for (int i = 0; i < mine; ++i) {
    sm90::cp_async_wait<W4A8_STAGES - 1>();
    __syncwarp();
    const uint8_t* st = ring + (i % W4A8_STAGES) * p.stage_bytes;
    const int rows = min(W4A8_BK, L - W4A8_BK * (warp + WARPS * i));
    const uint8_t* sxq = st + p.off_xq;
    const int* stok = reinterpret_cast<const int*>(st + p.off_tok);
    const float* ssc = reinterpret_cast<const float*>(st + W4A8_BK / 2 * BN);
    const float* szr = reinterpret_cast<const float*>(st + p.off_z);
#pragma unroll
    for (int j = 0; j < W4A8_BK / 32; ++j) {
      if (32 * j >= rows) break;
      // A: packed rows 16j + 2t, + 1 (k 4t ..) and 16j + 8 + 2t, + 1
      // (k 16 + 4t ..), the lane's eight columns
      const uint2 w0 = *reinterpret_cast<const uint2*>(st + 16 * j * BN + a_lo);
      const uint2 w1 = *reinterpret_cast<const uint2*>(st + 16 * j * BN + a_hi);
      const uint2 w2 =
          *reinterpret_cast<const uint2*>(st + (16 * j + 8) * BN + a_lo);
      const uint2 w3 =
          *reinterpret_cast<const uint2*>(st + (16 * j + 8) * BN + a_hi);
      uint32_t klo[8], khi[8];                  // column c's registers
      unpack4(w0.x, w1.x, klo);
      unpack4(w0.y, w1.y, klo + 4);
      unpack4(w2.x, w3.x, khi);
      unpack4(w2.y, w3.y, khi + 4);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[2];
        ldsm_x2(b, sxq + b_off + 8 * nt * XQ_LD + 32 * j);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          // column 8g + 2a is A row g, 8g + 2a + 1 row g + 8 (int_col)
          const uint32_t af[4] = {klo[2 * a], klo[2 * a + 1], khi[2 * a],
                                  khi[2 * a + 1]};
          mma16832_s8(iacc[a][nt], af, b[0], b[1]);
        }
      }
      if (((j + 1) << 5) % (1 << p.gshift) == 0) {   // the step ends a group
        const int gi = (32 * j) >> p.gshift;
        float sc[8], zr[8] = {};
        gemm_tile::load8(sc, ssc + gi * BN + 8 * g);
        if (p.zeros) gemm_tile::load8(zr, szr + gi * BN + 8 * g);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float tk[2] = {
              static_cast<float>(stok[(8 * nt + 2 * t) * p.sr + gi]),
              static_cast<float>(stok[(8 * nt + 2 * t + 1) * p.sr + gi])};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = 2 * a + (e >> 1);   // the lane's column 8g + c
              float v = static_cast<float>(iacc[a][nt][e]);
              if (p.zeros) v = __fsub_rn(v, __fmul_rn(zr[c], tk[e & 1]));
              facc[a][nt][e] = __fadd_rn(facc[a][nt][e], __fmul_rn(v, sc[c]));
              iacc[a][nt][e] = 0;
            }
        }
      }
    }
    __syncwarp();                 // every lane is done with the stage
    issue_w(i + W4A8_STAGES);
    issue_x(i + W4A8_STAGES);
  }
  sm90::cp_async_wait<0>();
  __syncthreads();                // the rings are free: reuse them
  gemm_tile::finish_tile<T, BM, IntCols>(facc, smem, p.tc, n0, m0, kz, out,
                                         partials,
                                         p.tc.direct ? row_scale : nullptr);
}

template <typename T, int BM>
cudaError_t launch(const void* xq, const void* tok, const void* xs,
                   const void* packed, const void* scales, const void* zeros,
                   void* out, const gemm_tile::Geometry& g, int M, int N,
                   int K, int group, int direct, int overlap,
                   cudaStream_t stream) {
  auto kernel = w4a8_gemm_kernel<T, BM>;
  static int allowed = 48 * 1024;       // dynamic shared memory set so far
  if (g.smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (err != cudaSuccess) return err;
    allowed = g.smem;
  }
  Params p;
  p.tc = gemm_tile::TcParams{M, N, K, K / g.ks, g.sub, g.cluster, direct,
                             g.sr, g.stage_bytes, 0, gemm_tile::ONE_GEMM,
                             g.gy, (long long)M * N};
  p.gshift = group == 32 ? 5 : group == 64 ? 6 : 7;
  p.sr = g.sr;
  p.stage_bytes = g.stage_bytes;
  p.zeros = zeros != nullptr;
  const int wb = align128(W4A8_BK / 2 * BN), sb = align128(g.sr * BN * 4);
  p.off_z = wb + sb;
  p.off_xq = wb + sb * (p.zeros ? 2 : 1);
  p.off_tok = p.off_xq + align128(BM * XQ_LD);
  const int ring = WARPS * g.stages * g.stage_bytes;
  const int red = WARPS * BM * gemm_tile::RED_LD * 4;
  p.rows_off = ring > red ? ring : red;
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (g.cluster > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = 1;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = g.cluster;
    ++n;
  }
  if (overlap) {                        // a programmatic dependent launch
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.gx, g.gy, g.gz);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = n;
  T* o = direct ? static_cast<T*>(out) : nullptr;
  float* parts = direct ? nullptr : static_cast<float*>(out);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int8_t*>(xq),
      static_cast<const int*>(tok), static_cast<const float*>(xs),
      static_cast<const int8_t*>(packed), static_cast<const float*>(scales),
      static_cast<const float*>(zeros), o, parts, p);
  const cudaError_t last = cudaGetLastError();   // read and cleared
  return err != cudaSuccess ? err : last;
}

template <typename T>
cudaError_t dispatch(const void* xq, const void* tok, const void* xs,
                     const void* packed, const void* scales,
                     const void* zeros, void* out,
                     const gemm_tile::Geometry& g, int M, int N, int K,
                     int group, int direct, int overlap,
                     cudaStream_t stream) {
  switch (g.bm) {
    case 8:
      return launch<T, 8>(xq, tok, xs, packed, scales, zeros, out, g, M, N,
                          K, group, direct, overlap, stream);
    case 16:
      return launch<T, 16>(xq, tok, xs, packed, scales, zeros, out, g, M, N,
                           K, group, direct, overlap, stream);
    case 32:
      return launch<T, 32>(xq, tok, xs, packed, scales, zeros, out, g, M, N,
                           K, group, direct, overlap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int CPT>
int quantize_cpt(const void* x, void* xq, void* xs, void* tok, int M, int K,
                 int group, cudaStream_t stream) {
  quantize_rows_kernel<T, CPT><<<M, Q_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(xs), static_cast<int*>(tok), K, group);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int quantize(const void* x, void* xq, void* xs, void* tok, int M, int K,
             int group, int cpt, cudaStream_t stream) {
  if (cpt <= 1) return quantize_cpt<T, 1>(x, xq, xs, tok, M, K, group, stream);
  if (cpt <= 2) return quantize_cpt<T, 2>(x, xq, xs, tok, M, K, group, stream);
  if (cpt <= 4) return quantize_cpt<T, 4>(x, xq, xs, tok, M, K, group, stream);
  if (cpt <= 8) return quantize_cpt<T, 8>(x, xq, xs, tok, M, K, group, stream);
  return quantize_cpt<T, Q_MAX_CPT>(x, xq, xs, tok, M, K, group, stream);
}

}  // namespace

// x (M, K) in dtype 0 (bf16), 1 (fp16) or 2 (fp32) -> xq (M, K) int8, xs
// (M) fp32, tok (M, K/group) int32; group 32, 64 or 128 dividing K, a row of
// at most 64 KB, 16-byte aligned x.
extern "C" int w4a8_quantize(const void* x, void* xq, void* xs, void* tok,
                             int M, int K, int group, int dtype,
                             void* stream) {
  const int elem = dtype == 2 ? 4 : 2;
  const int cpt = (K * elem / 16 + Q_THREADS - 1) / Q_THREADS;
  if (M < 1 || (group != 32 && group != 64 && group != 128) || K % group ||
      dtype < 0 || dtype > 2 || cpt > Q_MAX_CPT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return quantize<__nv_bfloat16>(x, xq, xs, tok, M, K, group, cpt, s);
  if (dtype == 1)
    return quantize<__half>(x, xq, xs, tok, M, K, group, cpt, s);
  return quantize<float>(x, xq, xs, tok, M, K, group, cpt, s);
}

// xq, xs, tok from w4a8_quantize; packed (K/2, N) int8; scales and
// optional zeros (K/group, N) fp32. direct=1 writes out (M, N) in dtype 0,
// 1 or 2, split_k ≤ 8; direct=0 writes fp32 partials (split_k, M, N)
// without the row scale. overlap=1 launches the GEMM as the programmatic
// dependent of the quantize kernel just before it on the stream. bm ..
// smem: the wrapper's gemm_geometry, which must equal make_geometry's. The
// caller guarantees group 32, 64 or 128 dividing K / split_k, N % 16 == 0
// and 16-byte aligned pointers.
extern "C" int w4a8_gemm(const void* xq, const void* tok, const void* xs,
                         const void* packed, const void* scales,
                         const void* zeros, void* out, int M, int N, int K,
                         int group, int split_k, int dtype, int direct,
                         int overlap, int bm, int bk, int stages, int ks,
                         int cluster, int smem, void* stream) {
  gemm_tile::Geometry g;
  if (dtype < 0 || dtype > 2 ||
      !gemm_tile::make_geometry(g, gemm_tile::W4A8, M, N, K, split_k,
                                dtype == 2 ? 4 : 2, direct, group,
                                zeros != nullptr, gemm_tile::sm_count()))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g.bm != bm || g.bk != bk || g.stages != stages || g.ks != ks ||
      g.cluster != cluster || g.smem != smem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<__nv_bfloat16>(xq, tok, xs, packed, scales, zeros, out,
                                  g, M, N, K, group, direct, overlap, s);
  else if (dtype == 1)
    err = dispatch<__half>(xq, tok, xs, packed, scales, zeros, out, g, M, N,
                           K, group, direct, overlap, s);
  else
    err = dispatch<float>(xq, tok, xs, packed, scales, zeros, out, g, M, N,
                          K, group, direct, overlap, s);
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
