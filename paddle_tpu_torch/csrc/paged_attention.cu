// Paged attention over a block-paged KV pool, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of paddle_tpu/ops/pallas/paged_attention.py:
//   paged_decode_kernel      <- _kernel    (paged_decode_attention_pallas, pallas_call :157)
//   paged_multiquery_kernel  <- _mq_kernel (paged_multiquery_attention_pallas, pallas_call :278)
//   paged_multiquery_tc_kernel, the tensor-core body of the second
//
// What they compute (the first two share one device body, `attend`):
//   out[b, t, h, :] = softmax_j( (q[b,t,h]*scale) . K[j] ) V[j]
// over the request's tokens j taken page by page from its block-table row,
// visible when  j <= q_start[b] + t  and  j < context_lens[b]  (decode: one
// query row, q_start = ctx - 1). GQA maps query head h to kv head
// h / (H / Hkv), jnp.repeat's mapping. int8 pools are dequantized as
// codes * per-row scale while they are staged. Rows that see no token give 0.
//
// Design of `attend`. One thread block per (request, kv head[, tile of
// query rows]): the block handles every query head of its kv head, so each K/V row is read from
// device memory once per block. Query rows (scaled in fp32 as _kernel does) and
// the fp32 accumulators live in shared memory; a loop over tiles of kTile
// tokens stands in for the TPU's sequential page grid axis. Each tile: the
// block resolves its tokens' pool rows from the block table, stages K and V
// in shared memory as fp32 (dequantizing int8), computes the scores, folds
// them into the online softmax (m, l, acc in fp32) and accumulates P.V.
// A block only visits tokens below min(ctx, q_start + last_row + 1).
//
// Bound on an H100: memory bytes for decode (every visited K/V row is read
// once: 2 * ctx * Hkv * D * sizeof(kv) per request against 4 * ctx * H * D
// flops); for a long prefill chunk the flop count per byte grows with the
// number of query rows, and the multi-query kernel is bound by operations
// (9.67 GFLOP, 0.0098 ms at 989 TFLOP/s, for llama_1b's longest prefill
// chunk: T 2048, 1536 real rows, H 16, D 128). `attend` uses fp32 CUDA-core
// math: the K/V stream is the part it keeps to one pass.
//
// Tensor-core body (paged_multiquery_tc_kernel), taken by the multi-query
// entry for bf16 q over bf16 or int8 pools with T > 1 and head_dim 32, 64
// or 128; the wrapper chooses it from those alone, and everything else
// (T = 1, fp32 q, fp32 pools, other head dims) keeps `attend`, so the
// decode kernel and "T = 1 equals decode" are untouched. FlashAttention-2's
// shape: one block of 4 warps per (request, kv head, tile of 64 query rows
// r = t G + g), 16 rows a warp, q unscaled in bf16 fragments. K/V tiles of
// 64 tokens are gathered through the block table by cp.async into a
// two-stage ring (zero-filled past the visible end); int8 codes are
// converted to bf16 after they land (exact), with k_scale multiplying the
// score columns and v_scale folded into the P columns in fp32. S = q K^T
// (mma.sync, bf16 in, fp32 out) and the online softmax stay in registers
// (quad shuffles); the scale multiplies the fp32 scores, which differs from
// the reference's q * scale only by fp32 rounding. P is split into bf16
// hi + lo (a plain bf16 P errs by up to 2^-9 a term) and fed to P V as A
// fragments straight from the score registers. A tile stops at
// min(ctx, start + its last row + 1); a tile made only of padding rows
// (first row at or past ctx - start) writes zeros and reads no K/V.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;           // tokens staged per iteration (one per lane)
constexpr float kNegInf = -1e30f;   // the Pallas kernels' NEG_INF

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

struct Params {
  const void* q;          // [B, T, H, D]  (decode: T = 1)
  const void* k_pool;     // [N, block_size, Hkv, D]
  const void* v_pool;
  const float* k_scale;   // [N, block_size, Hkv] or null
  const float* v_scale;
  const int32_t* tables;  // [B, P]
  const int32_t* lens;    // [B]
  const int32_t* starts;  // [B] or null (decode: start = ctx - 1)
  void* out;              // [B, T, H, D], q's dtype
  int T, H, Hkv, D, block_size, P, tq;
  float scale;
};

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(c[i]);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Shared memory: R query rows, row stride D + 1 where rows are read across
// lanes at the same column (keeps those reads on distinct banks).
__host__ __device__ inline size_t smem_floats(int R, int D) {
  const size_t ld = static_cast<size_t>(D) + 1;
  size_t n = R * ld              // q (scaled, fp32)
           + size_t(R) * D       // acc
           + kTile * ld          // K tile
           + size_t(kTile) * D   // V tile
           + size_t(R) * kTile   // scores / probabilities
           + 3 * size_t(R);      // m, l, correction
  return (n + 1) & ~size_t(1);   // 8-byte align the row-index array after it
}

__host__ __device__ inline size_t smem_bytes(int R, int D) {
  return smem_floats(R, D) * sizeof(float) + kTile * sizeof(long long);
}

template <typename QT, typename KVT>
__device__ __forceinline__ void attend(const Params& pr, int b, int hk,
                                       int q_tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = pr.D, LD = D + 1, D8 = D / 8;
  const int G = pr.H / pr.Hkv, tq = pr.tq, R = tq * G;
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* acc = qs + R * LD;
  float* ks = acc + R * D;
  float* vs = ks + kTile * LD;
  float* ps = vs + kTile * D;
  float* ms = ps + R * kTile;
  float* ls = ms + R;
  float* cs = ls + R;
  long long* rows = reinterpret_cast<long long*>(qs + smem_floats(R, D));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ctx = pr.lens[b];
  const int start = pr.starts != nullptr ? pr.starts[b] : ctx - 1;
  const int t0 = q_tile * tq;                   // first query row of the block
  const int t_last = min(pr.T, t0 + tq) - 1;    // last real query row
  const int kv_end = min(min(ctx, start + t_last + 1), pr.P * pr.block_size);

  // stage q rows (r = t_local * G + g), scaled in fp32; zero the state
  const QT* q = static_cast<const QT*>(pr.q);
  for (int i = tid; i < R * D8; i += kThreads) {
    const int r = i / D8, c = (i % D8) * 8;
    const int t = t0 + r / G, g = r % G;
    float x[8];
    if (t < pr.T) {
      load8(q + ((static_cast<size_t>(b) * pr.T + t) * pr.H + hk * G + g) * D
                  + c, x);
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] *= pr.scale;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) qs[r * LD + c + j] = x[j];
  }
  for (int i = tid; i < R * D; i += kThreads) acc[i] = 0.f;
  for (int r = tid; r < R; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }

  // lanes per score dot product: a power of two, fewer when rows are many
  const int n_dots = R * kTile;
  int tpd = 32;
  while (tpd > 1 && kThreads / tpd < n_dots) tpd >>= 1;
  const int groups = kThreads / tpd, gid = tid / tpd, gl = tid % tpd;

  const KVT* kp = static_cast<const KVT*>(pr.k_pool);
  const KVT* vp = static_cast<const KVT*>(pr.v_pool);
  const int32_t* table = pr.tables + static_cast<size_t>(b) * pr.P;

  for (int tile0 = 0; tile0 < kv_end; tile0 += kTile) {
    const int n = min(kTile, kv_end - tile0);
    __syncthreads();  // previous tile's readers are done with rows/ks/vs
    if (tid < n) {
      const int tok = tile0 + tid;
      const long long blk = table[tok / pr.block_size];
      rows[tid] = (blk * pr.block_size + tok % pr.block_size) * pr.Hkv + hk;
    }
    __syncthreads();
    for (int i = tid; i < n * D8; i += kThreads) {
      const int t = i / D8, c = (i % D8) * 8;
      const long long row = rows[t];
      float kx[8], vx[8];
      load8(kp + row * D + c, kx);
      load8(vp + row * D + c, vx);
      if (pr.k_scale != nullptr) {
        const float sk = pr.k_scale[row], sv = pr.v_scale[row];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          kx[j] *= sk;
          vx[j] *= sv;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ks[t * LD + c + j] = kx[j];
        vs[t * D + c + j] = vx[j];
      }
    }
    __syncthreads();

    // scores s[r][t] = q_r . k_t (every lane of a group takes part in the
    // shuffles, so the trip count is uniform across the block)
    for (int base = 0; base < n_dots; base += groups) {
      const int i = base + gid, r = i / kTile, t = i % kTile;
      float s = 0.f;
      if (i < n_dots && t < n) {
        const float* qr = qs + r * LD;
        const float* kr = ks + t * LD;
        for (int d = gl; d < D; d += tpd) s += qr[d] * kr[d];
      }
      for (int off = tpd >> 1; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off, tpd);
      if (i < n_dots && gl == 0) ps[i] = s;
    }
    __syncthreads();

    // online softmax: one warp per row, one lane per token of the tile
    for (int r = warp; r < R; r += kWarps) {
      const int tok = tile0 + lane;
      const bool ok = lane < n && tok <= start + t0 + r / G && tok < ctx;
      const float s = ok ? ps[r * kTile + lane] : kNegInf;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = ok ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[r * kTile + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        cs[r] = corr;
        ls[r] = ls[r] * corr + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
    for (int i = tid; i < R * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const float* pr_row = ps + r * kTile;
      float a = acc[i] * cs[r];
      for (int t = 0; t < n; ++t) a += pr_row[t] * vs[t * D + d];
      acc[i] = a;
    }
  }
  __syncthreads();

  QT* out = static_cast<QT*>(pr.out);
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = t0 + r / G, g = r % G;
    if (t < pr.T)
      store1(out + ((static_cast<size_t>(b) * pr.T + t) * pr.H + hk * G + g)
                       * D + d,
             acc[i] / fmaxf(ls[r], 1e-30f));
  }
}

template <typename QT, typename KVT>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Params p) {
  attend<QT, KVT>(p, blockIdx.x, blockIdx.y, 0);
}

template <typename QT, typename KVT>
__global__ void __launch_bounds__(kThreads) paged_multiquery_kernel(Params p) {
  attend<QT, KVT>(p, blockIdx.x, blockIdx.y, blockIdx.z);
}

template <typename QT, typename KVT>
cudaError_t launch(bool multi, const Params& p, int B, cudaStream_t stream) {
  const int R = p.tq * (p.H / p.Hkv);
  const size_t smem = smem_bytes(R, p.D);
  void (*kern)(Params) = multi ? paged_multiquery_kernel<QT, KVT>
                               : paged_decode_kernel<QT, KVT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int q_tiles = (p.T + p.tq - 1) / p.tq;
  kern<<<dim3(B, p.Hkv, q_tiles), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t dispatch_kv(bool multi, int kv_dtype, const Params& p, int B,
                        cudaStream_t s) {
  switch (kv_dtype) {
    case kF32: return launch<QT, float>(multi, p, B, s);
    case kBF16: return launch<QT, __nv_bfloat16>(multi, p, B, s);
    case kI8: return launch<QT, int8_t>(multi, p, B, s);
  }
  return cudaErrorInvalidValue;
}

// -- tensor-core body of the multi-query kernel ------------------------------

namespace tcr {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kRows = 64;      // query rows r = t * G + g of one block
constexpr int kTok = 64;       // tokens of one K/V tile (4 pages of 16)

template <typename T> struct IsI8 { static constexpr bool value = false; };
template <> struct IsI8<int8_t> { static constexpr bool value = true; };

// shared memory: q [kRows][D + 8] bf16; K and V [2 stages][kTok][D + 8]
// bf16 (for int8 pools stage 0 holds the converted tile); int8 pools add
// raw K and V rings [2][kTok][D + 16] and the tile's k and v scales
template <typename KVT, int D>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(kRows) + 4 * kTok) * (D + 8) * sizeof(bf16)
         + (IsI8<KVT>::value ? 4 * kTok * (D + 16) + 2 * kTok * sizeof(float)
                             : 0);
}

template <typename KVT, int D>
__global__ void __launch_bounds__(kThreads)
    paged_multiquery_tc_kernel(Params pr) {
  constexpr bool kI8 = IsI8<KVT>::value;
  constexpr int LD = D + 8, RLD = D + 16, KS = D / 16, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kb = qs + kRows * LD;
  bf16* vb = kb + 2 * kTok * LD;
  int8_t* kraw = reinterpret_cast<int8_t*>(vb + 2 * kTok * LD);
  int8_t* vraw = kraw + 2 * kTok * RLD;
  float* ksc = reinterpret_cast<float*>(vraw + 2 * kTok * RLD);
  float* vsc = ksc + kTok;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, quad = lane & 3;
  const int b = blockIdx.x, hk = blockIdx.y;
  const int G = pr.H / pr.Hkv, T = pr.T, H = pr.H, bs = pr.block_size;
  const int r0 = blockIdx.z * kRows;
  const int ctx = pr.lens[b], start = pr.starts[b];
  const int t_first = r0 / G, t_last = min(T - 1, (r0 + kRows - 1) / G);
  const bf16* q = static_cast<const bf16*>(pr.q);
  bf16* out = static_cast<bf16*>(pr.out);
  auto row_at = [&](int rg) {  // flattened row -> its [D] slice of q / out
    return ((static_cast<size_t>(b) * T + rg / G) * H + hk * G + rg % G) * D;
  };

  if (start + t_first >= ctx) {
    // every row of the tile is padding (callers ignore it): zeros, no K/V
    for (int i = tid; i < kRows * (D / 8); i += kThreads) {
      const int rg = r0 + i / (D / 8);
      if (rg / G < T)
        *reinterpret_cast<uint4*>(out + row_at(rg) + (i % (D / 8)) * 8) =
            uint4{0u, 0u, 0u, 0u};
    }
    return;
  }
  const int kv_end = min(min(ctx, start + t_last + 1), pr.P * bs);
  const int n_tiles = (kv_end + kTok - 1) / kTok;
  const KVT* kp = static_cast<const KVT*>(pr.k_pool);
  const KVT* vp = static_cast<const KVT*>(pr.v_pool);
  const int32_t* table = pr.tables + static_cast<size_t>(b) * pr.P;
  auto pool_row = [&](int tok) {
    const long long blk = table[tok / bs];
    return (blk * bs + tok % bs) * pr.Hkv + hk;
  };

  for (int i = tid; i < kRows * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8, rg = r0 + r;
    const bool ok = rg / G < T;
    tc::cp_async16(qs + r * LD + c, ok ? q + row_at(rg) + c : q, ok);
  }
  // K/V tile j through the block table into stage s (zeros past kv_end)
  auto issue = [&](int j, int s) {
    constexpr int VPR = D * static_cast<int>(sizeof(KVT)) / 16;
    for (int i = tid; i < kTok * VPR; i += kThreads) {
      const int t = i / VPR, c = i % VPR, tok = j * kTok + t;
      const bool ok = tok < kv_end;
      const long long at = ok ? pool_row(tok) * D + c * (16 / sizeof(KVT))
                              : 0;
      void* kd = kI8 ? static_cast<void*>(kraw + (s * kTok + t) * RLD
                                          + c * 16)
                     : static_cast<void*>(kb + (s * kTok + t) * LD + c * 8);
      void* vd = kI8 ? static_cast<void*>(vraw + (s * kTok + t) * RLD
                                          + c * 16)
                     : static_cast<void*>(vb + (s * kTok + t) * LD + c * 8);
      tc::cp_async16(kd, kp + at, ok);
      tc::cp_async16(vd, vp + at, ok);
    }
  };
  if (n_tiles > 0) issue(0, 0);
  tc::cp_async_commit();

  // this thread's two rows (group and group + 8 of its warp's 16)
  int tr[2];
  bool live[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int rg = r0 + warp * 16 + grp + 8 * hf;
    tr[hf] = rg / G;
    live[hf] = tr[hf] < T;
  }
  uint32_t qf[KS][4];
  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    tc::cp_async_wait<0>();
    __syncthreads();  // tile j landed; every reader of tile j - 1 is done
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        tc::ldsm_x4(qf[ks], qs + (warp * 16 + (lane & 15)) * LD + ks * 16
                                + (lane >> 4) * 8);
    }
    if (j + 1 < n_tiles) issue(j + 1, (j + 1) & 1);
    tc::cp_async_commit();
    const int tile0 = j * kTok;
    const bf16* kt = kb + (kI8 ? 0 : (j & 1) * kTok * LD);
    const bf16* vt = vb + (kI8 ? 0 : (j & 1) * kTok * LD);
    if (kI8) {
      // codes -> bf16 (exact: |code| <= 127), and the tile's scales
      const int s = j & 1;
      for (int i = tid; i < 2 * kTok * (D / 16); i += kThreads) {
        const int kv = i / (kTok * (D / 16)), w = i % (kTok * (D / 16));
        const int t = w / (D / 16), c = (w % (D / 16)) * 16;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            (kv ? vraw : kraw) + (s * kTok + t) * RLD + c);
        const int8_t* cc = reinterpret_cast<const int8_t*>(&raw);
        uint32_t wd[8];
#pragma unroll
        for (int p = 0; p < 8; ++p)
          wd[p] = tc::pack_bf16x2(static_cast<float>(cc[2 * p]),
                                  static_cast<float>(cc[2 * p + 1]));
        bf16* dst = (kv ? vb : kb) + t * LD + c;
        *reinterpret_cast<uint4*>(dst) = uint4{wd[0], wd[1], wd[2], wd[3]};
        *reinterpret_cast<uint4*>(dst + 8) =
            uint4{wd[4], wd[5], wd[6], wd[7]};
      }
      for (int t = tid; t < kTok; t += kThreads) {
        const int tok = tile0 + t;
        const bool ok = tok < kv_end;
        const long long row = ok ? pool_row(tok) : 0;
        ksc[t] = ok ? pr.k_scale[row] : 0.f;
        vsc[t] = ok ? pr.v_scale[row] : 0.f;
      }
      __syncthreads();
    }

    // S = q K^T on the tensor cores: [16 rows x 64 tokens] a warp
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        tc::ldsm_x4(bb, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD
                            + ks * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(sc[2 * np], qf[ks], bb);
        tc::mma_bf16(sc[2 * np + 1], qf[ks], bb + 2);
      }

    // scale (and k_scale), causal and context mask, online softmax
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1, col = nt * 8 + 2 * quad + (e & 1);
        const int tok = tile0 + col;
        const bool ok = live[hf] && tok < kv_end && tok <= start + tr[hf];
        const float v = sc[nt][e] * pr.scale * (kI8 ? ksc[col] : 1.f);
        sc[nt][e] = ok ? v : kNegInf;
        mx[hf] = fmaxf(mx[hf], sc[nt][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m[hf], mx[hf]);
      corr[hf] = expf(m[hf] - m_new);
      m[hf] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1, col = nt * 8 + 2 * quad + (e & 1);
        const float p = sc[nt][e] > 0.5f * kNegInf
                            ? expf(sc[nt][e] - m[hf]) : 0.f;
        sum[hf] += p;
        sc[nt][e] = kI8 ? p * vsc[col] : p;  // v_scale folded into P
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 1);
      sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 2);
      l[hf] = l[hf] * corr[hf] + sum[hf];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o[nt][0] *= corr[0];
      o[nt][1] *= corr[0];
      o[nt][2] *= corr[1];
      o[nt][3] *= corr[1];
    }

    // O += P V: P split into bf16 hi + lo, fed from registers as A
    // fragments (the C -> A identity); V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[4], al[4];
      tc::split_bf16x2(sc[2 * kk][0], sc[2 * kk][1], ah[0], al[0]);
      tc::split_bf16x2(sc[2 * kk][2], sc[2 * kk][3], ah[1], al[1]);
      tc::split_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ah[2], al[2]);
      tc::split_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bb[4];
        tc::ldsm_x4_trans(bb, vt + (kk * 16 + (lane & 7)
                                    + ((lane >> 3) & 1) * 8) * LD
                                  + dp * 16 + (lane >> 4) * 8);
        tc::mma_bf16(o[2 * dp], ah, bb);
        tc::mma_bf16(o[2 * dp], al, bb);
        tc::mma_bf16(o[2 * dp + 1], ah, bb + 2);
        tc::mma_bf16(o[2 * dp + 1], al, bb + 2);
      }
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (!live[hf]) continue;
    const float inv_l = 1.f / fmaxf(l[hf], 1e-30f);
    bf16* orow = out + row_at(r0 + warp * 16 + grp + 8 * hf);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<uint32_t*>(orow + nt * 8 + 2 * quad) =
          tc::pack_bf16x2(o[nt][2 * hf] * inv_l, o[nt][2 * hf + 1] * inv_l);
  }
}

template <typename KVT, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<KVT, D>();
  void (*kern)(Params) = paged_multiquery_tc_kernel<KVT, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int tiles = (p.T * (p.H / p.Hkv) + kRows - 1) / kRows;
  kern<<<dim3(B, p.Hkv, tiles), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename KVT>
cudaError_t dispatch_d(const Params& p, int B, cudaStream_t s) {
  switch (p.D) {
    case 32: return launch<KVT, 32>(p, B, s);
    case 64: return launch<KVT, 64>(p, B, s);
    case 128: return launch<KVT, 128>(p, B, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace tcr

// multi: the multi-query entry; tensor_core: its tensor-core body (bf16 q,
// bf16 or int8 pools, head_dim 32, 64 or 128), else the `attend` body
int run(bool multi, bool tensor_core, int q_dtype, int kv_dtype,
        const Params& p, int B, void* stream) {
  if (B == 0 || p.T == 0) return cudaSuccess;
  if (p.D % 8 != 0 || p.H % p.Hkv != 0) return cudaErrorInvalidValue;
  if ((kv_dtype == kI8) != (p.k_scale != nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_core) {
    if (!multi || q_dtype != kBF16) return cudaErrorInvalidValue;
    switch (kv_dtype) {
      case kBF16: return tcr::dispatch_d<__nv_bfloat16>(p, B, s);
      case kI8: return tcr::dispatch_d<int8_t>(p, B, s);
    }
    return cudaErrorInvalidValue;
  }
  switch (q_dtype) {
    case kF32: return dispatch_kv<float>(multi, kv_dtype, p, B, s);
    case kBF16: return dispatch_kv<__nv_bfloat16>(multi, kv_dtype, p, B, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory of the multi-query tensor-core body (0 if it does
// not take head_dim D or kv dtype kv_dtype).
long paged_multiquery_tc_smem_bytes(int D, int kv_dtype) {
  const bool i8 = kv_dtype == kI8;
  if (kv_dtype != kBF16 && !i8) return 0;
  switch (D) {
    case 32: return static_cast<long>(
        i8 ? tcr::smem_bytes<int8_t, 32>()
           : tcr::smem_bytes<__nv_bfloat16, 32>());
    case 64: return static_cast<long>(
        i8 ? tcr::smem_bytes<int8_t, 64>()
           : tcr::smem_bytes<__nv_bfloat16, 64>());
    case 128: return static_cast<long>(
        i8 ? tcr::smem_bytes<int8_t, 128>()
           : tcr::smem_bytes<__nv_bfloat16, 128>());
  }
  return 0;
}

// q [B, H, D]; returns cudaGetLastError() after the launch (0 = success).
int paged_decode_attention_launch(const void* q, const void* k_pool,
                                  const void* v_pool, const void* k_scale,
                                  const void* v_scale, const void* tables,
                                  const void* lens, void* out, int B, int H,
                                  int Hkv, int D, int block_size, int P,
                                  int q_dtype, int kv_dtype, float scale,
                                  void* stream) {
  Params p{q, k_pool, v_pool,
           static_cast<const float*>(k_scale),
           static_cast<const float*>(v_scale),
           static_cast<const int32_t*>(tables),
           static_cast<const int32_t*>(lens), nullptr, out,
           1, H, Hkv, D, block_size, P, 1, scale};
  return run(false, false, q_dtype, kv_dtype, p, B, stream);
}

// q [B, T, H, D] at positions q_start[b] + t; tensor_core 1 takes the
// tensor-core body (64 query rows a block), 0 the `attend` body with tq
// query rows per block.
int paged_multiquery_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* k_scale,
                                      const void* v_scale, const void* tables,
                                      const void* lens, const void* starts,
                                      void* out, int B, int T, int H, int Hkv,
                                      int D, int block_size, int P, int tq,
                                      int tensor_core, int q_dtype,
                                      int kv_dtype, float scale,
                                      void* stream) {
  Params p{q, k_pool, v_pool,
           static_cast<const float*>(k_scale),
           static_cast<const float*>(v_scale),
           static_cast<const int32_t*>(tables),
           static_cast<const int32_t*>(lens),
           static_cast<const int32_t*>(starts), out,
           T, H, Hkv, D, block_size, P, tq, scale};
  return run(true, tensor_core != 0, q_dtype, kv_dtype, p, B, stream);
}

}  // extern "C"
