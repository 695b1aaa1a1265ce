// Paged attention over a block-paged KV pool, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of paddle_tpu/ops/pallas/paged_attention.py:
//   paged_decode_kernel      <- _kernel    (paged_decode_attention_pallas, pallas_call :157)
//   paged_multiquery_kernel  <- _mq_kernel (paged_multiquery_attention_pallas, pallas_call :278)
//
// What it computes (both kernels share one device body, `attend`):
//   out[b, t, h, :] = softmax_j( (q[b,t,h]*scale) . K[j] ) V[j]
// over the request's tokens j taken page by page from its block-table row,
// visible when  j <= q_start[b] + t  and  j < context_lens[b]  (decode: one
// query row, q_start = ctx - 1). GQA maps query head h to kv head
// h / (H / Hkv), jnp.repeat's mapping. int8 pools are dequantized as
// codes * per-row scale while they are staged. Rows that see no token give 0.
//
// Design. One thread block per (request, kv head[, tile of query rows]): the
// block handles every query head of its kv head, so each K/V row is read from
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
// number of query rows. This first version uses fp32 CUDA-core math and no
// wgmma/TMA: the K/V stream is the part it keeps to one pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

int run(bool multi, int q_dtype, int kv_dtype, const Params& p, int B,
        void* stream) {
  if (B == 0 || p.T == 0) return cudaSuccess;
  if (p.D % 8 != 0 || p.H % p.Hkv != 0) return cudaErrorInvalidValue;
  if ((kv_dtype == kI8) != (p.k_scale != nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32: return dispatch_kv<float>(multi, kv_dtype, p, B, s);
    case kBF16: return dispatch_kv<__nv_bfloat16>(multi, kv_dtype, p, B, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

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
  return run(false, q_dtype, kv_dtype, p, B, stream);
}

// q [B, T, H, D] at positions q_start[b] + t; tq query rows per block.
int paged_multiquery_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* k_scale,
                                      const void* v_scale, const void* tables,
                                      const void* lens, const void* starts,
                                      void* out, int B, int T, int H, int Hkv,
                                      int D, int block_size, int P, int tq,
                                      int q_dtype, int kv_dtype, float scale,
                                      void* stream) {
  Params p{q, k_pool, v_pool,
           static_cast<const float*>(k_scale),
           static_cast<const float*>(v_scale),
           static_cast<const int32_t*>(tables),
           static_cast<const int32_t*>(lens),
           static_cast<const int32_t*>(starts), out,
           T, H, Hkv, D, block_size, P, tq, scale};
  return run(true, q_dtype, kv_dtype, p, B, stream);
}

}  // extern "C"
