// Paged attention over a block-paged KV pool, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of paddle_tpu/ops/pallas/paged_attention.py:
//   paged_decode_split_kernel, then paged_decode_combine_kernel
//                            <- _kernel    (paged_decode_attention_pallas, pallas_call :157)
//   paged_multiquery_kernel  <- _mq_kernel (paged_multiquery_attention_pallas, pallas_call :278)
//   paged_multiquery_tc_kernel, the tensor-core body of the second
//
// What they compute:
//   out[b, t, h, :] = softmax_j( (q[b,t,h]*scale) . K[j] ) V[j]
// over the request's tokens j taken page by page from its block-table row,
// visible when  j <= q_start[b] + t  and  j < context_lens[b]  (decode: one
// query row, q_start = ctx - 1). GQA maps query head h to kv head
// h / (H / Hkv), jnp.repeat's mapping. int8 pools hold codes with a per-row
// scale. Rows that see no token give 0.
//
// Decode body (split-KV, "flash-decoding"; namespace dec). A decode step
// reads every visible K/V row once and does 2 G operations a byte of a bf16
// pool (G = H / Hkv) against the H100's ~295 at its balance point: it is
// bound by bytes, and tensor cores cannot help. The design keeps enough
// loads in flight, from enough blocks, to stream K and V near 3.35 TB/s:
//  * the split: grid (B, Hkv x groups of kHeads query heads, n_split),
//    n_split = ceil(P * block_size / kSplit); a block takes kSplit tokens
//    of one request's context and returns at once if they start at or past
//    its visible end. At llama_1b's serving batch (B 8, Hkv 16, contexts up
//    to 2048) that is about 720 working blocks where one block per (request,
//    kv head) gave 128. The split depends on the context and the constants
//    below alone, never on B or the card, so a request's output is bit-
//    identical alone and in any batch;
//  * the per-warp stream: each of the kWarps warps takes kSplit / kWarps
//    consecutive tokens of the span and looks up their pool rows in the
//    block table once. A lane holds a run of 16 elements of a row for one
//    query head (32 B of bf16, 16 B of int8), else 8 (the row of one kv
//    head is D * sizeof(kv) contiguous bytes: 8 lanes of 32 B for bf16 at D
//    128), so a warp reads 32 / row_lanes(D) rows at once. Rows are copied
//    by cp.async into a ring of kStages stages of the warp's own, ordered
//    by cp.async.wait_group and __syncwarp alone: no block barrier inside
//    the stream. int8 codes are staged raw, with their two fp32 scales
//    beside them, and converted when read (a byte permute, no I2F);
//  * registers: each lane holds its columns of the G query rows (q * scale
//    in fp32, as _kernel scales them) and of their fp32 accumulators. A
//    score is a lane-partial dot product and a shuffle reduction; the
//    online softmax runs in the exp2 domain (log2 e folded into the score;
//    int8: k_scale multiplies the score and v_scale the probability). At
//    the end of the span the sub-warps of a warp merge by shuffles and the
//    warps through shared memory, behind the kernel's one barrier; the block
//    writes its partial (acc[D], m, l) in fp32 to the workspace
//    [B, H, n_split, D + 2];
//  * the ordered combine: paged_decode_combine_kernel, one thread per
//    output element, reads the request's ceil(end / kSplit) partials in
//    split order, rescales each by exp2(m_i - M), sums, divides by the
//    rescaled sum of the l_i and rounds once to q's dtype. No atomics:
//    bit-identical from run to run. It is launched as a programmatic
//    dependent of the split kernel (griddepcontrol), so its launch overlaps
//    the split kernel's tail.
// One C entry launches both kernels. A multi-query call with T = 1 takes the
// same body with the visible end min(ctx, q_start + 1): at q_start = ctx - 1
// it equals decode bit for bit.
// Time at the serving batch (B 8, H 16, D 128, block 16, 9916 context
// tokens, bf16; chip_smoke.py on an H100 80GB HBM3 at 700 W): 0.0424 ms
// for both kernels (1.9 TB/s of K/V), against a bound of 0.0243 ms (81.2
// MB at 3.35 TB/s) and 0.0597 ms for SDPA on gathered K/V; 0.0339 ms over
// an int8 pool. The body it replaced (one block per request and kv head,
// synchronous fp32 staging) took 0.2227 ms.
//
// `attend`, the CUDA-core multi-query body: one thread block per (request,
// kv head, tile of query rows); the block handles every query head of its
// kv head, so each K/V row is read from device memory once per block. Query
// rows (scaled in fp32 as _kernel does) and the fp32 accumulators live in
// shared memory; a loop over tiles of kTile tokens stands in for the TPU's
// sequential page grid axis. Each tile: the block resolves its tokens' pool
// rows from the block table, stages K and V in shared memory as fp32
// (dequantizing int8), computes the scores, folds them into the online
// softmax (m, l, acc in fp32) and accumulates P.V. A block only visits
// tokens below min(ctx, q_start + last_row + 1). It takes the multi-query
// calls with T > 1 that the tensor-core body does not: fp32 q, fp32 pools,
// head dims outside 32, 64 and 128. A long prefill chunk is bound by
// operations (9.67 GFLOP, 0.0098 ms at 989 TFLOP/s, for llama_1b's longest
// prefill chunk: T 2048, 1536 real rows, H 16, D 128).
//
// Tensor-core body (paged_multiquery_tc_kernel), taken by the multi-query
// entry for bf16 q over bf16 or int8 pools with T > 1 and head_dim 32, 64
// or 128; the wrapper chooses it from those alone. FlashAttention-2's
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

// The launch tally, kept on the device: thread 0 of block (0, 0, 0) of
// each body's kernel adds one a launch (a graph replay's too), so the host
// can read how many times each kernel really ran, a count independent of
// the wrappers' own (paged_kernel_tally). Slot 0 the decode body's split
// kernel, 1 `attend`, 2 the tensor-core body.
__device__ unsigned long long g_tally[3];

__device__ __forceinline__ void tally(int body) {
  if ((blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x) == 0)
    atomicAdd(&g_tally[body], 1ull);
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;           // tokens staged per iteration (one per lane)
constexpr float kNegInf = -1e30f;   // the Pallas kernels' NEG_INF

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };
// the multi-query entry's bodies (the decode entry takes kDecode)
enum Body { kCudaCore = 0, kTensorCore = 1, kDecode = 2 };

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
  float* work;            // decode body: [B, H, n_split, D + 2] partials
  int T, H, Hkv, D, block_size, P, tq, n_split, q_dtype;
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

// int8 codes to fp32 without a conversion instruction: code + 128 (the
// sign bit flipped) is placed in the low byte of 2^23's mantissa, and
// 2^23 + 128 is taken off again (exact)
__device__ __forceinline__ void load8(const int8_t* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    o[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u,
                                       0x7440u | (i % 4)))
           - 8388736.f;
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
__global__ void __launch_bounds__(kThreads) paged_multiquery_kernel(Params p) {
  tally(1);
  attend<QT, KVT>(p, blockIdx.x, blockIdx.y, blockIdx.z);
}

template <typename QT, typename KVT>
cudaError_t launch_attend(const Params& p, int B, cudaStream_t stream) {
  const int R = p.tq * (p.H / p.Hkv);
  const size_t smem = smem_bytes(R, p.D);
  void (*kern)(Params) = paged_multiquery_kernel<QT, KVT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int q_tiles = (p.T + p.tq - 1) / p.tq;
  kern<<<dim3(B, p.Hkv, q_tiles), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const Params& p, int B,
                        cudaStream_t s) {
  switch (kv_dtype) {
    case kF32: return launch_attend<QT, float>(p, B, s);
    case kBF16: return launch_attend<QT, __nv_bfloat16>(p, B, s);
    case kI8: return launch_attend<QT, int8_t>(p, B, s);
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
  tally(2);
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

// -- split-KV decode body ----------------------------------------------------

namespace dec {

constexpr int kSplit = 256;        // context tokens of one block (its span)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpTok = kSplit / kWarps;  // consecutive tokens of a warp
constexpr int kStages = 2;         // ring depth of each warp's stream
constexpr int kRows = 1;           // rows of a sub-warp in one stage
constexpr int kHeads = 8;          // query heads a block holds in registers
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kSplit % kWarps == 0, "a span divides over the warps");

// elements of a row one lane holds: 16 (32 B of bf16, 16 B of int8) for
// one query head, else 8 (the registers of G heads' q and acc)
template <typename KVT, int GR>
__host__ __device__ constexpr int lane_elems() {
  return GR == 1 && sizeof(KVT) < 4 ? 16 : 8;
}

// lanes that read one row: a power of two >= D / elems
__host__ __device__ inline int row_lanes(int D, int elems) {
  int l = 1;
  while (l * elems < D) l <<= 1;
  return l;
}

// shared memory of one warp: its ring of K and V rows (and int8 scales),
// which after the stream holds its merge record (GR x (D + 2) fp32), then
// the pool rows of its tokens
template <typename KVT, int GR>
__host__ __device__ inline size_t region_bytes(int D) {
  const int tps = kRows * (32 / row_lanes(D, lane_elems<KVT, GR>()));
  const size_t row = 2 * static_cast<size_t>(D) * sizeof(KVT)
                     + (sizeof(KVT) == 1 ? 2 * sizeof(float) : 0);
  const size_t ring = static_cast<size_t>(kStages) * tps * row;
  const size_t merge = static_cast<size_t>(GR) * (D + 2) * sizeof(float);
  return ((ring > merge ? ring : merge) + 15) & ~static_cast<size_t>(15);
}

template <typename KVT, int GR>
__host__ __device__ inline size_t warp_bytes(int D) {
  return region_bytes<KVT, GR>(D)
         + ((kWarpTok * sizeof(int) + 15) & ~static_cast<size_t>(15));
}

// one lane's run of NCH chunks of 8 elements, device to shared memory
// (zeros if !ok); `wide`: the row's bytes are a multiple of 16, so a run
// of 16-byte multiples copies 16 bytes at a time
template <typename KVT, int NCH>
__device__ __forceinline__ void copy_run(KVT* dst, const KVT* src, bool ok,
                                         int n_chunks, bool wide) {
  constexpr int kBytes = 8 * NCH * static_cast<int>(sizeof(KVT));
  constexpr int kPer16 = 16 / static_cast<int>(sizeof(KVT));
  if (kBytes % 16 == 0 && wide && n_chunks == NCH) {
#pragma unroll
    for (int o = 0; o < 8 * NCH; o += kPer16)
      tc::cp_async16(dst + o, src + o, ok);
    return;
  }
  for (int k = 0; k < n_chunks; ++k) {
    if constexpr (sizeof(KVT) == 1) {
      tc::cp_async8(dst + 8 * k, src + 8 * k, ok);
    } else {
#pragma unroll
      for (int o = 0; o < 8; o += kPer16)
        tc::cp_async16(dst + 8 * k + o, src + 8 * k + o, ok);
    }
  }
}

// tokens j < end are visible: min(ctx, q_start + 1), capped by the table
__device__ __forceinline__ int visible_end(const Params& p, int b) {
  const int ctx = p.lens[b];
  const int last = p.starts != nullptr ? min(ctx, p.starts[b] + 1) : ctx;
  return max(0, min(last, p.P * p.block_size));
}

template <typename KVT, int GR>
__global__ void __launch_bounds__(kThreads)
    paged_decode_split_kernel(Params p) {
  constexpr bool kInt8 = sizeof(KVT) == 1;
  constexpr int E = lane_elems<KVT, GR>(), NCH = E / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tally(0);
  const int b = blockIdx.x, split = blockIdx.z;
  const int end = visible_end(p, b);
  const int span0 = split * kSplit;
  tc::launch_dependents();   // the combine may take its place in the queue
  if (span0 >= end) return;  // the combine reads no partial of this split

  const int G = p.H / p.Hkv, n_hg = (G + kHeads - 1) / kHeads;
  const int hk = blockIdx.y / n_hg, g0 = (blockIdx.y % n_hg) * kHeads;
  const int ng = min(GR, G - g0);  // query heads of this block
  const int D = p.D, Dp = D + 2, bs = p.block_size;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lpr = row_lanes(D, E), S = 32 / lpr, tps = kRows * S;
  const int sw = lane / lpr, c = lane % lpr;  // sub-warp, run of chunks
  const int col = c * E;                      // first column of the run
  const int n_chunks = max(0, min(NCH, (D - col) / 8));
  const bool wide = D * sizeof(KVT) % 16 == 0;

  const size_t wb = warp_bytes<KVT, GR>(D);
  unsigned char* base = smem_raw + warp * wb;
  KVT* kr = reinterpret_cast<KVT*>(base);       // [kStages][tps][D]
  KVT* vr = kr + kStages * tps * D;
  float* ksr = reinterpret_cast<float*>(vr + kStages * tps * D);
  float* vsr = ksr + kStages * tps;             // int8: [kStages][tps] each
  float* rec = reinterpret_cast<float*>(base);  // after the stream
  int* rows = reinterpret_cast<int*>(base + region_bytes<KVT, GR>(D));

  // the pool row of each of the warp's tokens, through the block table
  const int w0 = span0 + warp * kWarpTok;
  const int n_tok = max(0, min(w0 + kWarpTok, end) - w0);
  const int n_steps = (n_tok + tps - 1) / tps;
  const int32_t* table = p.tables + static_cast<size_t>(b) * p.P;
  for (int i = lane; i < n_tok; i += 32) {
    const int tok = w0 + i;
    rows[i] = (table[tok / bs] * bs + tok % bs) * p.Hkv + hk;
  }
  __syncwarp();

  // this lane's columns of the block's query rows, q * scale in fp32
  float qv[GR][E];
  const size_t q0 = (static_cast<size_t>(b) * p.H + hk * G + g0) * D + col;
#pragma unroll
  for (int g = 0; g < GR; ++g)
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      float* x = qv[g] + 8 * k;
      if (g < ng && k < n_chunks) {
        const size_t at = q0 + g * D + 8 * k;
        if (p.q_dtype == kBF16)
          load8(static_cast<const __nv_bfloat16*>(p.q) + at, x);
        else
          load8(static_cast<const float*>(p.q) + at, x);
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] *= p.scale;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = 0.f;
      }
    }
  float m[GR], l[GR], acc[GR][E];
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const KVT* kp = static_cast<const KVT*>(p.k_pool);
  const KVT* vp = static_cast<const KVT*>(p.v_pool);
  // stage j of the warp's tokens into ring slot j % kStages; row r of
  // sub-warp sw is token w0 + j tps + r S + sw
  auto issue = [&](int j) {
    const int slot = j % kStages;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = j * tps + r * S + sw;
      const bool ok = t < n_tok;
      const size_t src = (ok ? static_cast<size_t>(rows[t]) : 0) * D + col;
      const int at = slot * tps + r * S + sw;
      copy_run<KVT, NCH>(kr + at * D + col, kp + src, ok, n_chunks, wide);
      copy_run<KVT, NCH>(vr + at * D + col, vp + src, ok, n_chunks, wide);
      if constexpr (kInt8) {
        if (c == 0) {
          const size_t row = ok ? rows[t] : 0;
          tc::cp_async4(ksr + at, p.k_scale + row, ok);
          tc::cp_async4(vsr + at, p.v_scale + row, ok);
        }
      }
    }
  };
  // this lane's run of a staged row, in fp32 (zeros past the row)
  auto read = [&](const KVT* row, float* x) {
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      if (k < n_chunks) {
        load8(row + col + 8 * k, x + 8 * k);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[8 * k + e] = 0.f;
      }
    }
  };
  // fold stage j into (m, l, acc)
  auto consume = [&](int j) {
    const int slot = j % kStages;
    float s[GR][kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float kx[E];
      read(kr + (slot * tps + r * S + sw) * D, kx);
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) a = fmaf(qv[g][e], kx[e], a);
        s[g][r] = a;
      }
    }
    for (int off = lpr >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < GR; ++g)
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          s[g][r] += __shfl_xor_sync(0xffffffffu, s[g][r], off);
    bool ok[kRows];
    float ksc[kRows], vsc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int at = slot * tps + r * S + sw;
      ok[r] = j * tps + r * S + sw < n_tok;
      ksc[r] = kInt8 ? ksr[at] : 1.f;
      vsc[r] = kInt8 ? vsr[at] : 1.f;
    }
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      float mx = m[g];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[g][r] = ok[r] ? s[g][r] * ksc[r] * kLog2e : kNegInf;
        mx = fmaxf(mx, s[g][r]);
      }
      const float corr = exp2f(m[g] - mx);
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[g][r] = ok[r] ? exp2f(s[g][r] - mx) : 0.f;
        sum += s[g][r];
      }
      l[g] = l[g] * corr + sum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float vx[E];
      read(vr + (slot * tps + r * S + sw) * D, vx);
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        const float pv = s[g][r] * vsc[r];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pv, vx[e], acc[g][e]);
      }
    }
  };

  // the ring: kStages - 1 stages in flight while one is folded in
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_steps) issue(j);
    tc::cp_async_commit();
  }
  for (int j = 0; j < n_steps; ++j) {
    if (j + kStages - 1 < n_steps) issue(j + kStages - 1);
    tc::cp_async_commit();
    tc::cp_async_wait<kStages - 1>();
    __syncwarp();  // stage j landed for every lane
    consume(j);
    __syncwarp();  // every lane is done with slot j before it is refilled
  }
  tc::cp_async_wait<0>();
  __syncwarp();

  // the sub-warps' states merge by shuffles (fixed order: xor lpr, 2 lpr, ..)
  for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = exp2f(m[g] - mn), f = exp2f(mo - mn);
      l[g] = l[g] * a + lo * f;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] = acc[g][e] * a
                    + __shfl_xor_sync(0xffffffffu, acc[g][e], off) * f;
      m[g] = mn;
    }
  }
  // the warp's record (its ring is free), then the warps in order
  if (sw == 0) {
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      if (g >= ng) continue;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (e < 8 * n_chunks) rec[g * Dp + col + e] = acc[g][e];
      if (lane == 0) {
        rec[g * Dp + D] = m[g];
        rec[g * Dp + D + 1] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * Dp; i += kThreads) {
    const int g = i / Dp, d = i % Dp;
    float mw[kWarps];
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = reinterpret_cast<const float*>(smem_raw + w * wb)[g * Dp + D];
      mx = fmaxf(mx, mw[w]);
    }
    float v = mx;
    if (d != D) {
      v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        v += reinterpret_cast<const float*>(smem_raw + w * wb)[g * Dp + d]
             * exp2f(mw[w] - mx);
    }
    p.work[((static_cast<size_t>(b) * p.H + hk * G + g0 + g) * p.n_split
            + split) * Dp + d] = v;
  }
}

// one thread per output element (b, h, d): the request's partials in split
// order (their loads are independent, so they are in flight together)
template <typename QT>
__global__ void __launch_bounds__(kThreads)
    paged_decode_combine_kernel(Params p, int B) {
  const int D = p.D, Dp = D + 2;
  const size_t i_out = static_cast<size_t>(blockIdx.x) * kThreads
                       + threadIdx.x;
  if (i_out >= static_cast<size_t>(B) * p.H * D) return;
  const int bh = static_cast<int>(i_out / D), d = static_cast<int>(i_out % D);
  const int n_used = (visible_end(p, bh / p.H) + kSplit - 1) / kSplit;
  tc::wait_on_prerequisite();  // the split kernel's partials are written
  const float* part = p.work + static_cast<size_t>(bh) * p.n_split * Dp;
  float mx = kNegInf;
#pragma unroll 4
  for (int i = 0; i < n_used; ++i) mx = fmaxf(mx, part[i * Dp + D]);
  float sum = 0.f, o = 0.f;
#pragma unroll 4
  for (int i = 0; i < n_used; ++i) {
    const float f = exp2f(part[i * Dp + D] - mx);
    sum += part[i * Dp + D + 1] * f;
    o += part[i * Dp + d] * f;
  }
  store1(static_cast<QT*>(p.out) + i_out, n_used > 0 ? o / sum : 0.f);
}

template <typename KVT, int GR>
cudaError_t launch_split(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = kWarps * warp_bytes<KVT, GR>(p.D);
  void (*kern)(Params) = paged_decode_split_kernel<KVT, GR>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int G = p.H / p.Hkv, n_hg = (G + kHeads - 1) / kHeads;
  kern<<<dim3(B, p.Hkv * n_hg, p.n_split), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// GR: the query heads a block holds, rounded up to a power of two
template <typename KVT>
cudaError_t dispatch_heads(const Params& p, int B, cudaStream_t s) {
  const int G = p.H / p.Hkv;
  if (G <= 1) return launch_split<KVT, 1>(p, B, s);
  if (G <= 2) return launch_split<KVT, 2>(p, B, s);
  if (G <= 4) return launch_split<KVT, 4>(p, B, s);
  return launch_split<KVT, kHeads>(p, B, s);
}

// the split kernel, then the combine; each launch checked
cudaError_t run(const Params& p, int B, int kv_dtype, cudaStream_t s) {
  if (p.T != 1 || p.D > 256 || (p.q_dtype != kF32 && p.q_dtype != kBF16)
      || p.n_split != (p.P * p.block_size + kSplit - 1) / kSplit)
    return cudaErrorInvalidValue;
  if (p.n_split > 0) {
    cudaError_t e = cudaErrorInvalidValue;
    switch (kv_dtype) {
      case kF32: e = dispatch_heads<float>(p, B, s); break;
      case kBF16: e = dispatch_heads<__nv_bfloat16>(p, B, s); break;
      case kI8: e = dispatch_heads<int8_t>(p, B, s); break;
    }
    if (e != cudaSuccess) return e;
  }
  // programmatic dependent launch: the combine is launched while the split
  // kernel runs and waits for it in wait_on_prerequisite
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B * p.H * p.D + kThreads - 1) / kThreads);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      p.q_dtype == kBF16
          ? cudaLaunchKernelEx(&cfg, paged_decode_combine_kernel<__nv_bfloat16>,
                               p, B)
          : cudaLaunchKernelEx(&cfg, paged_decode_combine_kernel<float>, p, B);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace dec

// body: kDecode (the split-KV body, T = 1), kTensorCore (bf16 q, bf16 or
// int8 pools, head_dim 32, 64 or 128) or kCudaCore (`attend`)
int run(int body, int kv_dtype, const Params& p, int B, void* stream) {
  if (B == 0 || p.T == 0) return cudaSuccess;
  if (p.D % 8 != 0 || p.H % p.Hkv != 0) return cudaErrorInvalidValue;
  if ((kv_dtype == kI8) != (p.k_scale != nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case kDecode:
      return dec::run(p, B, kv_dtype, s);
    case kTensorCore:
      if (p.q_dtype != kBF16) return cudaErrorInvalidValue;
      switch (kv_dtype) {
        case kBF16: return tcr::dispatch_d<__nv_bfloat16>(p, B, s);
        case kI8: return tcr::dispatch_d<int8_t>(p, B, s);
      }
      return cudaErrorInvalidValue;
    case kCudaCore:
      switch (p.q_dtype) {
        case kF32: return dispatch_kv<float>(kv_dtype, p, B, s);
        case kBF16: return dispatch_kv<__nv_bfloat16>(kv_dtype, p, B, s);
      }
      return cudaErrorInvalidValue;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Copy the launch tally (decode split kernel, attend, tensor-core body)
// into out[3]; with reset, zero it after. Synchronous: call it with the
// device idle. Returns the cudaError (0 = success).
int paged_kernel_tally(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_tally, sizeof(g_tally));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[3] = {0, 0, 0};
    e = cudaMemcpyToSymbol(g_tally, zero, sizeof(zero));
  }
  return static_cast<int>(e);
}

// Context tokens of one block of the decode body (kSplit): the decode
// workspace is [B, H, ceil(P * block_size / kSplit), D + 2] fp32.
int paged_decode_split_tokens() { return dec::kSplit; }

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

// q [B, H, D]; work [B, H, n_split, D + 2] fp32 with n_split =
// ceil(P * block_size / paged_decode_split_tokens()). Launches the split
// kernel and the combine; returns the first failed launch's cudaError (0 =
// success).
int paged_decode_attention_launch(const void* q, const void* k_pool,
                                  const void* v_pool, const void* k_scale,
                                  const void* v_scale, const void* tables,
                                  const void* lens, void* out, void* work,
                                  int B, int H, int Hkv, int D,
                                  int block_size, int P, int n_split,
                                  int q_dtype, int kv_dtype, float scale,
                                  void* stream) {
  Params p{q, k_pool, v_pool,
           static_cast<const float*>(k_scale),
           static_cast<const float*>(v_scale),
           static_cast<const int32_t*>(tables),
           static_cast<const int32_t*>(lens), nullptr, out,
           static_cast<float*>(work),
           1, H, Hkv, D, block_size, P, 1, n_split, q_dtype, scale};
  return run(kDecode, kv_dtype, p, B, stream);
}

// q [B, T, H, D] at positions q_start[b] + t; body 2 takes the decode body
// (T = 1; work and n_split as for decode), 1 the tensor-core body (64 query
// rows a block), 0 the `attend` body with tq query rows per block.
int paged_multiquery_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* k_scale,
                                      const void* v_scale, const void* tables,
                                      const void* lens, const void* starts,
                                      void* out, void* work, int B, int T,
                                      int H, int Hkv, int D, int block_size,
                                      int P, int n_split, int tq, int body,
                                      int q_dtype, int kv_dtype, float scale,
                                      void* stream) {
  Params p{q, k_pool, v_pool,
           static_cast<const float*>(k_scale),
           static_cast<const float*>(v_scale),
           static_cast<const int32_t*>(tables),
           static_cast<const int32_t*>(lens),
           static_cast<const int32_t*>(starts), out,
           static_cast<float*>(work),
           T, H, Hkv, D, block_size, P, tq, n_split, q_dtype, scale};
  return run(body, kv_dtype, p, B, stream);
}

}  // extern "C"
