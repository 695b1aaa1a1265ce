// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of paddle_tpu/ops/pallas/flash_attention.py,
// each built without rope (ROPE = false) and with it (ROPE = true, the
// kernels of _flash_mha_rope, :348):
//   flash_fwd_kernel     <- _fwd_kernel     (_fwd, pallas_call :136)
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel  (_bwd, pallas_call :280)
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel (_bwd, pallas_call :296)
//
// What they compute, on q, k, v [BH, S, D] (bf16 or fp32) with a scale and an
// optional causal mask (key c visible to query row r when c <= r):
//   forward  s = (q*scale) k^T, out = softmax(s) v, lse = m + log(max(l, 1e-30))
//            with lse [BH, S] in fp32;
//   dq       p = exp(s - lse), delta = rowsum(dO * O) in fp32 from the stored O,
//            dS = p (dO v^T - delta) scale, dq = dS k;
//   dk, dv   dv = p^T dO, dk = dS^T q.
// Masked scores are the Pallas kernels' finite NEG_INF (-1e30) and their
// probabilities are 0. Arithmetic is fp32; outputs are in the input dtype.
//
// Rope. With ROPE, q and k arrive before the rotary embedding, with fp32
// tables cos, sin [S, D] (both halves filled, the reference's _widen_tables).
// Every q and k tile is rotated in fp32 as it is staged, x c + [-x2, x1] s
// (q is scaled after the rotation); dq and dk are rotated back with the sin
// negated before they are stored, and dv is unchanged. Element j pairs with
// j +- D/2, so a thread stages and stores the two halves of its 8 columns
// together, from registers, and never rotates a shared-memory row in place.
// Rows at or past S are zero-filled without reading the tables.
//
// Design. FA-2's split, as the JAX package has it: forward and dq give one
// block to each (b*h, tile of 64 query rows) and loop over tiles of 64 keys up
// to the causal bound (the TPU's sequential grid axis becomes a loop inside
// the block); dkv gives one block to each (b*h, tile of 64 keys) and loops
// over the query tiles that see it. No two blocks write the same element, so
// there are no atomics and results are the same from run to run. Tiles are
// staged in shared memory as fp32 rows with stride D + 4, so that the float4
// reads of neighbouring threads fall on distinct banks. The 256 threads form
// a 16 x 16 grid: each holds a 4 x 4 micro-tile of the 64 x 64 score tile
// (rows ty + 16i, keys tx + 16j) and 4 rows x D/16 columns of its output
// accumulator in registers; the online-softmax row statistics are reduced
// over the 16 threads of a half-warp with shuffles. A ragged last tile (S not
// a multiple of 64) is zero-filled when staged and masked. Causal query tiles
// are scheduled longest first.
//
// Bound on an H100 at the training shape (B 16, H 12, S 1024, D 64, bf16):
// by its roofline each kernel is bound by memory bytes (each input read once:
// about 101, 152 and 177 MB), but this first version runs its products as
// fp32 FMAs on the CUDA cores out of shared memory, not on the bf16 tensor
// cores, so the FMA issue rate is what bounds it in practice; it also reads
// K/V once per query tile (Q, dO, O once per key tile in dkv), mostly from the
// 50 MB L2. Tensor-core tiles (mma/wgmma), TMA and a pipelined tile ring are
// the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // a 16 x 16 grid of threads
constexpr int kTile = 64;          // query rows / keys per tile
constexpr int kPLD = kTile + 16;   // row stride of the P and dS tiles
constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF

enum DType { kF32 = 0, kBF16 = 1 };
enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

struct Params {
  const void* q;     // [BH, S, D]
  const void* k;
  const void* v;
  const void* o;     // forward output (backward input)
  const void* dout;  // gradient of the output (backward input)
  float* lse;        // [BH, S]: written by the forward, read by the backward
  void* res;         // forward: out; dq kernel: dq; dkv kernel: dk
  void* res2;        // dkv kernel: dv
  const float* cs;   // rope tables [S, D] fp32 (ROPE only)
  const float* sn;
  int S;
  float scale;
  int causal;
};

template <int D>
struct Cfg {
  static constexpr int LD = D + 4;              // row stride of a staged tile
  static constexpr int DPT = D / 16;            // output columns per thread
  static constexpr int VW = DPT < 4 ? DPT : 4;  // ... in groups of VW adjacent
};

__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ __align__(16) float smem_[];
  return smem_;
}

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// VW adjacent floats from shared memory (VW * 4-byte aligned)
template <int VW>
__device__ __forceinline__ void lds(const float* p, float* o) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x; o[1] = t.y;
  } else {
    o[0] = *p;
  }
}

// the column of a thread's kk-th output element: groups of VW adjacent
// columns, the 16 threads of a row side by side within a group
template <int D>
__device__ __forceinline__ int out_col(int tx, int kk) {
  constexpr int VW = Cfg<D>::VW;
  return (kk / VW) * 16 * VW + tx * VW + kk % VW;
}

// the thread's DPT columns of row `row` of a staged tile
template <int D>
__device__ __forceinline__ void load_cols(const float* x, int row, int tx,
                                          float* o) {
  constexpr int LD = Cfg<D>::LD, VW = Cfg<D>::VW, DPT = Cfg<D>::DPT;
#pragma unroll
  for (int g = 0; g < DPT / VW; ++g)
    lds<VW>(x + row * LD + g * 16 * VW + tx * VW, o + g * VW);
}

// stage rows [row0, row0 + kTile) of one [S, D] slice, times `mul`, as fp32
// into dst[kTile][LD]; rows at or past S are zero
template <int D, typename T>
__device__ __forceinline__ void load_rows(const T* src, int row0, int S,
                                          float mul, float* dst) {
  constexpr int LD = Cfg<D>::LD, D8 = D / 8;
  for (int i = threadIdx.x; i < kTile * D8; i += kThreads) {
    const int r = i / D8, c = (i % D8) * 8;
    float x[8];
    if (row0 + r < S) {
      load8(src + static_cast<size_t>(row0 + r) * D + c, x);
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] *= mul;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = 0.f;
    }
    float4* d4 = reinterpret_cast<float4*>(dst + r * LD + c);
    d4[0] = make_float4(x[0], x[1], x[2], x[3]);
    d4[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

// stage rows [row0, row0 + kTile) of one pre-rotary [S, D] slice, rotated in
// fp32 by the tables cs, sn [S, D] and then times `mul`, into dst[kTile][LD];
// each item is 8 columns of the first half with their partners D/2 on, both
// read into registers before either is written; rows at or past S are zero
template <int D, typename T>
__device__ __forceinline__ void load_rows_rope(const T* src, const float* cs,
                                               const float* sn, int row0,
                                               int S, float mul, float* dst) {
  constexpr int LD = Cfg<D>::LD, H = D / 2, H8 = H / 8;
  for (int i = threadIdx.x; i < kTile * H8; i += kThreads) {
    const int r = i / H8, c = (i % H8) * 8;
    float a[8], b[8];
    if (row0 + r < S) {
      const size_t at = static_cast<size_t>(row0 + r) * D + c;
      float ca[8], cb[8], sa[8], sb[8];
      load8(src + at, a);
      load8(src + at + H, b);
      load8(cs + at, ca);
      load8(cs + at + H, cb);
      load8(sn + at, sa);
      load8(sn + at + H, sb);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x1 = a[j], x2 = b[j];
        a[j] = (x1 * ca[j] - x2 * sa[j]) * mul;
        b[j] = (x2 * cb[j] + x1 * sb[j]) * mul;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] = b[j] = 0.f;
    }
    float4* da = reinterpret_cast<float4*>(dst + r * LD + c);
    float4* db = reinterpret_cast<float4*>(dst + r * LD + c + H);
    da[0] = make_float4(a[0], a[1], a[2], a[3]);
    da[1] = make_float4(a[4], a[5], a[6], a[7]);
    db[0] = make_float4(b[0], b[1], b[2], b[3]);
    db[1] = make_float4(b[4], b[5], b[6], b[7]);
  }
}

// stage a q or k tile, rotated when ROPE
template <int D, bool ROPE, typename T>
__device__ __forceinline__ void stage(const T* src, const Params& p, int row0,
                                      float mul, float* dst) {
  if constexpr (ROPE)
    load_rows_rope<D>(src, p.cs, p.sn, row0, p.S, mul, dst);
  else
    load_rows<D>(src, row0, p.S, mul, dst);
}

// store rows [row0, row0 + kTile) of a staged fp32 gradient tile src to
// dst [S, D], rotated back through the rope (the sin negated); rows at or
// past S are skipped
template <int D, typename T>
__device__ __forceinline__ void store_rows_unrope(const float* src,
                                                  const float* cs,
                                                  const float* sn, int row0,
                                                  int S, T* dst) {
  constexpr int LD = Cfg<D>::LD, H = D / 2, H8 = H / 8;
  for (int i = threadIdx.x; i < kTile * H8; i += kThreads) {
    const int r = i / H8, c = (i % H8) * 8;
    if (row0 + r >= S) continue;
    const size_t at = static_cast<size_t>(row0 + r) * D + c;
    float a[8], b[8], ca[8], cb[8], sa[8], sb[8];
    load8(src + r * LD + c, a);
    load8(src + r * LD + c + H, b);
    load8(cs + at, ca);
    load8(cs + at + H, cb);
    load8(sn + at, sa);
    load8(sn + at + H, sb);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      store1(dst + at + j, a[j] * ca[j] + b[j] * sa[j]);
      store1(dst + at + H + j, b[j] * cb[j] - a[j] * sb[j]);
    }
  }
}

// write a thread's [4][DPT] accumulator (rows ty + 16i) into a staged tile
template <int D>
__device__ __forceinline__ void acc_to_tile(const float (&acc)[4][Cfg<D>::DPT],
                                            int ty, int tx, float* dst) {
  constexpr int LD = Cfg<D>::LD, DPT = Cfg<D>::DPT;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int kk = 0; kk < DPT; ++kk)
      dst[(ty + 16 * i) * LD + out_col<D>(tx, kk)] = acc[i][kk];
}

// s[i][j] = a[ty + 16i] . b[tx + 16j] over D, for staged row tiles a and b
template <int D>
__device__ __forceinline__ void row_dots(const float* a, const float* b,
                                         int ty, int tx, float (&s)[4][4]) {
  constexpr int LD = Cfg<D>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float av[4][4], bv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) lds<4>(a + (ty + 16 * i) * LD + d, av[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) lds<4>(b + (tx + 16 * j) * LD + d, bv[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j] = fmaf(av[i][e], bv[j][e], s[i][j]);
  }
}

// acc[i][kk] += sum_c p[ty + 16i][c] * x[c][out_col(kk)]
// (p: a kTile x kPLD tile, x: a staged row tile)
template <int D>
__device__ __forceinline__ void mul_rows(const float* p, const float* x,
                                         int ty, int tx,
                                         float (&acc)[4][Cfg<D>::DPT]) {
  constexpr int DPT = Cfg<D>::DPT;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float pv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) lds<4>(p + (ty + 16 * i) * kPLD + c, pv[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float xv[DPT];
      load_cols<D>(x, c + e, tx, xv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int kk = 0; kk < DPT; ++kk)
          acc[i][kk] = fmaf(pv[i][e], xv[kk], acc[i][kk]);
    }
  }
}

// acc[j][kk] += sum_r p[r][ty + 16j] * x[r][out_col(kk)]   (p transposed)
template <int D>
__device__ __forceinline__ void mul_cols(const float* p, const float* x,
                                         int ty, int tx,
                                         float (&acc)[4][Cfg<D>::DPT]) {
  constexpr int DPT = Cfg<D>::DPT;
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float pj[4], xv[DPT];
#pragma unroll
    for (int j = 0; j < 4; ++j) pj[j] = p[r * kPLD + ty + 16 * j];
    load_cols<D>(x, r, tx, xv);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int kk = 0; kk < DPT; ++kk)
        acc[j][kk] = fmaf(pj[j], xv[kk], acc[j][kk]);
  }
}

// reductions over the 16 threads of a row (one half-warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rs[r] = lse of query row q0 + r, rs[kTile + r] = delta = sum_d O * dO in
// fp32, O read from device memory in its stored dtype (rows past S: 0)
template <int D, typename T>
__device__ __forceinline__ void row_stats(const T* o, const float* dos,
                                          const float* lse, int q0, int S,
                                          float* rs) {
  constexpr int LD = Cfg<D>::LD;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const bool live = q0 + r < S;
    float acc = 0.f;
    if (live)
      for (int d = lane; d < D; d += 32)
        acc += to_f32(o[static_cast<size_t>(q0 + r) * D + d]) * dos[r * LD + d];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      rs[r] = live ? lse[q0 + r] : 0.f;
      rs[kTile + r] = acc;
    }
  }
}

template <int D, typename T, bool ROPE>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int LD = Cfg<D>::LD, DPT = Cfg<D>::DPT;
  float* qs = dyn_smem();
  float* ks = qs + kTile * LD;
  float* vs = ks + kTile * LD;
  float* ps = vs + kTile * LD;
  const int S = p.S, bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const T* k = static_cast<const T*>(p.k) + base;
  const T* v = static_cast<const T*>(p.v) + base;
  stage<D, ROPE>(static_cast<const T*>(p.q) + base, p, q0, p.scale, qs);

  float acc[4][DPT], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DPT; ++kk) acc[i][kk] = 0.f;
  }
  const int kv_end = p.causal ? min(S, q0 + kTile) : S;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    stage<D, ROPE>(k, p, k0, 1.f, ks);
    load_rows<D>(v, k0, S, 1.f, vs);
    __syncthreads();
    float s[4][4];
    row_dots<D>(qs, ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        ok[j] = c < S && (!p.causal || c <= r);
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += e;
        ps[(ty + 16 * i) * kPLD + tx + 16 * j] = e;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int kk = 0; kk < DPT; ++kk) acc[i][kk] *= corr;
    }
    __syncthreads();
    mul_rows<D>(ps, vs, ty, tx, acc);
  }

  T* out = static_cast<T*>(p.res) + base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int kk = 0; kk < DPT; ++kk)
      store1(out + static_cast<size_t>(r) * D + out_col<D>(tx, kk),
             acc[i][kk] / den);
    if (tx == 0) p.lse[static_cast<size_t>(bh) * S + r] = m[i] + logf(den);
  }
}

template <int D, typename T, bool ROPE>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  constexpr int LD = Cfg<D>::LD, DPT = Cfg<D>::DPT;
  float* qs = dyn_smem();  // q * scale
  float* dos = qs + kTile * LD;
  float* ks = dos + kTile * LD;
  float* vs = ks + kTile * LD;
  float* dss = vs + kTile * LD;  // dS [kTile][kPLD]
  float* rs = dss + kTile * kPLD;
  const int S = p.S, bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const T* k = static_cast<const T*>(p.k) + base;
  const T* v = static_cast<const T*>(p.v) + base;
  stage<D, ROPE>(static_cast<const T*>(p.q) + base, p, q0, p.scale, qs);
  load_rows<D>(static_cast<const T*>(p.dout) + base, q0, S, 1.f, dos);
  __syncthreads();
  row_stats<D>(static_cast<const T*>(p.o) + base, dos,
               p.lse + static_cast<size_t>(bh) * S, q0, S, rs);
  __syncthreads();
  float lse_r[4], delta_r[4], dq[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = rs[ty + 16 * i];
    delta_r[i] = rs[kTile + ty + 16 * i];
#pragma unroll
    for (int kk = 0; kk < DPT; ++kk) dq[i][kk] = 0.f;
  }
  const int kv_end = p.causal ? min(S, q0 + kTile) : S;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();
    stage<D, ROPE>(k, p, k0, 1.f, ks);
    load_rows<D>(v, k0, S, 1.f, vs);
    __syncthreads();
    float s[4][4], dp[4][4];
    row_dots<D>(qs, ks, ty, tx, s);
    row_dots<D>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool ok = c < S && (!p.causal || c <= r);
        const float pr = ok ? expf(s[i][j] - lse_r[i]) : 0.f;
        dss[(ty + 16 * i) * kPLD + tx + 16 * j] =
            pr * (dp[i][j] - delta_r[i]) * p.scale;
      }
    }
    __syncthreads();
    mul_rows<D>(dss, ks, ty, tx, dq);
  }

  T* out = static_cast<T*>(p.res) + base;
  if constexpr (ROPE) {
    // rotate dq back: its halves live in other threads, so go through qs
    __syncthreads();  // every reader of qs is done
    acc_to_tile<D>(dq, ty, tx, qs);
    __syncthreads();
    store_rows_unrope<D>(qs, p.cs, p.sn, q0, S, out);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int kk = 0; kk < DPT; ++kk)
      store1(out + static_cast<size_t>(r) * D + out_col<D>(tx, kk), dq[i][kk]);
  }
}

template <int D, typename T, bool ROPE>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  constexpr int LD = Cfg<D>::LD, DPT = Cfg<D>::DPT;
  float* ks = dyn_smem();  // k * scale
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;
  float* dos = qs + kTile * LD;
  float* ps = dos + kTile * LD;  // P [kTile][kPLD]
  float* dss = ps + kTile * kPLD;  // dS [kTile][kPLD]
  float* rs = dss + kTile * kPLD;
  const int S = p.S, bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const T* q = static_cast<const T*>(p.q) + base;
  const T* dout = static_cast<const T*>(p.dout) + base;
  const T* o = static_cast<const T*>(p.o) + base;
  const float* lse = p.lse + static_cast<size_t>(bh) * S;
  stage<D, ROPE>(static_cast<const T*>(p.k) + base, p, k0, p.scale, ks);
  load_rows<D>(static_cast<const T*>(p.v) + base, k0, S, 1.f, vs);

  float dk[4][DPT], dv[4][DPT];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int kk = 0; kk < DPT; ++kk) dk[j][kk] = dv[j][kk] = 0.f;
  // the first query tile that sees this key tile
  for (int q0 = p.causal ? k0 : 0; q0 < S; q0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    stage<D, ROPE>(q, p, q0, 1.f, qs);
    load_rows<D>(dout, q0, S, 1.f, dos);
    __syncthreads();
    row_stats<D>(o, dos, lse, q0, S, rs);
    __syncthreads();
    float s[4][4], dp[4][4];
    row_dots<D>(qs, ks, ty, tx, s);
    row_dots<D>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      const float lse_r = rs[ty + 16 * i], delta_r = rs[kTile + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool ok = r < S && c < S && (!p.causal || c <= r);
        const float pr = ok ? expf(s[i][j] - lse_r) : 0.f;
        ps[(ty + 16 * i) * kPLD + tx + 16 * j] = pr;
        dss[(ty + 16 * i) * kPLD + tx + 16 * j] =
            pr * (dp[i][j] - delta_r) * p.scale;
      }
    }
    __syncthreads();
    mul_cols<D>(ps, dos, ty, tx, dv);
    mul_cols<D>(dss, qs, ty, tx, dk);
  }

  T* dk_out = static_cast<T*>(p.res) + base;
  T* dv_out = static_cast<T*>(p.res2) + base;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = k0 + ty + 16 * j;
    if (c >= S) continue;
#pragma unroll
    for (int kk = 0; kk < DPT; ++kk) {
      const size_t at = static_cast<size_t>(c) * D + out_col<D>(tx, kk);
      if constexpr (!ROPE) store1(dk_out + at, dk[j][kk]);
      store1(dv_out + at, dv[j][kk]);
    }
  }
  if constexpr (ROPE) {
    // rotate dk back: its halves live in other threads, so go through ks
    __syncthreads();  // every reader of ks is done
    acc_to_tile<D>(dk, ty, tx, ks);
    __syncthreads();
    store_rows_unrope<D>(ks, p.cs, p.sn, k0, S, dk_out);
  }
}

template <int D>
size_t smem_bytes(int which) {
  const size_t row_tile = static_cast<size_t>(kTile) * Cfg<D>::LD;
  const size_t p_tile = static_cast<size_t>(kTile) * kPLD;
  size_t floats = 0;
  switch (which) {
    case kFwd: floats = 3 * row_tile + p_tile; break;
    case kDq: floats = 4 * row_tile + p_tile + 2 * kTile; break;
    case kDkv: floats = 4 * row_tile + 2 * p_tile + 2 * kTile; break;
  }
  return floats * sizeof(float);
}

template <int D, typename T, bool ROPE>
cudaError_t launch(int which, const Params& p, int BH, cudaStream_t stream) {
  void (*kern)(Params) = which == kFwd  ? flash_fwd_kernel<D, T, ROPE>
                         : which == kDq ? flash_bwd_dq_kernel<D, T, ROPE>
                                        : flash_bwd_dkv_kernel<D, T, ROPE>;
  const size_t smem = smem_bytes<D>(which);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((p.S + kTile - 1) / kTile, BH);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool ROPE>
cudaError_t dispatch_dim(int which, int D, const Params& p, int BH,
                         cudaStream_t s) {
  switch (D) {
    case 32: return launch<32, T, ROPE>(which, p, BH, s);
    case 64: return launch<64, T, ROPE>(which, p, BH, s);
    case 128: return launch<128, T, ROPE>(which, p, BH, s);
  }
  return cudaErrorInvalidValue;
}

template <bool ROPE>
int run(int which, int dtype, int D, const Params& p, int BH, void* stream) {
  if (BH == 0 || p.S == 0) return cudaSuccess;
  if (BH > 65535) return cudaErrorInvalidValue;  // grid y limit
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return dispatch_dim<float, ROPE>(which, D, p, BH, s);
    case kBF16: return dispatch_dim<__nv_bfloat16, ROPE>(which, D, p, BH, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v, out [BH, S, D]; lse [BH, S] fp32; with rope, cos and sin [S, D]
// fp32 after the other pointers, and q, k pre-rotary. Each function returns
// cudaGetLastError() after its launch (0 = success).
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* out, void* lse, int BH, int S, int D,
                               int dtype, float scale, int causal,
                               void* stream) {
  Params p{q, k, v, nullptr, nullptr, static_cast<float*>(lse), out, nullptr,
           nullptr, nullptr, S, scale, causal};
  return run<false>(kFwd, dtype, D, p, BH, stream);
}

int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* dq, int BH, int S,
                                  int D, int dtype, float scale, int causal,
                                  void* stream) {
  Params p{q, k, v, o, dout,
           const_cast<float*>(static_cast<const float*>(lse)), dq, nullptr,
           nullptr, nullptr, S, scale, causal};
  return run<false>(kDq, dtype, D, p, BH, stream);
}

int flash_attention_bwd_dkv_launch(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dk, void* dv, int BH, int S, int D,
                                   int dtype, float scale, int causal,
                                   void* stream) {
  Params p{q, k, v, o, dout,
           const_cast<float*>(static_cast<const float*>(lse)), dk, dv,
           nullptr, nullptr, S, scale, causal};
  return run<false>(kDkv, dtype, D, p, BH, stream);
}

int flash_attention_rope_fwd_launch(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    const void* cs, const void* sn, int BH,
                                    int S, int D, int dtype, float scale,
                                    int causal, void* stream) {
  Params p{q, k, v, nullptr, nullptr, static_cast<float*>(lse), out, nullptr,
           static_cast<const float*>(cs), static_cast<const float*>(sn), S,
           scale, causal};
  return run<true>(kFwd, dtype, D, p, BH, stream);
}

int flash_attention_rope_bwd_dq_launch(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, const void* lse,
                                       void* dq, const void* cs,
                                       const void* sn, int BH, int S, int D,
                                       int dtype, float scale, int causal,
                                       void* stream) {
  Params p{q, k, v, o, dout,
           const_cast<float*>(static_cast<const float*>(lse)), dq, nullptr,
           static_cast<const float*>(cs), static_cast<const float*>(sn), S,
           scale, causal};
  return run<true>(kDq, dtype, D, p, BH, stream);
}

int flash_attention_rope_bwd_dkv_launch(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const void* lse,
                                        void* dk, void* dv, const void* cs,
                                        const void* sn, int BH, int S, int D,
                                        int dtype, float scale, int causal,
                                        void* stream) {
  Params p{q, k, v, o, dout,
           const_cast<float*>(static_cast<const float*>(lse)), dk, dv,
           static_cast<const float*>(cs), static_cast<const float*>(sn), S,
           scale, causal};
  return run<true>(kDkv, dtype, D, p, BH, stream);
}

}  // extern "C"
