// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of paddle_tpu/ops/pallas/flash_attention.py,
// each built without rope (ROPE = false) and with it (ROPE = true, the
// kernels of _flash_mha_rope, :348):
//   flash_fwd_kernel     <- _fwd_kernel     (_fwd, pallas_call :136)
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel  (_bwd, pallas_call :280)
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel (_bwd, pallas_call :296)
// and, for bf16, their tensor-core bodies flash_fwd_tc_kernel,
// flash_bwd_dq_tc_kernel and flash_bwd_dkv_tc_kernel (namespace tcr).
//
// What they compute, on q, k, v [BH, S, D] (bf16 or fp32) with a scale and an
// optional causal mask (key c visible to query row r when c <= r):
//   forward  s = (q*scale) k^T, out = softmax(s) v, lse = m + log(max(l, 1e-30))
//            with lse [BH, S] in fp32;
//   dq       p = exp(s - lse), delta = rowsum(dO * O) in fp32 from the stored O,
//            dS = p (dO v^T - delta) scale, dq = dS k;
//   dk, dv   dv = p^T dO, dk = dS^T q.
// Masked scores are the Pallas kernels' finite NEG_INF (-1e30) and their
// probabilities are 0. Sums are fp32; outputs are in the input dtype.
//
// Rope. With ROPE, q and k arrive before the rotary embedding, with fp32
// tables cos, sin [S, D] (both halves filled, the reference's _widen_tables).
// Every q and k tile is rotated in fp32 as it is staged, x c + [-x2, x1] s
// (q is scaled after the rotation); dq and dk are rotated back with the sin
// negated before they are stored, and dv and the forward's out are
// unchanged. Element j pairs with j +- D/2, so a thread stages and stores the
// two halves of its 8 columns together, from registers, and never rotates a
// shared-memory row in place. Rows at or past S are zero-filled without
// reading the tables.
//
// Design. FA-2's split, as the JAX package has it: forward and dq give one
// block to each (b*h, tile of 64 query rows) and loop over tiles of 64 keys up
// to the causal bound (the TPU's sequential grid axis becomes a loop inside
// the block); dkv gives one block to each (b*h, tile of 64 keys) and loops
// over the query tiles that see it. No two blocks write the same element, so
// there are no atomics and results are the same from run to run. Causal
// query tiles are scheduled longest first; a ragged last tile (S not a
// multiple of 64) is zero-filled when staged and masked.
//
// Bound on an H100 at the training shape (B 16, H 12, S 1024, D 64, bf16):
// by its roofline each kernel is bound by memory bytes (each input read once:
// about 101, 152 and 177 MB). Each kernel has two bodies, chosen by dtype in
// the wrapper:
//
// CUDA-core bodies (fp32, whose fp32 products the card-vs-CPU training
// checks rely on). Tiles are staged in shared memory as fp32 rows with
// stride D + 4, so that the float4 reads of neighbouring threads fall on
// distinct banks. The 256 threads form a 16 x 16 grid: each holds a 4 x 4
// micro-tile of the 64 x 64 score tile (rows ty + 16i, keys tx + 16j) and
// 4 rows x D/16 columns of its output accumulator in registers; the
// online-softmax row statistics are reduced over the 16 threads of a
// half-warp with shuffles. Products are fp32 FMAs out of shared memory, so
// the FMA issue rate bounds them in practice. They read K/V once per query
// tile (Q, dO, O once per key tile in dkv), mostly from the 50 MB L2.
//
// Tensor-core bodies (bf16, namespace tcr): FlashAttention-2's forward and
// backward on csrc/tensor_core.cuh, the same split and grid but 4 warps of
// 16 rows a block. Tiles stay bf16 in shared memory (row stride D + 8) and
// stream by cp.async into two-stage rings; products are mma.sync m16n8k16
// (bf16 in, fp32 sums) with operands from ldmatrix. The scale multiplies the
// fp32 scores, so without rope every operand of S = q k^T and dP = dO v^T
// is an exact bf16 value. forward: the online softmax runs on the score
// registers in the exp2 domain (row max and sum over the 4 lanes of a quad,
// the correction rescales the accumulator), and P leaves them as the A
// fragments of P V (the C -> A identity), V through ldmatrix.trans. dq:
// queries are the M rows, so dS feeds dS K the same way, K through
// ldmatrix.trans. dkv: keys are the M rows, S^T = K Q^T and dP^T = V dO^T,
// and P^T and dS^T feed dV += P^T dO and dK += dS^T Q from registers the
// same way. P and dS are fp32 values: each is split into bf16 hi + lo (two
// products; rounded alone they fail the tolerance, CPU tests). With ROPE
// each q or k tile is rotated in fp32 as it is staged (by plain loads) and
// stored as hi and lo tiles; S, dq and dk take hi.hi + hi.lo + lo.hi, and
// dq and dk are rotated back in registers, where each thread holds both
// partner columns c and c + D/2. delta = rowsum(dO O) is formed in fp32
// from the staged bf16 tiles (dkv: once per query tile). D 128 takes the
// streamed tile in two halves of 32 rows to keep the accumulators in
// registers. Masks are applied only in blocks on the causal diagonal or
// past S, chosen warp-uniformly. In practice these bodies are bound by
// neither bytes nor tensor-core rate: the mma.sync products take two
// fifths to a half of their time, the rest goes to every warp's ldmatrix
// reads of each streamed tile, the softmax epilogue, the lo products and
// the stream (scripts/flash_fwd_ablation.py, scripts/flash_bwd_ablation.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

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

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

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

// -- tensor-core bodies (bf16) -----------------------------------------------

namespace tcr {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps x 16 rows of the block's own tile
constexpr int kRows = 64;  // the block's own rows: queries (fwd, dq), keys (dkv)
constexpr int kCols = 64;  // rows of a streamed tile: keys (fwd, dq), queries (dkv)
constexpr float kLog2e = 1.4426950408889634f;  // p = 2^(s log2e - lse log2e)
constexpr float kLn2 = 0.6931471805599453f;    // lse = m2 ln 2 + log(l)

template <int D>
struct Cfg {
  static constexpr int LD = D + 8;         // bf16 row stride: ldmatrix rows
                                           // of 8 lanes fall on distinct banks
  static constexpr int TILE = kCols * LD;  // bf16 elements of one staged tile
  static constexpr int NT = D / 8;         // 8-column n tiles over D
  static constexpr int NC = D <= 64 ? 64 : 32;  // streamed rows an inner step
};

// rows [row0, row0 + kCols) of one bf16 [S, D] slice into dst [kCols][LD]
// by cp.async, zero-filled past S
template <int D>
__device__ __forceinline__ void issue_rows(const bf16* src, int row0, int S,
                                           bf16* dst) {
  constexpr int LD = Cfg<D>::LD, C8 = D / 8;
  for (int i = threadIdx.x; i < kCols * C8; i += kThreads) {
    const int r = i / C8, c = (i % C8) * 8;
    const bool ok = row0 + r < S;
    tc::cp_async16(dst + r * LD + c,
                   src + (ok ? static_cast<size_t>(row0 + r) * D + c : 0), ok);
  }
}

// lse of rows [row0, row0 + kCols) into dst by cp.async, zero past S
__device__ __forceinline__ void issue_lse(const float* lse, int row0, int S,
                                          float* dst) {
  for (int r = threadIdx.x; r < kCols; r += kThreads) {
    const bool ok = row0 + r < S;
    tc::cp_async4(dst + r, lse + (ok ? row0 + r : 0), ok);
  }
}

// rows [row0, row0 + kCols) of a pre-rotary bf16 [S, D] slice, rotated in
// fp32 by the tables cs, sn [S, D] (as load_rows_rope) and split into bf16
// hi and lo tiles [kCols][LD]; rows past S are zero
template <int D>
__device__ __forceinline__ void stage_rope(const bf16* src, const float* cs,
                                           const float* sn, int row0, int S,
                                           bf16* hi, bf16* lo) {
  constexpr int LD = Cfg<D>::LD, H = D / 2, H8 = H / 8;
  for (int i = threadIdx.x; i < kCols * H8; i += kThreads) {
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
        a[j] = x1 * ca[j] - x2 * sa[j];
        b[j] = x2 * cb[j] + x1 * sb[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] = b[j] = 0.f;
    }
    uint32_t h[8], l[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      tc::split_bf16x2(a[2 * j], a[2 * j + 1], h[j], l[j]);
      tc::split_bf16x2(b[2 * j], b[2 * j + 1], h[4 + j], l[4 + j]);
    }
    *reinterpret_cast<uint4*>(hi + r * LD + c) = uint4{h[0], h[1], h[2], h[3]};
    *reinterpret_cast<uint4*>(hi + r * LD + c + H) =
        uint4{h[4], h[5], h[6], h[7]};
    *reinterpret_cast<uint4*>(lo + r * LD + c) = uint4{l[0], l[1], l[2], l[3]};
    *reinterpret_cast<uint4*>(lo + r * LD + c + H) =
        uint4{l[4], l[5], l[6], l[7]};
  }
}

// delta[r] = sum_d O[r, d] dO[r, d] in fp32 for the kCols rows of the staged
// bf16 tiles o and dout: two threads a row
template <int D>
__device__ __forceinline__ void row_deltas(const bf16* o, const bf16* dout,
                                           float* delta) {
  constexpr int LD = Cfg<D>::LD;
  const int r = threadIdx.x >> 1, off = r * LD + (threadIdx.x & 1) * (D / 2);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / 2; c += 8) {
    float a[8], b[8];
    load8(o + off + c, a);
    load8(dout + off + c, b);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(a[e], b[e], acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if ((threadIdx.x & 1) == 0) delta[r] = acc;
}

// s[nt] += A B^T over D on the tensor cores: A the 16 rows of the warp at a,
// B the NC rows at b (both staged tiles, row stride LD); s is the 16 x NC
// result in C layout
template <int D, int NC>
__device__ __forceinline__ void dots(const bf16* a, const bf16* b,
                                     float (&s)[NC / 8][4]) {
  constexpr int LD = Cfg<D>::LD;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t af[4];
    tc::ldsm_x4(af, a + (lane & 15) * LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NC / 16; ++np) {
      uint32_t bb[4];
      tc::ldsm_x4(bb, b + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD
                          + ks * 16 + ((lane >> 3) & 1) * 8);
      tc::mma_bf16(s[2 * np], af, bb);
      tc::mma_bf16(s[2 * np + 1], af, bb + 2);
    }
  }
}

// acc (16 x D, C layout) += P X: P the warp's fp32 16 x NC block in C layout
// (the C -> A identity), split into bf16 hi + lo; X the NC rows at xh
// (through ldmatrix.trans). With XLO, X is itself hi + lo (xh, xl) and the
// products are Ph Xh + Pl Xh + Ph Xl.
template <int D, int NC, bool XLO>
__device__ __forceinline__ void mul_x(const float (&pm)[NC / 8][4],
                                      const bf16* xh, const bf16* xl,
                                      float (&acc)[D / 8][4]) {
  constexpr int LD = Cfg<D>::LD;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < NC / 16; ++kk) {
    uint32_t ah[4], al[4];
    tc::split_bf16x2(pm[2 * kk][0], pm[2 * kk][1], ah[0], al[0]);
    tc::split_bf16x2(pm[2 * kk][2], pm[2 * kk][3], ah[1], al[1]);
    tc::split_bf16x2(pm[2 * kk + 1][0], pm[2 * kk + 1][1], ah[2], al[2]);
    tc::split_bf16x2(pm[2 * kk + 1][2], pm[2 * kk + 1][3], ah[3], al[3]);
    const int off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                    + (lane >> 4) * 8;
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bb[4];
      tc::ldsm_x4_trans(bb, xh + off + dp * 16);
      tc::mma_bf16(acc[2 * dp], ah, bb);
      tc::mma_bf16(acc[2 * dp], al, bb);
      tc::mma_bf16(acc[2 * dp + 1], ah, bb + 2);
      tc::mma_bf16(acc[2 * dp + 1], al, bb + 2);
      if constexpr (XLO) {
        tc::ldsm_x4_trans(bb, xl + off + dp * 16);
        tc::mma_bf16(acc[2 * dp], ah, bb);
        tc::mma_bf16(acc[2 * dp + 1], ah, bb + 2);
      }
    }
  }
}

// store the 16 x D accumulator of a warp (C layout) to rows row, row + 8 of
// dst [S, D] in bf16; with ROPE rotate it back first (sin negated): column
// c < D/2 and its partner c + D/2 are both this thread's (n tiles nt and
// nt + D/16)
template <int D, bool ROPE>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 8][4],
                                          const Params& p, int row, bf16* dst) {
  constexpr int NT = D / 8, H = D / 2;
  const int quad = threadIdx.x & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row + 8 * hf;
    if (r >= p.S) continue;
    bf16* out = dst + static_cast<size_t>(r) * D;
    if constexpr (ROPE) {
      const float* cs = p.cs + static_cast<size_t>(r) * D;
      const float* sn = p.sn + static_cast<size_t>(r) * D;
#pragma unroll
      for (int nt = 0; nt < NT / 2; ++nt) {
        const int c = nt * 8 + 2 * quad;
        float ra[2], rb[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = acc[nt][2 * hf + e], b = acc[nt + NT / 2][2 * hf + e];
          ra[e] = a * cs[c + e] + b * sn[c + e];
          rb[e] = b * cs[c + H + e] - a * sn[c + H + e];
        }
        *reinterpret_cast<uint32_t*>(out + c) = tc::pack_bf16x2(ra[0], ra[1]);
        *reinterpret_cast<uint32_t*>(out + c + H) =
            tc::pack_bf16x2(rb[0], rb[1]);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<uint32_t*>(out + nt * 8 + 2 * quad) =
            tc::pack_bf16x2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
    }
  }
}

// shared memory of the three bodies (bf16 tiles [kCols][LD], then fp32
// rows):
//   fwd: q (hi, lo with ROPE); K (hi, lo) and V rings of 2 stages
//   dq:  q (hi, lo), dO, O; K (hi, lo) and V rings of 2 stages; lse and
//        delta of the block's rows
//   dkv: K (hi, lo), V; Q (hi, lo), dO and O rings of 2 stages; lse and
//        delta of each stage's query rows
template <int D, bool ROPE>
constexpr size_t smem_bytes(int which) {
  constexpr int R = ROPE ? 2 : 1;
  const int tiles = which == kFwd  ? R + 2 * R + 2
                    : which == kDq ? R + 2 + 2 * R + 2
                                   : R + 1 + 2 * R + 4;
  const int floats = which == kFwd ? 0 : which == kDq ? 2 * kRows : 4 * kCols;
  return static_cast<size_t>(tiles) * Cfg<D>::TILE * sizeof(bf16)
         + floats * sizeof(float);
}

// forward: one block per (b*h, tile of 64 query rows), 16 rows a warp;
// loops over the key tiles up to the causal bound with FA-2's online
// softmax on the score registers, in the exp2 domain
template <int D, bool ROPE>
__global__ void __launch_bounds__(kThreads) flash_fwd_tc_kernel(Params p) {
  constexpr int LD = Cfg<D>::LD, TILE = Cfg<D>::TILE, NT = Cfg<D>::NT;
  constexpr int NC = Cfg<D>::NC, R = ROPE ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // q (rotated hi, then lo)
  bf16* kb = qs + R * TILE;          // [2 stages][R tiles]
  bf16* vb = kb + 2 * R * TILE;      // [2 stages]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, quad = lane & 3;
  const int S = p.S, bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest first
  const size_t base = static_cast<size_t>(bh) * S * D;
  const bf16* q = static_cast<const bf16*>(p.q) + base;
  const bf16* k = static_cast<const bf16*>(p.k) + base;
  const bf16* v = static_cast<const bf16*>(p.v) + base;
  const int kv_end = p.causal ? min(S, q0 + kRows) : S;
  const int n_tiles = (kv_end + kCols - 1) / kCols;

  if constexpr (ROPE) {
    stage_rope<D>(q, p.cs, p.sn, q0, S, qs, qs + TILE);
    stage_rope<D>(k, p.cs, p.sn, 0, S, kb, kb + TILE);
  } else {
    issue_rows<D>(q, q0, S, qs);
    issue_rows<D>(k, 0, S, kb);
  }
  issue_rows<D>(v, 0, S, vb);
  tc::cp_async_commit();

  const int row = q0 + warp * 16 + grp;  // this thread's rows: row, row + 8
  const int r_lo = q0 + warp * 16;
  const float sl2 = p.scale * kLog2e;
  float m2[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const bf16* qw = qs + warp * 16 * LD;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1, k0 = j * kCols;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile j landed; every reader of tile j - 1 is done
    if (j + 1 < n_tiles) {
      if constexpr (!ROPE) issue_rows<D>(k, k0 + kCols, S, kb + (st ^ 1) * TILE);
      issue_rows<D>(v, k0 + kCols, S, vb + (st ^ 1) * TILE);
    }
    tc::cp_async_commit();
    const bf16* kt = kb + st * R * TILE;
    const bf16* vt = vb + st * TILE;
#pragma unroll 1
    for (int c0 = 0; c0 < kCols; c0 += NC) {
      const int c_lo = k0 + c0;
      if (p.causal && c_lo > r_lo + 15) continue;  // the warp sees no key
      float sc[NC / 8][4];
#pragma unroll
      for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
      dots<D, NC>(qw, kt + c0 * LD, sc);
      if constexpr (ROPE) {
        dots<D, NC>(qw, kt + TILE + c0 * LD, sc);
        dots<D, NC>(qw + TILE, kt + c0 * LD, sc);
      }
      // the online softmax in place: t = s scale log2e, the row max m2
      // over the quad's 4 lanes, p = 2^(t - m2), and the correction
      // 2^(m2_old - m2) on l and the accumulator; only a block of pairs on
      // the causal diagonal or past S (warp-uniform) tests each pair
      auto to_p = [&](auto mask) {
        auto masked = [&](int nt, int e) {
          const int r = row + 8 * (e >> 1), c = c_lo + nt * 8 + 2 * quad
                                                 + (e & 1);
          return !(c < S && (!p.causal || c <= r));
        };
        float mx[2] = {m2[0], m2[1]}, sum[2] = {0.f, 0.f}, corr[2];
#pragma unroll
        for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float t = sc[nt][e] * sl2;
            if constexpr (decltype(mask)::value)
              if (masked(nt, e)) t = kNegInf;
            sc[nt][e] = t;
            mx[e >> 1] = fmaxf(mx[e >> 1], t);
          }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
          mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
          corr[hf] = exp2f(m2[hf] - mx[hf]);
          m2[hf] = mx[hf];
        }
#pragma unroll
        for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pr = exp2f(sc[nt][e] - mx[e >> 1]);
            if constexpr (decltype(mask)::value)
              if (masked(nt, e)) pr = 0.f;
            sc[nt][e] = pr;
            sum[e >> 1] += pr;
          }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 1);
          sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 2);
          l[hf] = l[hf] * corr[hf] + sum[hf];
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] *= corr[e >> 1];
      };
      if ((p.causal && c_lo + NC - 1 > r_lo) || c_lo + NC > S)
        to_p(std::true_type{});
      else
        to_p(std::false_type{});
      mul_x<D, NC, false>(sc, vt + c0 * LD, nullptr, acc);
    }
    if constexpr (ROPE) {
      // stage k tile j + 1 into the other stage, read last in tile j - 1
      if (j + 1 < n_tiles) {
        bf16* kn = kb + (st ^ 1) * R * TILE;
        stage_rope<D>(k, p.cs, p.sn, k0 + kCols, S, kn, kn + TILE);
      }
    }
  }
  tc::cp_async_wait<0>();
  // out = acc / max(l, 1e-30), not rotated back; lse = m2 ln 2 +
  // log(max(l, 1e-30)) from the first lane of each quad
  float den[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) den[hf] = fmaxf(l[hf], 1e-30f);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] /= den[e >> 1];
  store_acc<D, false>(acc, p, row, static_cast<bf16*>(p.res) + base);
  if (quad == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row + 8 * hf;
      if (r < S)
        p.lse[static_cast<size_t>(bh) * S + r] = m2[hf] * kLn2 + logf(den[hf]);
    }
  }
}

// dq: one block per (b*h, tile of 64 query rows), 16 rows a warp; loops over
// the key tiles up to the causal bound
template <int D, bool ROPE>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_tc_kernel(Params p) {
  constexpr int LD = Cfg<D>::LD, TILE = Cfg<D>::TILE, NT = Cfg<D>::NT;
  constexpr int NC = Cfg<D>::NC, R = ROPE ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // q (rotated hi, then lo)
  bf16* dos = qs + R * TILE;
  bf16* os = dos + TILE;
  bf16* kb = os + TILE;           // [2 stages][R tiles]
  bf16* vb = kb + 2 * R * TILE;   // [2 stages]
  float* lse_s = reinterpret_cast<float*>(vb + 2 * TILE);
  float* delta_s = lse_s + kRows;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, quad = lane & 3;
  const int S = p.S, bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest first
  const size_t base = static_cast<size_t>(bh) * S * D;
  const bf16* q = static_cast<const bf16*>(p.q) + base;
  const bf16* k = static_cast<const bf16*>(p.k) + base;
  const bf16* v = static_cast<const bf16*>(p.v) + base;
  const int kv_end = p.causal ? min(S, q0 + kRows) : S;
  const int n_tiles = (kv_end + kCols - 1) / kCols;

  if constexpr (ROPE) {
    stage_rope<D>(q, p.cs, p.sn, q0, S, qs, qs + TILE);
    stage_rope<D>(k, p.cs, p.sn, 0, S, kb, kb + TILE);
  } else {
    issue_rows<D>(q, q0, S, qs);
    issue_rows<D>(k, 0, S, kb);
  }
  issue_rows<D>(static_cast<const bf16*>(p.dout) + base, q0, S, dos);
  issue_rows<D>(static_cast<const bf16*>(p.o) + base, q0, S, os);
  issue_rows<D>(v, 0, S, vb);
  issue_lse(p.lse + static_cast<size_t>(bh) * S, q0, S, lse_s);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  row_deltas<D>(os, dos, delta_s);
  __syncthreads();

  const int row = q0 + warp * 16 + grp;  // this thread's rows: row, row + 8
  const float sl2 = p.scale * kLog2e;
  float lse2_r[2], delta_r[2], dq[NT][4];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    lse2_r[hf] = lse_s[warp * 16 + grp + 8 * hf] * kLog2e;
    delta_r[hf] = delta_s[warp * 16 + grp + 8 * hf];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;
  const bf16* qw = qs + warp * 16 * LD;
  const bf16* dow = dos + warp * 16 * LD;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1, k0 = j * kCols;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile j landed; every reader of tile j - 1 is done
    if (j + 1 < n_tiles) {
      if constexpr (!ROPE) issue_rows<D>(k, k0 + kCols, S, kb + (st ^ 1) * TILE);
      issue_rows<D>(v, k0 + kCols, S, vb + (st ^ 1) * TILE);
    }
    tc::cp_async_commit();
    const bf16* kt = kb + st * R * TILE;
    const bf16* vt = vb + st * TILE;
#pragma unroll 1
    for (int c0 = 0; c0 < kCols; c0 += NC) {
      float sc[NC / 8][4], dp[NC / 8][4];
#pragma unroll
      for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
      dots<D, NC>(qw, kt + c0 * LD, sc);
      if constexpr (ROPE) {
        dots<D, NC>(qw, kt + TILE + c0 * LD, sc);
        dots<D, NC>(qw + TILE, kt + c0 * LD, sc);
      }
      dots<D, NC>(dow, vt + c0 * LD, dp);
      // dS = p (dP - delta) scale in place; only a block of pairs on the
      // causal diagonal or past S (warp-uniform) tests each pair
      const int r_lo = q0 + warp * 16, c_lo = k0 + c0;
      auto to_ds = [&](auto mask) {
#pragma unroll
        for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hf = e >> 1;
            float pr = exp2f(fmaf(sc[nt][e], sl2, -lse2_r[hf]));
            if constexpr (decltype(mask)::value) {
              const int r = row + 8 * hf, c = c_lo + nt * 8 + 2 * quad + (e & 1);
              if (!(r < S && c < S && (!p.causal || c <= r))) pr = 0.f;
            }
            sc[nt][e] = pr * (dp[nt][e] - delta_r[hf]) * p.scale;
          }
      };
      if ((p.causal && c_lo + NC - 1 > r_lo) || c_lo + NC > S || r_lo + 16 > S)
        to_ds(std::true_type{});
      else
        to_ds(std::false_type{});
      mul_x<D, NC, ROPE>(sc, kt + c0 * LD, kt + TILE + c0 * LD, dq);
    }
    if constexpr (ROPE) {
      // stage k tile j + 1 into the other stage, read last in tile j - 1
      if (j + 1 < n_tiles) {
        bf16* kn = kb + (st ^ 1) * R * TILE;
        stage_rope<D>(k, p.cs, p.sn, k0 + kCols, S, kn, kn + TILE);
      }
    }
  }
  tc::cp_async_wait<0>();
  store_acc<D, ROPE>(dq, p, row, static_cast<bf16*>(p.res) + base);
}

// dk, dv: one block per (b*h, tile of 64 keys), 16 keys a warp; loops over
// the query tiles that see the keys. With keys as the rows, S^T = K Q^T and
// dP^T = V dO^T leave P^T and dS^T in the A layout of dV += P^T dO and
// dK += dS^T Q.
template <int D, bool ROPE>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_tc_kernel(Params p) {
  constexpr int LD = Cfg<D>::LD, TILE = Cfg<D>::TILE, NT = Cfg<D>::NT;
  constexpr int NC = Cfg<D>::NC, R = ROPE ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // k (rotated hi, then lo)
  bf16* vs = ks + R * TILE;
  bf16* qb = vs + TILE;           // [2 stages][R tiles]
  bf16* dob = qb + 2 * R * TILE;  // [2 stages]
  bf16* ob = dob + 2 * TILE;      // [2 stages]
  float* lse_s = reinterpret_cast<float*>(ob + 2 * TILE);  // [2][kCols]
  float* delta_s = lse_s + 2 * kCols;                      // [2][kCols]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, quad = lane & 3;
  const int S = p.S, bh = blockIdx.y, k0 = blockIdx.x * kRows;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const bf16* q = static_cast<const bf16*>(p.q) + base;
  const bf16* k = static_cast<const bf16*>(p.k) + base;
  const bf16* dout = static_cast<const bf16*>(p.dout) + base;
  const bf16* o = static_cast<const bf16*>(p.o) + base;
  const float* lse = p.lse + static_cast<size_t>(bh) * S;
  const int q_first = p.causal ? k0 : 0;  // the first query tile that sees k0
  const int n_tiles = (S - q_first + kCols - 1) / kCols;

  auto issue = [&](int j, int st) {  // query tile j into stage st
    const int q0 = q_first + j * kCols;
    if constexpr (!ROPE) issue_rows<D>(q, q0, S, qb + st * TILE);
    issue_rows<D>(dout, q0, S, dob + st * TILE);
    issue_rows<D>(o, q0, S, ob + st * TILE);
    issue_lse(lse, q0, S, lse_s + st * kCols);
  };
  if constexpr (ROPE) {
    stage_rope<D>(k, p.cs, p.sn, k0, S, ks, ks + TILE);
    stage_rope<D>(q, p.cs, p.sn, q_first, S, qb, qb + TILE);
  } else {
    issue_rows<D>(k, k0, S, ks);
  }
  issue_rows<D>(static_cast<const bf16*>(p.v) + base, k0, S, vs);
  issue(0, 0);
  tc::cp_async_commit();

  const int key = k0 + warp * 16 + grp;  // this thread's keys: key, key + 8
  const float sl2 = p.scale * kLog2e;
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;
  const bf16* kw = ks + warp * 16 * LD;
  const bf16* vw = vs + warp * 16 * LD;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1, q0 = q_first + j * kCols;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile j landed; every reader of tile j - 1 is done
    if (j + 1 < n_tiles) issue(j + 1, st ^ 1);
    tc::cp_async_commit();
    const bf16* qt = qb + st * R * TILE;
    const bf16* dot = dob + st * TILE;
    const float* lse_t = lse_s + st * kCols;
    const float* delta_t = delta_s + st * kCols;
    row_deltas<D>(ob + st * TILE, dot, delta_s + st * kCols);
    __syncthreads();  // the tile's deltas are written
#pragma unroll 1
    for (int c0 = 0; c0 < kCols; c0 += NC) {
      float sc[NC / 8][4], dp[NC / 8][4];  // S^T, dP^T: 16 keys x NC queries
#pragma unroll
      for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
      dots<D, NC>(kw, qt + c0 * LD, sc);
      if constexpr (ROPE) {
        dots<D, NC>(kw, qt + TILE + c0 * LD, sc);
        dots<D, NC>(kw + TILE, qt + c0 * LD, sc);
      }
      dots<D, NC>(vw, dot + c0 * LD, dp);
      // P^T and dS^T in place; only a block of pairs on the causal
      // diagonal or past S (warp-uniform) tests each pair
      const int c_lo = k0 + warp * 16, r_lo = q0 + c0;
      auto to_p = [&](auto mask) {
#pragma unroll
        for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + nt * 8 + 2 * quad + (e & 1);
            float pr = exp2f(fmaf(sc[nt][e], sl2, -lse_t[col] * kLog2e));
            if constexpr (decltype(mask)::value) {
              const int c = key + 8 * (e >> 1), r = q0 + col;
              if (!(r < S && c < S && (!p.causal || c <= r))) pr = 0.f;
            }
            sc[nt][e] = pr;
            dp[nt][e] = pr * (dp[nt][e] - delta_t[col]) * p.scale;
          }
      };
      if ((p.causal && c_lo + 15 > r_lo) || r_lo + NC > S || c_lo + 16 > S)
        to_p(std::true_type{});
      else
        to_p(std::false_type{});
      mul_x<D, NC, false>(sc, dot + c0 * LD, nullptr, dv);
      mul_x<D, NC, ROPE>(dp, qt + c0 * LD, qt + TILE + c0 * LD, dk);
    }
    if constexpr (ROPE) {
      // stage q tile j + 1 into the other stage, read last in tile j - 1
      if (j + 1 < n_tiles) {
        bf16* qn = qb + (st ^ 1) * R * TILE;
        stage_rope<D>(q, p.cs, p.sn, q0 + kCols, S, qn, qn + TILE);
      }
    }
  }
  tc::cp_async_wait<0>();
  store_acc<D, false>(dv, p, key, static_cast<bf16*>(p.res2) + base);
  store_acc<D, ROPE>(dk, p, key, static_cast<bf16*>(p.res) + base);
}

template <int D, bool ROPE>
cudaError_t launch(int which, const Params& p, int BH, cudaStream_t stream) {
  void (*kern)(Params) = which == kFwd  ? flash_fwd_tc_kernel<D, ROPE>
                         : which == kDq ? flash_bwd_dq_tc_kernel<D, ROPE>
                                        : flash_bwd_dkv_tc_kernel<D, ROPE>;
  const size_t smem = smem_bytes<D, ROPE>(which);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((p.S + kRows - 1) / kRows, BH);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool ROPE>
cudaError_t dispatch_dim(int which, int D, const Params& p, int BH,
                         cudaStream_t s) {
  switch (D) {
    case 32: return tcr::launch<32, ROPE>(which, p, BH, s);
    case 64: return tcr::launch<64, ROPE>(which, p, BH, s);
    case 128: return tcr::launch<128, ROPE>(which, p, BH, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace tcr

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

// the CUDA-core bodies, which take fp32 only (bf16 takes tcr)
template <int D, bool ROPE>
cudaError_t launch(int which, const Params& p, int BH, cudaStream_t stream) {
  void (*kern)(Params) = which == kFwd  ? flash_fwd_kernel<D, float, ROPE>
                         : which == kDq ? flash_bwd_dq_kernel<D, float, ROPE>
                                        : flash_bwd_dkv_kernel<D, float, ROPE>;
  const size_t smem = smem_bytes<D>(which);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((p.S + kTile - 1) / kTile, BH);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool ROPE>
cudaError_t dispatch_dim(int which, int D, const Params& p, int BH,
                         cudaStream_t s) {
  switch (D) {
    case 32: return launch<32, ROPE>(which, p, BH, s);
    case 64: return launch<64, ROPE>(which, p, BH, s);
    case 128: return launch<128, ROPE>(which, p, BH, s);
  }
  return cudaErrorInvalidValue;
}

// tensor_core: the bf16 tensor-core body (tcr), which bf16 calls of every
// kernel must take; else the CUDA-core body, which takes fp32 only
template <bool ROPE>
int run(int which, int dtype, int D, const Params& p, int BH, int tensor_core,
        void* stream) {
  if (BH == 0 || p.S == 0) return cudaSuccess;
  if (BH > 65535) return cudaErrorInvalidValue;  // grid y limit
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != (tensor_core ? kBF16 : kF32)) return cudaErrorInvalidValue;
  return tensor_core ? tcr::dispatch_dim<ROPE>(which, D, p, BH, s)
                     : dispatch_dim<ROPE>(which, D, p, BH, s);
}

}  // namespace

extern "C" {

// q, k, v, out [BH, S, D]; lse [BH, S] fp32; with rope, cos and sin [S, D]
// fp32 after the other pointers, and q, k pre-rotary. Every entry takes
// tensor_core: 1 for the bf16 tensor-core body (bf16 inputs only), 0 for
// the CUDA-core body (fp32 inputs only). Each function returns
// cudaGetLastError() after its launch (0 = success).

// dynamic shared memory of a tensor-core body (which: 0 fwd, 1 dq, 2 dkv)
long flash_attention_tc_smem_bytes(int which, int D, int rope) {
  if (which != kFwd && which != kDq && which != kDkv) return -1;
  switch (D) {
    case 32: return rope ? tcr::smem_bytes<32, true>(which)
                         : tcr::smem_bytes<32, false>(which);
    case 64: return rope ? tcr::smem_bytes<64, true>(which)
                         : tcr::smem_bytes<64, false>(which);
    case 128: return rope ? tcr::smem_bytes<128, true>(which)
                          : tcr::smem_bytes<128, false>(which);
  }
  return -1;
}

int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* out, void* lse, int BH, int S, int D,
                               int dtype, float scale, int causal,
                               int tensor_core, void* stream) {
  Params p{q, k, v, nullptr, nullptr, static_cast<float*>(lse), out, nullptr,
           nullptr, nullptr, S, scale, causal};
  return run<false>(kFwd, dtype, D, p, BH, tensor_core, stream);
}

int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* dq, int BH, int S,
                                  int D, int dtype, float scale, int causal,
                                  int tensor_core, void* stream) {
  Params p{q, k, v, o, dout,
           const_cast<float*>(static_cast<const float*>(lse)), dq, nullptr,
           nullptr, nullptr, S, scale, causal};
  return run<false>(kDq, dtype, D, p, BH, tensor_core, stream);
}

int flash_attention_bwd_dkv_launch(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dk, void* dv, int BH, int S, int D,
                                   int dtype, float scale, int causal,
                                   int tensor_core, void* stream) {
  Params p{q, k, v, o, dout,
           const_cast<float*>(static_cast<const float*>(lse)), dk, dv,
           nullptr, nullptr, S, scale, causal};
  return run<false>(kDkv, dtype, D, p, BH, tensor_core, stream);
}

int flash_attention_rope_fwd_launch(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    const void* cs, const void* sn, int BH,
                                    int S, int D, int dtype, float scale,
                                    int causal, int tensor_core,
                                    void* stream) {
  Params p{q, k, v, nullptr, nullptr, static_cast<float*>(lse), out, nullptr,
           static_cast<const float*>(cs), static_cast<const float*>(sn), S,
           scale, causal};
  return run<true>(kFwd, dtype, D, p, BH, tensor_core, stream);
}

int flash_attention_rope_bwd_dq_launch(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, const void* lse,
                                       void* dq, const void* cs,
                                       const void* sn, int BH, int S, int D,
                                       int dtype, float scale, int causal,
                                       int tensor_core, void* stream) {
  Params p{q, k, v, o, dout,
           const_cast<float*>(static_cast<const float*>(lse)), dq, nullptr,
           static_cast<const float*>(cs), static_cast<const float*>(sn), S,
           scale, causal};
  return run<true>(kDq, dtype, D, p, BH, tensor_core, stream);
}

int flash_attention_rope_bwd_dkv_launch(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const void* lse,
                                        void* dk, void* dv, const void* cs,
                                        const void* sn, int BH, int S, int D,
                                        int dtype, float scale, int causal,
                                        int tensor_core, void* stream) {
  Params p{q, k, v, o, dout,
           const_cast<float*>(static_cast<const float*>(lse)), dk, dv,
           static_cast<const float*>(cs), static_cast<const float*>(sn), S,
           scale, causal};
  return run<true>(kDkv, dtype, D, p, BH, tensor_core, stream);
}

}  // extern "C"
