// MoE expert FFN (SwiGLU) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of paddle_tpu/ops/pallas/moe_ffn.py:
//   _ffn_kernel (_ffn_fwd_arrays, pallas_call :72), in two bodies chosen by
//   dtype alone (the wrapper passes the dtype; nothing falls back):
//   moe_ffn_bf16_kernel  bf16 x and weights: tensor cores (mma.sync);
//   moe_ffn_kernel       fp32 x and weights: fp32 CUDA-core products.
//
// What it computes, per expert e, on dispatched tokens x [E, C, h] with
// Wg, Wu [E, h, I] and Wd [E, I, h] in x's dtype:
//   g = x Wg, u = x Wu          (fp32 sums of the exact products)
//   act = silu(g) * u           (fp32)
//   out = act Wd                (fp32 sum over all of I, rounded to x's dtype)
// without writing the [E, C, I] intermediates to device memory.
//
// Bound on an H100 at the Llama-MoE training shape (E 8, C 5120, h 768,
// I 2048, bf16): 3 x 2 E C h I = 386.5 GFLOP, 0.391 ms at the 989 TFLOP/s
// bf16 tensor-core peak (the bytes, 201 MB, take 0.060 ms): bound by
// operations.
//
// bf16 body. A cluster of two blocks (256 threads each, 8 warps as 2 token
// rows x 4 column groups) takes one (expert, tile of 64 tokens, 768 output
// columns). The I loop runs inside the cluster in tiles of 128 columns; per
// tile
//   A. each block forms g and u for its 64 of the 128 columns on the tensor
//      cores (bf16 x bf16 is exact in the fp32 accumulator: the same
//      function up to summation order), from 192-deep chunks of x, Wg, Wu;
//   B. act = silu(g) u in fp32 is split into bf16 hi = bf16(act) and
//      lo = bf16(act - hi) (hi + lo is act to ~2^-16 relative, far inside
//      the 2^-8 output tolerance) and written to both blocks' shared memory
//      (the peer's through the cluster's distributed shared memory); a
//      cluster barrier publishes it;
//   C. each block adds hi Wd + lo Wd for its 384 output columns, from
//      64-row chunks of Wd, into an fp32 accumulator [64 x 384] that stays
//      in registers for the whole I loop (96 a thread).
// Chunks of x / Wg / Wu and of Wd flow through one ring of 2 shared-memory
// stages filled by cp.async (zero-filled past C, h and I) and are read into
// fragments by ldmatrix; rows are padded to an odd multiple of 16 bytes so
// ldmatrix hits no bank twice. Nothing is widened to fp32 in shared memory.
// No element is written by two threads and nothing uses atomics: the result
// repeats bit for bit. The split costs 4/3 of the counted operations.
// Traffic through L2 per call: each cluster reads its expert's weights once
// (3 h I bf16) and its x tile once per I tile, so E * ceil(C / 64) *
// ceil(h / 768) * (3 h I + 2 * ceil(I / 128) * 64 h) * 2 bytes: 8.05 GB at
// the training shape (6.04 GB of weights), half of what a 32-token tile
// without the cluster pulls. Shared memory 196,608 bytes a block. Few,
// large chunks matter more than ring depth: each chunk costs a barrier and
// a refill of the fragment pipeline, so an I tile takes 6 chunks. h and I
// that are not multiples of 8 (rows not 16-byte aligned) are staged by
// plain loads instead of cp.async, into the same ring.
//
// fp32 body (the first port, kept for fp32 inputs). One block of 256
// threads takes one (expert, tile of 32 tokens) and keeps that tile's fp32
// output accumulator [32, h] in shared memory; per tile of 64 intermediate
// columns it forms g and u in registers from 32-deep slices staged as fp32,
// writes act transposed to shared memory and adds act Wd, each thread
// owning whole output columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

// The launch tally, kept on the device: thread 0 of block (0, 0, 0) of
// each body's kernel adds one a launch (a graph replay's too), so the host
// can read how many times each body really ran, a count independent of
// the wrapper's own (moe_ffn_tally). Slot 0 the fp32 body, 1 the bf16 one.
__device__ unsigned long long g_tally[2];

__device__ __forceinline__ void tally(int body) {
  if ((blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x) == 0)
    atomicAdd(&g_tally[body], 1ull);
}

constexpr int kThreads = 256;
constexpr int kBC = 32;        // tokens per block
constexpr int kBI = 64;        // intermediate columns per tile
constexpr int kKC = 32;        // depth of a staged slice of x / Wg / Wu
constexpr int kXLD = kKC + 4;  // row stride of the staged x slice
constexpr int kALD = kBC + 4;  // row stride of the transposed act tile

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ __align__(16) float smem_[];
  return smem_;
}

size_t smem_floats(int h) {
  return static_cast<size_t>(kBC) * h     // output accumulator
         + kBC * kXLD                     // x slice
         + 2 * kKC * kBI                  // Wg and Wu slices
         + kBI * kALD;                    // act, transposed
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_ffn_kernel(const T* __restrict__ x, const T* __restrict__ gw,
                   const T* __restrict__ uw, const T* __restrict__ dw,
                   T* __restrict__ out, int C, int h, int I) {
  float* accs = dyn_smem();             // [kBC][h]
  float* xs = accs + kBC * h;           // [kBC][kXLD]
  float* gws = xs + kBC * kXLD;         // [kKC][kBI]
  float* uws = gws + kKC * kBI;         // [kKC][kBI]
  float* acts = uws + kKC * kBI;        // [kBI][kALD]: act[r][j] at j*kALD + r
  const int tid = threadIdx.x;
  const int e = blockIdx.y, c0 = blockIdx.x * kBC;
  const T* xe = x + (static_cast<size_t>(e) * C + c0) * h;
  const T* gwe = gw + static_cast<size_t>(e) * h * I;
  const T* uwe = uw + static_cast<size_t>(e) * h * I;
  const T* dwe = dw + static_cast<size_t>(e) * I * h;
  const int rows = min(kBC, C - c0);
  tally(0);

  for (int c = tid; c < h; c += kThreads)
#pragma unroll
    for (int r = 0; r < kBC; ++r) accs[r * h + c] = 0.f;

  const int j = tid % kBI;          // phase A: the column of the I tile
  const int r0 = (tid / kBI) * 8;   // ... and the first of its 8 rows
  for (int i0 = 0; i0 < I; i0 += kBI) {
    float g[8], u[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) g[m] = u[m] = 0.f;
    for (int k0 = 0; k0 < h; k0 += kKC) {
      __syncthreads();  // the previous slice (and act tile) readers are done
      for (int i = tid; i < kBC * kKC; i += kThreads) {
        const int r = i / kKC, kk = i % kKC;
        xs[r * kXLD + kk] = (r < rows && k0 + kk < h)
                                ? to_f32(xe[static_cast<size_t>(r) * h + k0 + kk])
                                : 0.f;
      }
      for (int i = tid; i < kKC * kBI; i += kThreads) {
        const int kk = i / kBI, jj = i % kBI;
        const bool ok = k0 + kk < h && i0 + jj < I;
        const size_t at = static_cast<size_t>(k0 + kk) * I + i0 + jj;
        gws[i] = ok ? to_f32(gwe[at]) : 0.f;
        uws[i] = ok ? to_f32(uwe[at]) : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < kKC; kk += 4) {
        float gv[4], uv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          gv[q] = gws[(kk + q) * kBI + j];
          uv[q] = uws[(kk + q) * kBI + j];
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + (r0 + m) * kXLD + kk);
          g[m] = fmaf(xv.x, gv[0], g[m]);
          g[m] = fmaf(xv.y, gv[1], g[m]);
          g[m] = fmaf(xv.z, gv[2], g[m]);
          g[m] = fmaf(xv.w, gv[3], g[m]);
          u[m] = fmaf(xv.x, uv[0], u[m]);
          u[m] = fmaf(xv.y, uv[1], u[m]);
          u[m] = fmaf(xv.z, uv[2], u[m]);
          u[m] = fmaf(xv.w, uv[3], u[m]);
        }
      }
    }
    // act = silu(g) * u; a masked column (i0 + j >= I) has g = u = 0 -> 0
#pragma unroll
    for (int m = 0; m < 8; ++m)
      acts[j * kALD + r0 + m] = g[m] / (1.f + expf(-g[m])) * u[m];
    __syncthreads();

    // B. accs[r][c] += sum_k act[r][k] * Wd[i0 + k][c]
    const int kn = min(kBI, I - i0);
    for (int c = tid; c < h; c += kThreads) {
      float acc[kBC];
#pragma unroll
      for (int r = 0; r < kBC; ++r) acc[r] = accs[r * h + c];
      const T* wcol = dwe + static_cast<size_t>(i0) * h + c;
#pragma unroll 4
      for (int k = 0; k < kn; ++k) {
        const float w = to_f32(wcol[static_cast<size_t>(k) * h]);
        const float* a = acts + k * kALD;
#pragma unroll
        for (int r = 0; r < kBC; r += 4) {
          const float4 av = *reinterpret_cast<const float4*>(a + r);
          acc[r] = fmaf(av.x, w, acc[r]);
          acc[r + 1] = fmaf(av.y, w, acc[r + 1]);
          acc[r + 2] = fmaf(av.z, w, acc[r + 2]);
          acc[r + 3] = fmaf(av.w, w, acc[r + 3]);
        }
      }
#pragma unroll
      for (int r = 0; r < kBC; ++r) accs[r * h + c] = acc[r];
    }
  }

  // every accumulator element was last written by the thread that stores it
  T* oe = out + (static_cast<size_t>(e) * C + c0) * h;
  for (int c = tid; c < h; c += kThreads)
    for (int r = 0; r < rows; ++r)
      store1(oe + static_cast<size_t>(r) * h + c, accs[r * h + c]);
}

template <typename T>
cudaError_t launch(const void* x, const void* gw, const void* uw,
                   const void* dw, void* out, int E, int C, int h, int I,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(h) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      moe_ffn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((C + kBC - 1) / kBC, E);
  moe_ffn_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gw),
      static_cast<const T*>(uw), static_cast<const T*>(dw),
      static_cast<T*>(out), C, h, I);
  return cudaGetLastError();
}

// -- bf16 body: tensor cores ------------------------------------------------

namespace tcr {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // 8 warps: 2 token rows x 4 column groups
constexpr int kBM = 64;         // tokens per cluster (both blocks)
constexpr int kBI = 128;        // intermediate columns per I tile (cluster)
constexpr int kBIc = 64;        // ... of which one block forms g and u
constexpr int kHC = 384;        // output columns per block
constexpr int kKC = 192;        // depth of an x / Wg / Wu chunk
constexpr int kKD = 64;         // rows of a Wd chunk
constexpr int kStages = 2;      // cp.async ring depth
// row strides in elements: odd multiples of 16 bytes (conflict-free ldmatrix)
constexpr int kXLD = kKC + 8;
constexpr int kWLD = kBIc + 8;
constexpr int kDLD = kHC + 8;
constexpr int kALD = kBI + 8;
constexpr int kGUElems = kBM * kXLD + 2 * kKC * kWLD;
constexpr int kDElems = kKD * kDLD;
constexpr int kStageElems = kGUElems > kDElems ? kGUElems : kDElems;
constexpr int kActElems = kBM * kALD;  // one of act hi / act lo
constexpr size_t kSmemBytes =
    (static_cast<size_t>(kStages) * kStageElems + 2 * kActElems)
    * sizeof(bf16);

// 8 consecutive bf16 from src to shared dst; element j is real when
// `row_ok` and j < avail, else zero. kAligned: src is 16-byte aligned and
// avail a multiple of 8, so one cp.async (or its zero fill) does it.
template <bool kAligned>
__device__ __forceinline__ void stage8(bf16* dst, const bf16* src,
                                       bool row_ok, int avail,
                                       const void* safe) {
  if (kAligned) {
    const bool ok = row_ok && avail > 0;
    tc::cp_async16(dst, ok ? static_cast<const void*>(src) : safe, ok);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[j] = (row_ok && j < avail) ? src[j] : __float2bfloat16(0.f);
  }
}

template <bool kAligned>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
    moe_ffn_bf16_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ gw,
                        const bf16* __restrict__ uw,
                        const bf16* __restrict__ dw, bf16* __restrict__ out,
                        int C, int h, int I) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* act_hi = ring + kStages * kStageElems;  // [kBM][kALD]
  bf16* act_lo = act_hi + kActElems;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  const int grp = lane >> 2, quad = lane & 3;
  const uint32_t rank = tc::cluster_rank();
  const int hc0 = (blockIdx.x >> 1) * (2 * kHC) + rank * kHC;
  const int c0 = blockIdx.y * kBM, e = blockIdx.z;
  const int rows = min(kBM, C - c0);
  tally(1);
  const bf16* xe = x + (static_cast<size_t>(e) * C + c0) * h;
  const bf16* gwe = gw + static_cast<size_t>(e) * h * I;
  const bf16* uwe = uw + static_cast<size_t>(e) * h * I;
  const bf16* dwe = dw + static_cast<size_t>(e) * I * h;
  const int n_kc = (h + kKC - 1) / kKC;       // g/u chunks per I tile
  const int per_it = n_kc + kBI / kKD;        // + Wd chunks
  const int total = ((I + kBI - 1) / kBI) * per_it;

  // chunk n of the stream: I tile n / per_it; x/Wg/Wu or Wd by n % per_it
  auto load_chunk = [&](int n) {
    bf16* st = ring + (n % kStages) * kStageElems;
    const int sub = n % per_it, i0 = (n / per_it) * kBI;
    if (sub < n_kc) {
      const int k0 = sub * kKC, ic = i0 + rank * kBIc;
      for (int v = tid; v < kBM * (kKC / 8); v += kThreads) {
        const int r = v / (kKC / 8), cc = (v % (kKC / 8)) * 8;
        stage8<kAligned>(st + r * kXLD + cc,
                         xe + static_cast<size_t>(r) * h + k0 + cc,
                         r < rows, h - k0 - cc, x);
      }
      bf16* gs = st + kBM * kXLD;
      bf16* us = gs + kKC * kWLD;
      for (int v = tid; v < kKC * (kBIc / 8); v += kThreads) {
        const int kr = v / (kBIc / 8), cc = (v % (kBIc / 8)) * 8;
        const size_t at = static_cast<size_t>(k0 + kr) * I + ic + cc;
        stage8<kAligned>(gs + kr * kWLD + cc, gwe + at, k0 + kr < h,
                         I - ic - cc, x);
        stage8<kAligned>(us + kr * kWLD + cc, uwe + at, k0 + kr < h,
                         I - ic - cc, x);
      }
    } else {
      const int i1 = i0 + (sub - n_kc) * kKD;
      for (int v = tid; v < kKD * (kHC / 8); v += kThreads) {
        const int kr = v / (kHC / 8), cc = (v % (kHC / 8)) * 8;
        stage8<kAligned>(st + kr * kDLD + cc,
                         dwe + static_cast<size_t>(i1 + kr) * h + hc0 + cc,
                         i1 + kr < I, h - hc0 - cc, x);
      }
    }
  };

  float acc[2][12][4];   // out [64 x 384]: warp rows wr*32.., cols wc*96..
  float g[2][2][4], u[2][2][4];  // [64 x 64] of g and u: cols wc*16..
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 12; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_chunk(s);
    tc::cp_async_commit();
  }
  // the peer writes into this block's act tile only once this block runs
  tc::cluster_arrive();

  for (int n = 0; n < total; ++n) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk n landed; every reader of chunk n - 1 is done
    if (n + kStages - 1 < total) load_chunk(n + kStages - 1);
    tc::cp_async_commit();
    const bf16* st = ring + (n % kStages) * kStageElems;
    const int sub = n % per_it;
    if (sub < n_kc) {
      // A. g, u += x Wg, x Wu over this chunk
      if (sub == 0) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int q = 0; q < 4; ++q) g[mi][ni][q] = u[mi][ni][q] = 0.f;
      }
      const bf16* xs = st;
      const bf16* gs = st + kBM * kXLD;
      const bf16* us = gs + kKC * kWLD;
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        uint32_t a[2][4], bg[4], bu[4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          tc::ldsm_x4(a[mi], xs + (wr * 32 + mi * 16 + (lane & 15)) * kXLD
                                 + kk + (lane >> 4) * 8);
        const int kr = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int cc = wc * 16 + (lane >> 4) * 8;
        tc::ldsm_x4_trans(bg, gs + kr * kWLD + cc);
        tc::ldsm_x4_trans(bu, us + kr * kWLD + cc);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) {
            tc::mma_bf16(g[mi][ni], a[mi], bg + 2 * ni);
            tc::mma_bf16(u[mi][ni], a[mi], bu + 2 * ni);
          }
      }
      if (sub == n_kc - 1) {
        // B. act = silu(g) u, split into hi + lo, into both blocks' tiles
        tc::cluster_wait();  // the peer runs and is done with the last act
        const uint32_t peer = rank ^ 1u;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int r = wr * 32 + mi * 16 + grp + 8 * hf;
              const int c = rank * kBIc + wc * 16 + ni * 8 + 2 * quad;
              const float g0 = g[mi][ni][2 * hf], g1 = g[mi][ni][2 * hf + 1];
              const float a0 = g0 / (1.f + expf(-g0)) * u[mi][ni][2 * hf];
              const float a1 =
                  g1 / (1.f + expf(-g1)) * u[mi][ni][2 * hf + 1];
              uint32_t hi, lo;
              tc::split_bf16x2(a0, a1, hi, lo);
              bf16* ph = act_hi + r * kALD + c;
              bf16* pl = act_lo + r * kALD + c;
              *reinterpret_cast<uint32_t*>(ph) = hi;
              *reinterpret_cast<uint32_t*>(pl) = lo;
              tc::st_cluster_u32(ph, peer, hi);
              tc::st_cluster_u32(pl, peer, lo);
            }
        tc::cluster_arrive();
        tc::cluster_wait();  // both halves of act are in both blocks
      }
    } else {
      // C. out += act_hi Wd + act_lo Wd over this chunk of Wd
      const int kb = (sub - n_kc) * kKD;
#pragma unroll
      for (int kk = 0; kk < kKD; kk += 16) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int off = (wr * 32 + mi * 16 + (lane & 15)) * kALD + kb + kk
                          + (lane >> 4) * 8;
          tc::ldsm_x4(ah[mi], act_hi + off);
          tc::ldsm_x4(al[mi], act_lo + off);
        }
        const int kr = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int np = 0; np < 6; ++np) {
          uint32_t b[4];
          tc::ldsm_x4_trans(b, st + kr * kDLD + wc * 96 + np * 16
                                   + (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              tc::mma_bf16(acc[mi][2 * np + hf], ah[mi], b + 2 * hf);
              tc::mma_bf16(acc[mi][2 * np + hf], al[mi], b + 2 * hf);
            }
        }
      }
      if (sub == per_it - 1) tc::cluster_arrive();  // done reading act
    }
  }
  tc::cluster_wait();

  bf16* oe = out + (static_cast<size_t>(e) * C + c0) * h;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 12; ++ni)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = wr * 32 + mi * 16 + grp + 8 * hf;
        const int col = hc0 + wc * 96 + ni * 8 + 2 * quad;
        if (r >= rows) continue;
        bf16* o = oe + static_cast<size_t>(r) * h + col;
        if (col < h) o[0] = __float2bfloat16(acc[mi][ni][2 * hf]);
        if (col + 1 < h) o[1] = __float2bfloat16(acc[mi][ni][2 * hf + 1]);
      }
}

cudaError_t launch(const void* x, const void* gw, const void* uw,
                   const void* dw, void* out, int E, int C, int h, int I,
                   cudaStream_t stream) {
  const bool aligned = h % 8 == 0 && I % 8 == 0;
  void (*kern)(const bf16*, const bf16*, const bf16*, const bf16*, bf16*,
               int, int, int) = aligned ? moe_ffn_bf16_kernel<true>
                                        : moe_ffn_bf16_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(2 * ((h + 2 * kHC - 1) / (2 * kHC)), (C + kBM - 1) / kBM,
                  E);
  kern<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gw),
      static_cast<const bf16*>(uw), static_cast<const bf16*>(dw),
      static_cast<bf16*>(out), C, h, I);
  return cudaGetLastError();
}

}  // namespace tcr

}  // namespace

extern "C" {

// Copy the launch tally (fp32 body, bf16 body) into out[2]; with reset,
// zero it after. Synchronous: call it with the device idle. Returns the
// cudaError (0 = success).
int moe_ffn_tally(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_tally, sizeof(g_tally));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[2] = {0, 0};
    e = cudaMemcpyToSymbol(g_tally, zero, sizeof(zero));
  }
  return static_cast<int>(e);
}

// Dynamic shared memory one block needs at hidden size h for dtype
// (0 fp32, 1 bf16).
long moe_ffn_smem_bytes(int h, int dtype) {
  if (dtype == kBF16) return static_cast<long>(tcr::kSmemBytes);
  return static_cast<long>(smem_floats(h) * sizeof(float));
}

// x, out [E, C, h]; gw, uw [E, h, I]; dw [E, I, h]; dtype 0 fp32 (the
// CUDA-core body), 1 bf16 (the tensor-core body).
// Returns cudaGetLastError() after the launch (0 = success).
int moe_ffn_launch(const void* x, const void* gw, const void* uw,
                   const void* dw, void* out, int E, int C, int h, int I,
                   int dtype, void* stream) {
  if (E == 0 || C == 0 || h == 0) return cudaSuccess;
  if (E > 65535 || I <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(x, gw, uw, dw, out, E, C, h, I, s);
    case kBF16: return tcr::launch(x, gw, uw, dw, out, E, C, h, I, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
