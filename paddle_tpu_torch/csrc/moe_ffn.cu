// MoE expert FFN (SwiGLU) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of paddle_tpu/ops/pallas/moe_ffn.py:
//   moe_ffn_kernel <- _ffn_kernel (_ffn_fwd_arrays, pallas_call :72)
//
// What it computes, per expert e, on dispatched tokens x [E, C, h] (bf16 or
// fp32) with Wg, Wu [E, h, I] and Wd [E, I, h] in the same dtype:
//   g = x Wg, u = x Wu          (fp32 products of the upcast inputs)
//   act = silu(g) * u           (fp32)
//   out = act Wd                (fp32 sum over all of I, rounded to x's dtype)
// without writing the [E, C, I] intermediates to device memory.
//
// Design. The TPU kernel accumulates `out` across I tiles because its grid
// runs in order; CUDA blocks run in no order, so the I loop is inside the
// block. One block of 256 threads takes one (expert, tile of 32 tokens) and
// keeps that tile's fp32 output accumulator [32, h] in shared memory for the
// whole loop (96 KB at h = 768, above the 48 KB default, so the launch sets
// cudaFuncAttributeMaxDynamicSharedMemorySize). For each tile of 64
// intermediate columns it
//   A. forms g and u [32, 64] in registers (each thread 8 rows x 1 column
//      of each) from 32-deep slices of x, Wg and Wu staged in shared memory;
//   B. writes act = silu(g) u to shared memory in fp32, transposed, and adds
//      act Wd to the accumulator: each thread owns whole output columns
//      (c = tid, tid + 256, ...), holds the 32 rows of one column in
//      registers and streams that column of Wd from device memory.
// No two threads write one accumulator element, so there are no atomics and
// the result repeats bit for bit. A ragged last token tile and a ragged last
// I tile are zero-filled and masked.
//
// Bound on an H100 at the Llama-MoE training shape (E 8, C 5120, h 768,
// I 2048, bf16): 3 x 2 E C h I = 386.5 GFLOP, 0.391 ms at the 989 TFLOP/s
// bf16 tensor-core peak (the bytes, 201 MB, take 0.060 ms), so it is bound
// by operations. This first version multiplies in fp32 on the CUDA cores
// (67 TFLOP/s peak), so it takes tens of ms; bf16 tensor-core products for
// g and u (exact in fp32 accumulation) are the next step. Each block reads
// all of its expert's weights once from L2 (3 h I elements).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBC = 32;        // tokens per block
constexpr int kBI = 64;        // intermediate columns per tile
constexpr int kKC = 32;        // depth of a staged slice of x / Wg / Wu
constexpr int kXLD = kKC + 4;  // row stride of the staged x slice
constexpr int kALD = kBC + 4;  // row stride of the transposed act tile

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at hidden size h.
long moe_ffn_smem_bytes(int h) {
  return static_cast<long>(smem_floats(h) * sizeof(float));
}

// x, out [E, C, h]; gw, uw [E, h, I]; dw [E, I, h]; dtype 0 fp32, 1 bf16.
// Returns cudaGetLastError() after the launch (0 = success).
int moe_ffn_launch(const void* x, const void* gw, const void* uw,
                   const void* dw, void* out, int E, int C, int h, int I,
                   int dtype, void* stream) {
  if (E == 0 || C == 0 || h == 0) return cudaSuccess;
  if (E > 65535 || I <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(x, gw, uw, dw, out, E, C, h, I, s);
    case kBF16:
      return launch<__nv_bfloat16>(x, gw, uw, dw, out, E, C, h, I, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
