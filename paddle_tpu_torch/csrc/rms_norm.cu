// Fused residual add + RMSNorm, and fused residual add + LayerNorm, for
// Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of paddle_tpu/ops/pallas/rms_norm.py:
//   fused_add_rms_norm_kernel   <- _fwd_kernel    (_fwd, pallas_call :66)
//   fused_add_layer_norm_kernel <- _ln_fwd_kernel (_ln_fwd, pallas_call :155)
//
// What they compute, on rows of x, y [rows, h] (bf16 or fp32) and w, b [h]:
//   resid = round(x + y)               the fp32 sum rounded to the dtype
//   RMSNorm:   out = resid * rsqrt(mean(resid^2) + eps) * w
//   LayerNorm: mu  = mean(resid), var = mean((resid - mu)^2)
//              out = (resid - mu) * rsqrt(var + eps) * w + b
// with the norm reading the *rounded* residual (as the unfused composition
// does), the LayerNorm variance taken in a second pass over the deviations
// (never as E[r^2] - mu^2, which cancels), and the weight multiply and bias
// add in fp32 before the one final rounding. Both resid and out are
// written.
//
// Design. One warp per row, up to 8 rows per block of 256 threads: lanes
// stride the row, so each warp-wide load and store covers consecutive
// elements. The first pass forms the rounded residual, writes it and keeps
// its fp32 value in the warp's slice of shared memory; shuffle reductions
// give the row's statistics (RMSNorm: the sum of squares, in the same
// pass; LayerNorm: the sum, then the sum of squared deviations in a second
// pass over the slice); the last pass reads the slice back and writes out.
// Each lane only ever reads back the elements it wrote, so no barrier is
// needed. x and y are read once and resid and out written once, so the
// kernels move the bytes their function needs and no more.
//
// Bound on an H100 at 16384 x 768 bf16 (the Llama-MoE and BERT-base
// training shapes): 4 x 25.2 MB + 1.5 KB (w) or 3 KB (w and b) = 100.7 MB,
// 0.030 ms at 3.35 TB/s; both are bound by bytes (a few operations per
// element).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T, and the rounded value back in fp32
__device__ __forceinline__ float round_to(float x, float* p) {
  *p = x;
  return x;
}
__device__ __forceinline__ float round_to(float x, __nv_bfloat16* p) {
  const __nv_bfloat16 r = __float2bfloat16(x);
  *p = r;
  return __bfloat162float(r);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_add_rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ y,
                              const T* __restrict__ w, T* __restrict__ out,
                              T* __restrict__ resid, int rows, int h,
                              int rows_per_block, float eps) {
  extern __shared__ float cache_[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= rows_per_block) return;
  const int row = blockIdx.x * rows_per_block + warp;
  if (row >= rows) return;
  float* cache = cache_ + static_cast<size_t>(warp) * h;
  const size_t base = static_cast<size_t>(row) * h;
  float ss = 0.f;
  for (int c = lane; c < h; c += 32) {
    const float r =
        round_to(to_f32(x[base + c]) + to_f32(y[base + c]), resid + base + c);
    cache[c] = r;
    ss += r * r;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / static_cast<float>(h) + eps);
  // each lane reads back only the elements it wrote
  for (int c = lane; c < h; c += 32)
    store1(out + base + c, cache[c] * inv * to_f32(w[c]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_add_layer_norm_kernel(const T* __restrict__ x,
                                const T* __restrict__ y,
                                const T* __restrict__ w,
                                const T* __restrict__ b, T* __restrict__ out,
                                T* __restrict__ resid, int rows, int h,
                                int rows_per_block, float eps) {
  extern __shared__ float cache_[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= rows_per_block) return;
  const int row = blockIdx.x * rows_per_block + warp;
  if (row >= rows) return;
  float* cache = cache_ + static_cast<size_t>(warp) * h;
  const size_t base = static_cast<size_t>(row) * h;
  const float hf = static_cast<float>(h);
  float sum = 0.f;
  for (int c = lane; c < h; c += 32) {
    const float r =
        round_to(to_f32(x[base + c]) + to_f32(y[base + c]), resid + base + c);
    cache[c] = r;
    sum += r;
  }
  const float mu = warp_sum(sum) / hf;
  float ss = 0.f;
  for (int c = lane; c < h; c += 32) {
    const float d = cache[c] - mu;
    ss += d * d;
  }
  const float inv = rsqrtf(warp_sum(ss) / hf + eps);
  for (int c = lane; c < h; c += 32)
    store1(out + base + c,
           (cache[c] - mu) * inv * to_f32(w[c]) + to_f32(b[c]));
}

// as many rows per block as fit 48 KB of fp32 row cache, 1 to 8
inline int rows_per_block(int h) {
  const int rpb = 49152 / (h * static_cast<int>(sizeof(float)));
  return rpb < 1 ? 1 : (rpb > kWarps ? kWarps : rpb);
}

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* w, void* out,
                   void* resid, int rows, int h, float eps,
                   cudaStream_t stream) {
  const int rpb = rows_per_block(h);
  const size_t smem = static_cast<size_t>(rpb) * h * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_add_rms_norm_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (rows + rpb - 1) / rpb;
  fused_add_rms_norm_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(w), static_cast<T*>(out), static_cast<T*>(resid),
      rows, h, rpb, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ln(const void* x, const void* y, const void* w,
                      const void* b, void* out, void* resid, int rows, int h,
                      float eps, cudaStream_t stream) {
  const int rpb = rows_per_block(h);
  const size_t smem = static_cast<size_t>(rpb) * h * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_add_layer_norm_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (rows + rpb - 1) / rpb;
  fused_add_layer_norm_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(out), static_cast<T*>(resid), rows, h, rpb, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y, out, resid [rows, h]; w [h]; dtype 0 fp32, 1 bf16. Returns
// cudaGetLastError() after the launch (0 = success).
int fused_add_rms_norm_launch(const void* x, const void* y, const void* w,
                              void* out, void* resid, int rows, int h,
                              int dtype, float eps, void* stream) {
  if (rows == 0 || h == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(x, y, w, out, resid, rows, h, eps, s);
    case kBF16:
      return launch<__nv_bfloat16>(x, y, w, out, resid, rows, h, eps, s);
  }
  return cudaErrorInvalidValue;
}

// x, y, out, resid [rows, h]; w, b [h]; dtype 0 fp32, 1 bf16. Returns
// cudaGetLastError() after the launch (0 = success).
int fused_add_layer_norm_launch(const void* x, const void* y, const void* w,
                                const void* b, void* out, void* resid,
                                int rows, int h, int dtype, float eps,
                                void* stream) {
  if (rows == 0 || h == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_ln<float>(x, y, w, b, out, resid, rows, h, eps, s);
    case kBF16:
      return launch_ln<__nv_bfloat16>(x, y, w, b, out, resid, rows, h, eps,
                                      s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
