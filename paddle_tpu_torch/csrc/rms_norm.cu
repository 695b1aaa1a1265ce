// Fused residual add + RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of paddle_tpu/ops/pallas/rms_norm.py:
//   fused_add_rms_norm_kernel <- _fwd_kernel (_fwd, pallas_call :66)
//
// What it computes, on rows of x, y [rows, h] (bf16 or fp32) and w [h]:
//   resid = round(x + y)               the fp32 sum rounded to the dtype
//   out   = resid * rsqrt(mean(resid^2) + eps) * w
// with the norm reading the *rounded* residual (as the unfused composition
// does) and the weight multiply in fp32 before the final rounding. Both
// resid and out are written.
//
// Design. One warp per row, up to 8 rows per block of 256 threads: lanes
// stride the row, so each warp-wide load and store covers consecutive
// elements. The first pass forms the rounded residual, writes it, keeps its
// fp32 value in the warp's slice of shared memory and sums its squares; a
// shuffle reduction gives the row's mean; the second pass reads the slice
// back and writes out. x and y are read once and resid and out written
// once, so the kernel moves the bytes its function needs and no more.
//
// Bound on an H100 at the Llama-MoE training shape (16384 x 768 bf16):
// 4 x 25.2 MB + 1.5 KB = 100.7 MB, 0.030 ms at 3.35 TB/s; it is bound by
// bytes (a few operations per element).

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

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* w, void* out,
                   void* resid, int rows, int h, float eps,
                   cudaStream_t stream) {
  // as many rows per block as fit 48 KB of row cache, 1 to 8
  int rpb = 49152 / (h * static_cast<int>(sizeof(float)));
  rpb = rpb < 1 ? 1 : (rpb > kWarps ? kWarps : rpb);
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

}  // extern "C"
