// Tensor-core building blocks for Hopper (sm_90a), shared by the port's bf16
// kernels (moe_ffn.cu, paged_attention.cu, flash_attention.cu). Every PTX instruction the
// kernels use beyond plain CUDA sits behind one inline function here, so a
// host emulation can supply a twin of each.
//
// mma.sync.m16n8k16 with bf16 inputs and fp32 accumulation. Fragment layouts
// (lane = 4 * group + quad):
//   A, 16 x 16 row-major, 4 registers of bf16x2 (the lower column in the
//      low half): a0 (row group, cols 2 quad, +1), a1 (row group + 8, same
//      cols), a2 (row group, cols 2 quad + 8, +9), a3 (row group + 8, same);
//   B, 16 x 8 (k x n), 2 registers: b0 (k 2 quad, +1; n group),
//      b1 (k 2 quad + 8, +9; n group);
//   C and D, 16 x 8 fp32, 4 registers: c0, c1 (row group, cols 2 quad, +1),
//      c2, c3 (row group + 8, same cols).
// Two C tiles side by side (columns 0-7 and 8-15) are, value for value, the
// A fragment of the 16 x 16 tile they form: a0 = (c0, c1) of the first,
// a1 = (c2, c3) of the first, a2 and a3 the same of the second. That lets a
// product computed in registers feed the next product without shared
// memory (pack_bf16x2 / split_bf16x2 below).
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 give the
// row addresses of matrix i, and register i of lane l receives row l / 4,
// columns 2 (l % 4), +1 of matrix i (with .trans: column l / 4, rows
// 2 (l % 4), +1). Rows are 16 bytes and must be 16-byte aligned.
//
// griddepcontrol (programmatic dependent launch) lets a kernel launched
// with cudaLaunchAttributeProgrammaticStreamSerialization become resident
// before the kernel ahead of it in the stream ends, and wait for it there.
//
// cp.async.cg copies 16 bytes from device to shared memory without passing
// through registers (cp.async.ca 8 or 4 bytes, for rows that are not
// 16-byte aligned); a source size of 0 fills the destination with zeros.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b  (16 x 16 bf16 times 16 x 8 bf16, fp32 accumulator)
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// 16 bytes from src (device memory) to dst (shared memory); with full false
// nothing is read and dst is zero-filled (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// 8 bytes, likewise (src and dst 8-byte aligned)
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(full ? 8 : 0)
               : "memory");
}

// 4 bytes, likewise (src and dst 4-byte aligned)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two fp32 values rounded to bf16x2, `lo_col` in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the fp32 -> bf16 hi + lo split of two values: hi = bf16(v),
// lo = bf16(v - hi); hi + lo equals v to about 2^-16 of |v|
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// -- programmatic dependent launch --------------------------------------------

// let the next kernel of the stream (launched with programmatic stream
// serialization) start launching: its blocks may become resident early
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// wait until the preceding kernel of the stream has completed and its
// writes are visible
__device__ __forceinline__ void wait_on_prerequisite() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// -- thread block clusters ---------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// arrive at / wait on the cluster barrier (release / acquire at cluster
// scope); every thread of every block of the cluster takes part
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// store v at the address of `local` (this block's shared memory) in the
// shared memory of the cluster's block `rank`
__device__ __forceinline__ void st_cluster_u32(void* local, uint32_t rank,
                                               uint32_t v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(remote), "r"(v)
               : "memory");
}

}  // namespace tc
