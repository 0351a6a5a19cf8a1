// Shared pieces of the two stage-recursion kernels (lhs.cu, rhs.cu).
//
// Both kernels take the generator stack A_k (k = 0..m-1) and the step
// (dt on the device, or by value, and a sign) and multiply each element by
// its step scale s^(k+1), s = sign*dt, once: the same single f32 rounding
// as scaling the stack beforehand (qgd_tpu/ops/pallas_step.py
// _scaled_stack), without writing a scaled copy. The scales are powf of
// the f32 base, as torch.pow computes them on the card, so the wrapper
// launches nothing besides the kernels.

#pragma once

#include <cuda_runtime.h>

namespace hermite {

constexpr int kMaxLevels = 16;           // largest m (order 32)
constexpr int kMaxSharedBytes = 232448;  // dynamic shared memory of a block
// Returned by an entry point for a shape none of its kernels takes.
constexpr int kShapeRefused = -1;

struct Coeffs {
  float c[kMaxLevels + 1];
};

inline Coeffs make_coeffs(const float* host, int m) {
  Coeffs c{};
  for (int j = 0; j <= m; ++j) c.c[j] = host[j];
  return c;
}

__host__ __device__ inline int round_up(int x, int to) {
  return (x + to - 1) / to * to;
}

// s = sign * dt, f32 (dt read from the device when a pointer is given)
__device__ __forceinline__ float step_base(const float* dt_dev,
                                           float dt_value, float sign) {
  return sign * (dt_dev != nullptr ? *dt_dev : dt_value);
}

// the scale of stack level k: s^(k+1)
__device__ __forceinline__ float step_scale(float s, int k) {
  return powf(s, static_cast<float>(k + 1));
}

// 16-byte asynchronous global -> shared copy; .cg keeps it out of L1.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

// The same copy with zero fill: src_bytes (0 or 16) of it are read, the
// rest of the 16 bytes are written as zeros (a masked edge).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 int src_bytes) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

// One float, asynchronously, zero when src_bytes is 0 (operands whose
// rows are not 16-byte aligned).
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                int src_bytes) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

// Ask for `bytes` (a multiple of 16, from a 16-byte aligned address) to be
// brought into L2, without waiting: one instruction for a whole block of
// rows, so every byte of it is requested at once.
__device__ __forceinline__ void prefetch_l2(const void* gmem,
                                            unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(gmem),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` (0..3) of this thread's committed copy
// groups are still in flight; the count must be an immediate, and a larger
// one waits for all.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 3:
      asm volatile("cp.async.wait_group 3;\n" ::: "memory");
      break;
    case 2:
      asm volatile("cp.async.wait_group 2;\n" ::: "memory");
      break;
    case 1:
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      break;
    default:
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

__device__ __forceinline__ void scale4(float4* p, float scale) {
  float4 v = *p;
  v.x *= scale;
  v.y *= scale;
  v.z *= scale;
  v.w *= scale;
  *p = v;
}

// Let `fn` use the block maximum of dynamic shared memory and prefer
// shared memory over L1, once per device (`done` holds one bit per
// device).
inline cudaError_t allow_full_smem(const void* fn, unsigned* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSharedBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err == cudaSuccess) *done |= bit;
  return err;
}

}  // namespace hermite
