// Shared helpers for the repro_torch CUDA kernels (sm_90a).
//
// Every kernel reads float32 or bfloat16 tensors, computes in float32 and
// writes the input's type. The C entry points take raw pointers, element
// strides and a cudaStream_t from the Python wrapper (ctypes), launch on
// that stream without synchronising, and return cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A 16-byte copy of which src_bytes (16, or 0 for a row of zeros) are read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Devices a kernel's per-device launch settings are kept for.
constexpr int kMaxDevices = 64;

// Sets a kernel attribute on the current device, the first time a launch
// site runs there (attributes are per device). `site` is that launch
// site's own table, one entry per device: 0 until set, then the
// cudaError_t + 1.
inline cudaError_t func_attribute(const void* kernel, cudaFuncAttribute attr, int value,
                                  int (&site)[kMaxDevices]) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaFuncSetAttribute(kernel, attr, value);
  if (site[dev] == 0) site[dev] = 1 + (int)cudaFuncSetAttribute(kernel, attr, value);
  return (cudaError_t)(site[dev] - 1);
}

// Raises a kernel's dynamic shared memory limit to `bytes` (see
// func_attribute).
inline cudaError_t max_dynamic_smem(const void* kernel, int bytes, int (&site)[kMaxDevices]) {
  return func_attribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes, site);
}

// Running max before any valid score has been seen (the Pallas kernels'
// NEG_INF). Masked scores never enter a sum: their weight is set to 0.
constexpr float kNegInit = -1.0e30f;

}  // namespace rt
