// Fused RMSNorm: y = x * rsqrt(mean(x^2) + eps) * scale, mean square in
// float32, y in x's type.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (pallas_call at :38,
// body _rmsnorm_kernel at :20).
//
// Bound on the H100: memory. Each row is read once and written once
// (2 * rows * d * sizeof(T) bytes, plus the d-float scale); the arithmetic
// is ~3 flops per element. At the serve shape (2048 x 2048 bf16) that is
// ~16.8 MB, ~5 us at 3.35 TB/s.
//
// Design: one block per row. Each thread loads 16 bytes at a time
// (4 floats or 8 bf16) when the row allows it, accumulates its share of
// the sum of squares in float32, and the block reduces with warp shuffles
// and one shared-memory step. The second pass re-reads the row (it is in
// L1/L2 by then) and writes the scaled result with 16-byte stores.
#include "common.cuh"

namespace {

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                               T* __restrict__ out, int64_t d, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = out + row * d;
  const int64_t step = (int64_t)blockDim.x * VEC;

  float ss = 0.f;
  for (int64_t i = (int64_t)threadIdx.x * VEC; i < d; i += step) {
    Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float f = rt::to_f(p.v[j]);
      ss += f * f;
    }
  }

  __shared__ float warp_part[32];
  __shared__ float inv_rms;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  ss = rt::warp_sum(ss);
  if (lane == 0) warp_part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    float t = lane < nwarps ? warp_part[lane] : 0.f;
    t = rt::warp_sum(t);
    if (lane == 0) inv_rms = rsqrtf(t / (float)d + eps);
  }
  __syncthreads();
  const float r = inv_rms;

  for (int64_t i = (int64_t)threadIdx.x * VEC; i < d; i += step) {
    Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
    Pack<T, VEC> q;
#pragma unroll
    for (int j = 0; j < VEC; ++j) q.v[j] = rt::from_f<T>(rt::to_f(p.v[j]) * r * scale[i + j]);
    *reinterpret_cast<Pack<T, VEC>*>(yr + i) = q;
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* scale, void* out, long long rows, long long d, float eps,
            cudaStream_t stream) {
  long long per_thread_units = (d + VEC - 1) / VEC;
  int threads = (int)(((per_thread_units + 31) / 32) * 32);
  if (threads > 256) threads = 256;
  if (threads < 32) threads = 32;
  rmsnorm_kernel<T, VEC><<<(unsigned)rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<T*>(out), d, eps);
}

}  // namespace

// vectorized != 0 requires d % (16 / sizeof(T)) == 0 and 16-byte aligned
// x and out; the Python wrapper checks that before asking for it.
extern "C" int rt_rmsnorm(const void* x, const void* scale, void* out, long long rows,
                          long long d, float eps, int dtype, int vectorized, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || rows > 2147483647LL || d <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == rt::kF32) {
    if (vectorized) launch<float, 4>(x, scale, out, rows, d, eps, s);
    else launch<float, 1>(x, scale, out, rows, d, eps, s);
  } else if (dtype == rt::kBF16) {
    if (vectorized) launch<__nv_bfloat16, 8>(x, scale, out, rows, d, eps, s);
    else launch<__nv_bfloat16, 1>(x, scale, out, rows, d, eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
