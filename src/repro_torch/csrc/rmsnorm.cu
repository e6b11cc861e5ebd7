// Fused RMSNorm: y = x * rsqrt(mean(x^2) + eps) * scale, mean square in
// float32, y in x's type; and its backward (dx, dscale), further down.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (pallas_call at :38,
// body _rmsnorm_kernel at :20).
//
// Bound on the H100: memory. Each row is read once and written once
// (2 * rows * d * sizeof(T) bytes, plus the d-float scale); the arithmetic
// is ~3 flops per element. At the serve shape (2048 x 2048 bf16) that is
// ~16.8 MB, ~5 us at 3.35 TB/s.
//
// Design (rmsnorm_warp_kernel): one warp per row, eight rows per block.
// Each lane loads its share of the row with 16-byte loads (8 at d = 2048
// bf16, 16 at d = 4096), all issued first and held in registers, so x is
// read from device memory once. While they are in flight the block stages
// the float32 scale in shared memory with float4 loads (one
// __syncthreads), and every row of the block reuses it. The warp reduces
// the float32 sum of squares with shuffles alone, then scales the
// registers and writes 16-byte stores. Widths the warp kernel does not
// take (d other than 32·NP packs of 16 bytes with NP in {1, 2, 4, 8, 16},
// or unaligned pointers) go to rmsnorm_kernel: one block per row, a
// strided scalar loop that reads the row twice.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): at
// the serve shape about 0.005 ms on the device, at its bound, with the
// 16.8 MB partly in the 50 MB L2 across back-to-back calls.
#include "common.cuh"

namespace {

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// any width and alignment: one block per row, a strided loop that reads
// the row twice
template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                               T* __restrict__ out, int64_t d, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = out + row * d;

  float ss = 0.f;
  for (int64_t i = threadIdx.x; i < d; i += blockDim.x) {
    const float f = rt::to_f(xr[i]);
    ss += f * f;
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
  for (int64_t i = threadIdx.x; i < d; i += blockDim.x)
    yr[i] = rt::from_f<T>(rt::to_f(xr[i]) * r * scale[i]);
}

constexpr int WARP_ROWS = 8;  // rows (warps) per block

// NP: 16-byte packs a lane holds in registers, d = 32 * NP * VEC
template <typename T, int VEC, int NP>
__global__ void __launch_bounds__(32 * WARP_ROWS)
    rmsnorm_warp_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        T* __restrict__ out, long long rows, float eps) {
  constexpr int D = 32 * NP * VEC;
  __shared__ float4 s_scale[D / 4];
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARP_ROWS + (threadIdx.x >> 5);
  const bool live = row < rows;
  const Pack<T, VEC>* xr = reinterpret_cast<const Pack<T, VEC>*>(x + row * D);

  // the row's loads go out first; the scale is staged while they are in flight
  Pack<T, VEC> p[NP];
  if (live) {
#pragma unroll
    for (int j = 0; j < NP; ++j) p[j] = xr[j * 32 + lane];
  }
  for (int i = threadIdx.x; i < D / 4; i += blockDim.x)
    s_scale[i] = reinterpret_cast<const float4*>(scale)[i];
  __syncthreads();
  if (!live) return;

  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = rt::to_f(p[j].v[e]);
      ss += f * f;
    }
  }
  const float r = rsqrtf(rt::warp_sum(ss) * (1.f / D) + eps);
  Pack<T, VEC>* yr = reinterpret_cast<Pack<T, VEC>*>(out + row * D);
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int c4 = (j * 32 + lane) * (VEC / 4);  // first float4 of this pack's scale
    Pack<T, VEC> q;
#pragma unroll
    for (int e4 = 0; e4 < VEC / 4; ++e4) {
      const float4 sc = s_scale[c4 + e4];
      q.v[4 * e4 + 0] = rt::from_f<T>(rt::to_f(p[j].v[4 * e4 + 0]) * r * sc.x);
      q.v[4 * e4 + 1] = rt::from_f<T>(rt::to_f(p[j].v[4 * e4 + 1]) * r * sc.y);
      q.v[4 * e4 + 2] = rt::from_f<T>(rt::to_f(p[j].v[4 * e4 + 2]) * r * sc.z);
      q.v[4 * e4 + 3] = rt::from_f<T>(rt::to_f(p[j].v[4 * e4 + 3]) * r * sc.w);
    }
    yr[j * 32 + lane] = q;
  }
}

// the warp kernel for d = 32 * NP * VEC with NP in {1, 2, 4, 8, 16};
// returns false for any other d
template <typename T, int VEC>
bool launch_warp(const void* x, const void* scale, void* out, long long rows, long long d,
                 float eps, cudaStream_t stream) {
  const long long blocks = (rows + WARP_ROWS - 1) / WARP_ROWS;
  const T* xt = static_cast<const T*>(x);
  const float* sc = static_cast<const float*>(scale);
  T* ot = static_cast<T*>(out);
  if (d % (32 * VEC) != 0) return false;
  switch (d / (32 * VEC)) {
#define RT_RMSNORM_WARP(NP)                                                                   \
  case NP:                                                                                    \
    rmsnorm_warp_kernel<T, VEC, NP><<<(unsigned)blocks, 32 * WARP_ROWS, 0, stream>>>(xt, sc, ot, \
                                                                                  rows, eps); \
    return true;
    RT_RMSNORM_WARP(1)
    RT_RMSNORM_WARP(2)
    RT_RMSNORM_WARP(4)
    RT_RMSNORM_WARP(8)
    RT_RMSNORM_WARP(16)
#undef RT_RMSNORM_WARP
    default: return false;
  }
}

template <typename T>
void launch(const void* x, const void* scale, void* out, long long rows, long long d, float eps,
            cudaStream_t stream) {
  int threads = (int)(((d + 31) / 32) * 32);
  if (threads > 256) threads = 256;
  rmsnorm_kernel<T><<<(unsigned)rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<T*>(out), d, eps);
}

// ---------------------------------------------------------------------------
// Backward (no Pallas counterpart: the reference differentiates its jnp
// norm with jax.grad). With r = rsqrt(mean(x^2) + eps) and g = dy * scale:
//   dx     = r * g - x * r^3 * mean(g * x)
//   dscale = sum over rows of dy * x * r
// Bound on the H100: memory. x and dy are read and dx written once
// (3 * rows * d * sizeof(T) bytes) plus the partials below; ~10 flops per
// element. At gemma-2b's training shape (2048 x 2048 bf16) that is ~25 MB,
// ~7.5 us at 3.35 TB/s.
//
// Design: one block of 256 threads per run of rows_per_block consecutive
// rows. Per row the block reduces sum(x^2) and sum(g * x) in float32 (warp
// shuffles, then every thread adds the eight warp sums in the same order),
// writes dx, and adds dy * x * r into its dscale partial: a float32 row of
// d values in shared memory, each column owned by one thread, so no two
// threads ever add into the same place. The block writes its partial row
// to `part` (blocks x d); a second kernel sums each column over the blocks
// in block order. No atomics anywhere: dscale comes out bit-identical from
// run to run, which the fault-tolerant trainer's bit-identical final state
// needs.
// ---------------------------------------------------------------------------

constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_MAX_D = 16384;  // the partial row: 64 KB of shared memory

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                       long long rows, int d, int rows_per_block, float eps) {
  extern __shared__ float s_part[];  // [d]: this block's dscale partial
  __shared__ float red[2][BWD_WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < d; c += BWD_THREADS) s_part[c] = 0.f;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  for (long long row = r0; row < r1; ++row) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    float ss = 0.f, sg = 0.f;
    for (int c = tid; c < d; c += BWD_THREADS) {
      const float xv = rt::to_f(xr[c]);
      ss += xv * xv;
      sg += rt::to_f(gr[c]) * scale[c] * xv;
    }
    ss = rt::warp_sum(ss);
    sg = rt::warp_sum(sg);
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = sg;
    }
    __syncthreads();
    float tss = 0.f, tsg = 0.f;
#pragma unroll
    for (int w = 0; w < BWD_WARPS; ++w) {
      tss += red[0][w];
      tsg += red[1][w];
    }
    __syncthreads();  // red is written again for the next row
    const float r = rsqrtf(tss / (float)d + eps);
    const float coef = r * r * r * (tsg / (float)d);
    T* dxr = dx + row * d;
    for (int c = tid; c < d; c += BWD_THREADS) {
      const float xv = rt::to_f(xr[c]);
      const float gv = rt::to_f(gr[c]);
      dxr[c] = rt::from_f<T>(r * gv * scale[c] - xv * coef);
      s_part[c] += gv * xv * r;
    }
  }
  float* pr = part + (long long)blockIdx.x * d;
  for (int c = tid; c < d; c += BWD_THREADS) pr[c] = s_part[c];
}

// dscale[c] = sum over b of part[b][c], b in order
__global__ void rmsnorm_dscale_kernel(const float* __restrict__ part, float* __restrict__ dscale,
                                      int blocks, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[(long long)b * d + c];
  dscale[c] = s;
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx, void* part,
               void* dscale, long long rows, int d, int blocks, int rows_per_block, float eps,
               cudaStream_t stream) {
  const int smem = d * (int)sizeof(float);
  if (smem > 48 * 1024) {
    static int smem_set[rt::kMaxDevices];
    const cudaError_t attr = rt::max_dynamic_smem(
        reinterpret_cast<const void*>(rmsnorm_bwd_kernel<T>), BWD_MAX_D * (int)sizeof(float),
        smem_set);
    if (attr != cudaSuccess) return (int)attr;
  }
  rmsnorm_bwd_kernel<T><<<blocks, BWD_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(part), rows, d, rows_per_block, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rmsnorm_dscale_kernel<<<(d + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dscale), blocks, d);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx: (rows, d) contiguous of one dtype; scale, dscale: (d,) float32;
// part: (blocks, d) float32 scratch. Block b handles rows
// [b * rows_per_block, (b + 1) * rows_per_block); the wrapper picks both so
// that they cover every row.
extern "C" int rt_rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                              void* part, void* dscale, long long rows, int d, int blocks,
                              int rows_per_block, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0 || d > BWD_MAX_D || blocks <= 0 || rows_per_block <= 0 ||
      (long long)blocks * rows_per_block < rows)
    return (int)cudaErrorInvalidValue;
  if (dtype == rt::kF32)
    return launch_bwd<float>(x, scale, dy, dx, part, dscale, rows, d, blocks, rows_per_block,
                             eps, s);
  if (dtype == rt::kBF16)
    return launch_bwd<__nv_bfloat16>(x, scale, dy, dx, part, dscale, rows, d, blocks,
                                     rows_per_block, eps, s);
  return (int)cudaErrorInvalidValue;
}

// vectorized != 0 requires d % (16 / sizeof(T)) == 0 and 16-byte aligned
// x, scale and out; the Python wrapper checks that before asking for it.
extern "C" int rt_rmsnorm(const void* x, const void* scale, void* out, long long rows,
                          long long d, float eps, int dtype, int vectorized, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || rows > 2147483647LL || d <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == rt::kF32) {
    if (!(vectorized && launch_warp<float, 4>(x, scale, out, rows, d, eps, s)))
      launch<float>(x, scale, out, rows, d, eps, s);
  } else if (dtype == rt::kBF16) {
    if (!(vectorized && launch_warp<__nv_bfloat16, 8>(x, scale, out, rows, d, eps, s)))
      launch<__nv_bfloat16>(x, scale, out, rows, d, eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
