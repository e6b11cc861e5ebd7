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
// (3 * rows * d * sizeof(T) bytes, plus scale and dscale); ~10 flops per
// element. At gemma-2b's training shape (2048 x 2048) that is 25.2 MB in
// bf16, 7.5 us at 3.35 TB/s, and 50.4 MB, 15.0 us, in float32.
//
// Design (rmsnorm_bwd_warp_kernel): a lane holds at most 16 elements of x
// and 16 of dy (2 packs of 16 bytes in bf16, 4 in float32), so a warp
// covers at most 512 columns and a row is held by `split` warps (4 at d
// 2048, 8 at 4096); a block runs `slots` such rows side by side (slots * d
// ~ 4096 elements, at most 8 warps). Each lane loads its packs of x and dy
// with 16-byte loads, all issued first and held in registers, so x and dy
// are read from device memory once. The float32 scale is staged in shared
// memory once per block with float4 loads. From the registers the warp
// reduces sum(x^2) and sum(g * x) by shuffles alone; the row's warps then
// meet behind one named barrier of theirs, their sums added in warp order
// through shared memory. It writes dx with 16-byte stores and adds
// dy * x * r into float32 accumulators of its own columns, kept in
// registers across the slot's rows. No block barrier per row. Few
// registers a lane (16 of x, 16 of dy, 16 sums) keep a block small; a lane
// of 32 elements (one warp a row at d 1024) measured slower
// (tools/rmsnorm_bwd_compare.py --variant "lane 32").
//
// Order of the dscale sums, fixed by the partition alone (`rows_per_block`
// and `slots`, computed in Python from (rows, d): kernels/rmsnorm.py::
// bwd_plan), never by the card: block b owns rows [b * rows_per_block,
// (b + 1) * rows_per_block), its slot s the rows b * rows_per_block + s +
// k * slots for k = 0, 1, ...; a column's accumulator adds those rows in k
// order; the block adds its slots' sums in slot order (through shared
// memory) into one partial row of `part`; rmsnorm_dscale_kernel adds the
// partial rows in block order within 8 runs of consecutive blocks (run
// length ceil(blocks / 8)), then the 8 runs' sums in run order. No
// atomics: dscale is bit-identical from run to run, which the
// fault-tolerant trainer's bit-identical final state needs, and
// tests/test_torch_rmsnorm_bwd.py emulates the order on the CPU. At most
// 264 blocks (two a streaming multiprocessor of the H100: one wave), so at
// most 264 partial rows.
//
// Widths the warp kernel does not take (rows that are not a multiple of
// 512 bytes or need more than 8 warps, e.g. d 100 or 8192 in bf16; or
// unaligned pointers; the wrapper checks) go to rmsnorm_bwd_kernel: 256
// threads over the block's rows one after another, scalar loads, each row
// read twice, two block barriers a row, the partial row in shared memory;
// the same partition and second pass.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): at
// (2048, 2048) 0.0104 ms on the device in bf16 (the warp kernel 0.0080,
// the second pass 0.0018) and 0.0217 ms in float32, against bounds of
// 0.0075 and 0.0150 ms; PyTorch's F.rms_norm backward took 0.0141 and
// 0.0280 ms in the same run.
// ---------------------------------------------------------------------------

constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_MAX_D = 16384;  // the block route's partial row: 64 KB of shared memory

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

constexpr int BWD_LANE_ELEMS = 16;   // most elements of x (and of dy) a lane holds
constexpr int BWD_MAX_WARPS = 8;     // warps a block of the warp kernel
constexpr int BWD_SLOT_ELEMS = 4096; // most slots * d with slots > 1 (the block's sums)

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A lane's packs of one row of x and dy: 16-byte loads, all issued first.
template <typename T, int VEC, int NP>
__device__ __forceinline__ void load_row(Pack<T, VEC> (&xp)[NP], Pack<T, VEC> (&gp)[NP],
                                         const T* xr, const T* gr, int lane) {
  using P = Pack<T, VEC>;
#pragma unroll
  for (int j = 0; j < NP; ++j) xp[j] = reinterpret_cast<const P*>(xr)[j * 32 + lane];
#pragma unroll
  for (int j = 0; j < NP; ++j) gp[j] = reinterpret_cast<const P*>(gr)[j * 32 + lane];
}

// D = split * SEG, SEG = 32 * NP * VEC; blockDim.x = slots * split * 32.
// Warp w runs slot w / split, columns [(w % split) * SEG, (w % split + 1) *
// SEG) of its rows; its lane owns the VEC columns of packs j * 32 + lane of
// them.
template <typename T, int VEC, int NP>
__global__ void __launch_bounds__(32 * BWD_MAX_WARPS)
    rmsnorm_bwd_warp_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            float* __restrict__ part, long long rows, int rows_per_block,
                            int split, float eps) {
  constexpr int SEG = 32 * NP * VEC;
  using P = Pack<T, VEC>;
  extern __shared__ float4 s_dyn[];  // scale [D], then the slots' sums [slots][D]
  __shared__ float s_red[BWD_MAX_WARPS][2][2];  // a warp's (sum x^2, sum g x), by row parity
  const int D = split * SEG;
  const float inv_d = 1.f / (float)D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slots = blockDim.x / (32 * split);
  const int slot = warp / split, seg = (warp % split) * SEG;
  const int steps = rows_per_block / slots;
  long long row = (long long)blockIdx.x * rows_per_block + slot;

  P xp[NP], gp[NP];
  if (row < rows)  // the same for every warp of a slot
    load_row<T, VEC, NP>(xp, gp, x + row * D + seg, dy + row * D + seg, lane);
  for (int i = threadIdx.x; i < D / 4; i += blockDim.x)
    s_dyn[i] = reinterpret_cast<const float4*>(scale)[i];
  __syncthreads();

  float acc[NP * VEC];
#pragma unroll
  for (int i = 0; i < NP * VEC; ++i) acc[i] = 0.f;
  // a row's loads at the top of its own step: issued after the previous
  // row's stores, never hoisted over them into more registers
  for (int k = 0; k < steps && row < rows; ++k, row += slots) {
    if (k > 0) load_row<T, VEC, NP>(xp, gp, x + row * D + seg, dy + row * D + seg, lane);
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const float4* sc = s_dyn + (seg + (j * 32 + lane) * VEC) / 4;
#pragma unroll
      for (int e4 = 0; e4 < VEC / 4; ++e4) {
        const float4 s4 = sc[e4];
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float xv = rt::to_f(xp[j].v[4 * e4 + e]);
          ss += xv * xv;
          sg += rt::to_f(gp[j].v[4 * e4 + e]) * sv[e] * xv;
        }
      }
    }
    ss = rt::warp_sum(ss);
    sg = rt::warp_sum(sg);
    if (split > 1) {  // the slot's warps add their sums in warp order
      if (lane == 0) {
        s_red[warp][k & 1][0] = ss;
        s_red[warp][k & 1][1] = sg;
      }
      named_barrier(1 + slot, 32 * split);
      const int w0 = slot * split;
      ss = s_red[w0][k & 1][0];
      sg = s_red[w0][k & 1][1];
      for (int w = 1; w < split; ++w) {
        ss += s_red[w0 + w][k & 1][0];
        sg += s_red[w0 + w][k & 1][1];
      }
    }
    const float r = rsqrtf(ss * inv_d + eps);
    const float coef = r * r * r * (sg * inv_d);
    // the scale is read from shared memory again below, not held in
    // registers across the sums
    asm volatile("" ::: "memory");
    P* dxr = reinterpret_cast<P*>(dx + row * D + seg);
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const float4* sc = s_dyn + (seg + (j * 32 + lane) * VEC) / 4;
      P q;
#pragma unroll
      for (int e4 = 0; e4 < VEC / 4; ++e4) {
        const float4 s4 = sc[e4];
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float xv = rt::to_f(xp[j].v[4 * e4 + e]);
          const float gv = rt::to_f(gp[j].v[4 * e4 + e]);
          q.v[4 * e4 + e] = rt::from_f<T>(r * (gv * sv[e]) - xv * coef);
          acc[j * VEC + 4 * e4 + e] += gv * xv * r;
        }
      }
      dxr[j * 32 + lane] = q;
    }
  }

  // the block's partial row: its slots' sums added in slot order
  float4* pr = reinterpret_cast<float4*>(part + (long long)blockIdx.x * D);
  float4* mine = slots == 1 ? pr : s_dyn + (1 + slot) * (D / 4);
#pragma unroll
  for (int j = 0; j < NP; ++j) {
#pragma unroll
    for (int e4 = 0; e4 < VEC / 4; ++e4) {
      const float* a = acc + j * VEC + 4 * e4;
      mine[(seg + (j * 32 + lane) * VEC) / 4 + e4] = make_float4(a[0], a[1], a[2], a[3]);
    }
  }
  if (slots == 1) return;
  __syncthreads();
  const float4* sums = s_dyn + D / 4;
  for (int i = threadIdx.x; i < D / 4; i += blockDim.x) {
    float4 s = sums[i];
    for (int t = 1; t < slots; ++t) {
      const float4 u = sums[t * (D / 4) + i];
      s.x += u.x;
      s.y += u.y;
      s.z += u.z;
      s.w += u.w;
    }
    pr[i] = s;
  }
}

constexpr int SUM_WARPS = 8;  // runs of partial rows the second pass adds side by side

// dscale[c] = the sum over b of part[b][c]: warp w of a block adds the
// partial rows of run w ([w * run, (w + 1) * run), run = ceil(blocks /
// SUM_WARPS)) in block order for 32 columns; then the runs' sums are
// added in run order.
__global__ void __launch_bounds__(32 * SUM_WARPS)
    rmsnorm_dscale_kernel(const float* __restrict__ part, float* __restrict__ dscale, int blocks,
                          int d) {
  __shared__ float s_run[SUM_WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int run = (blocks + SUM_WARPS - 1) / SUM_WARPS;
  const int b1 = (w + 1) * run < blocks ? (w + 1) * run : blocks;
  float s = 0.f;
  if (c < d) {
#pragma unroll 16
    for (int b = w * run; b < b1; ++b) s += part[(long long)b * d + c];
  }
  s_run[w][lane] = s;
  __syncthreads();
  if (w != 0 || c >= d) return;
  float t = s_run[0][lane];
#pragma unroll
  for (int i = 1; i < SUM_WARPS; ++i) t += s_run[i][lane];
  dscale[c] = t;
}

// the second pass, after either kernel
inline int launch_dscale(void* part, void* dscale, int blocks, int d, cudaStream_t stream) {
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rmsnorm_dscale_kernel<<<(d + 31) / 32, 32 * SUM_WARPS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dscale), blocks, d);
  return (int)cudaGetLastError();
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
  return launch_dscale(part, dscale, blocks, d, stream);
}

// the warp kernel at d = split * 32 * np * VEC, np a power of two up to
// BWD_LANE_ELEMS / VEC (the wrapper picks split and np: kernels/rmsnorm.py::
// bwd_warp_split); any other split or np is refused
template <typename T, int VEC, int NP = BWD_LANE_ELEMS / VEC>
int launch_bwd_warp(const void* x, const void* scale, const void* dy, void* dx, void* part,
                    void* dscale, long long rows, int d, int blocks, int rows_per_block,
                    int slots, int split, float eps, cudaStream_t stream) {
  if constexpr (NP >= 1) {
    if (d != split * 32 * NP * VEC)
      return launch_bwd_warp<T, VEC, NP / 2>(x, scale, dy, dx, part, dscale, rows, d, blocks,
                                             rows_per_block, slots, split, eps, stream);
    // shared memory: the scale and the slots' sums, at most 32 KB
    if (slots * split > BWD_MAX_WARPS || (slots > 1 && slots * d > BWD_SLOT_ELEMS))
      return (int)cudaErrorInvalidValue;
    const int smem = (d + (slots > 1 ? slots * d : 0)) * (int)sizeof(float);
    rmsnorm_bwd_warp_kernel<T, VEC, NP><<<blocks, slots * split * 32, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<const T*>(dy),
        static_cast<T*>(dx), static_cast<float*>(part), rows, rows_per_block, split, eps);
    return launch_dscale(part, dscale, blocks, d, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, dy, dx: (rows, d) contiguous of one dtype; scale, dscale: (d,) float32;
// part: (blocks, d) float32 scratch. Block b handles rows
// [b * rows_per_block, (b + 1) * rows_per_block); the wrapper picks the
// three (kernels/rmsnorm.py::bwd_plan) so that they cover every row.
// split > 0 runs the warp kernel with a row over `split` warps: it requires
// d = split * 32 lanes * 16 bytes * a power of two up to BWD_LANE_ELEMS
// elements a lane, rows_per_block a multiple of slots, and 16-byte aligned
// x, dy, dx and scale, which the wrapper checks before asking; split 0 runs
// the block kernel.
extern "C" int rt_rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                              void* part, void* dscale, long long rows, int d, int blocks,
                              int rows_per_block, int slots, int split, float eps, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0 || d > BWD_MAX_D || blocks <= 0 || rows_per_block <= 0 ||
      (long long)blocks * rows_per_block < rows || slots <= 0 || rows_per_block % slots != 0 ||
      split < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == rt::kF32)
    return split ? launch_bwd_warp<float, 4>(x, scale, dy, dx, part, dscale, rows, d, blocks,
                                             rows_per_block, slots, split, eps, s)
                 : launch_bwd<float>(x, scale, dy, dx, part, dscale, rows, d, blocks,
                                     rows_per_block, eps, s);
  if (dtype == rt::kBF16)
    return split ? launch_bwd_warp<__nv_bfloat16, 8>(x, scale, dy, dx, part, dscale, rows, d,
                                                     blocks, rows_per_block, slots, split, eps, s)
                 : launch_bwd<__nv_bfloat16>(x, scale, dy, dx, part, dscale, rows, d, blocks,
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
