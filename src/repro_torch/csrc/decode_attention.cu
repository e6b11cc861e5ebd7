// Flash decode: one query token per row against a ring-buffer KV cache.
// A cache slot is valid iff kpos >= 0 && kpos <= pos (&& kpos > pos - window
// when window > 0), as in the model's cache semantics.
//
// Replaces: src/repro/kernels/decode_attention.py::flash_decode
// (pallas_call at :77, body _decode_kernel at :23).
//
// Bound on the H100: memory. Each valid cache row of K and V is read once
// (at the serve shape, B=4, one KV head, hd=256, bf16, ~2.2 MB per layer,
// under 1 us at 3.35 TB/s); the arithmetic is 4 * hd flops per (head,
// key), far below the tensor-core rate.
//
// Design: the Pallas grid runs one program per (b, q-head); here one block
// serves all g = H/K query heads of a KV head, so each cache row is read
// once for the g heads (g = 8 for gemma's MQA). B*K blocks cannot fill 132
// SMs, so the cache axis is also split into chunks of 64 slots, one block
// per (chunk, b, kv-head); each writes its unnormalised float32 partial
// (running max, sum and accumulator per head) to scratch, and a second
// kernel combines the chunks with the online-softmax rescaling. Slots that
// are empty, in the future or outside the window are skipped without being
// read. The cache is read through element strides in the model's own
// (B, W, n, hd) layout (passed as a (B, K, S, hd) view): decode copies and
// transposes nothing.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int CHUNK = 64;
constexpr int THREADS = 256;
constexpr int MAXG = 16;  // query heads per KV head handled in registers

struct Strides {
  long long qb, qh, kb, kh, ks, vb, vh, vs, pb, ps, ob, oh;
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ kpos,
                        float* __restrict__ part_acc, float* __restrict__ part_m,
                        float* __restrict__ part_l, int H, int K, int S, int pos, int window,
                        float scale, Strides st) {
  constexpr int KR = (HD + 31) / 32;
  const int g = H / K;
  const int n_split = gridDim.x;
  const int split = blockIdx.x;
  const int bk = blockIdx.y;  // b * K + kv head
  const int b = bk / K;
  const int kvh = bk % K;
  const int s0 = split * CHUNK;
  const int n = min(CHUNK, S - s0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = THREADS / 32;

  extern __shared__ float smem[];
  float* sq = smem;             // g * HD query values
  float* sp = sq + g * HD;      // g * CHUNK scores, then weights
  __shared__ int svalid[CHUNK];

  for (int idx = tid; idx < g * HD; idx += THREADS) {
    const int j = idx / HD, d = idx % HD;
    sq[idx] = rt::to_f(q[b * st.qb + (long long)(kvh * g + j) * st.qh + d]);
  }
  for (int c = tid; c < CHUNK; c += THREADS) {
    bool valid = c < n;
    if (valid) {
      const int kp = kpos[b * st.pb + (long long)(s0 + c) * st.ps];
      valid = kp >= 0 && kp <= pos && (window <= 0 || kp > pos - window);
    }
    svalid[c] = valid;
  }
  __syncthreads();

  // scores: one warp per cache slot, lanes across head_dim
  const T* kbase = k + b * st.kb + kvh * st.kh;
  for (int c = warp; c < CHUNK; c += nwarps) {
    if (!svalid[c]) continue;  // uniform across the warp
    const T* krow = kbase + (long long)(s0 + c) * st.ks;
    float kr[KR];
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      const int d = lane + 32 * i;
      kr[i] = d < HD ? rt::to_f(krow[d]) : 0.f;
    }
    for (int j = 0; j < g; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        const int d = lane + 32 * i;
        if (d < HD) dot += kr[i] * sq[j * HD + d];
      }
      dot = rt::warp_sum(dot);
      if (lane == 0) sp[j * CHUNK + c] = dot * scale;
    }
  }
  __syncthreads();

  // per-head chunk max and weights: one warp per head
  const long long part = (long long)bk * n_split + split;
  for (int j = warp; j < g; j += nwarps) {
    float mx = rt::kNegInit;
    for (int c = lane; c < CHUNK; c += 32)
      if (svalid[c]) mx = fmaxf(mx, sp[j * CHUNK + c]);
    mx = rt::warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < CHUNK; c += 32) {
      const float w = svalid[c] ? expf(sp[j * CHUNK + c] - mx) : 0.f;
      sp[j * CHUNK + c] = w;
      sum += w;
    }
    sum = rt::warp_sum(sum);
    if (lane == 0) {
      part_m[part * g + j] = mx;
      part_l[part * g + j] = sum;
    }
  }
  __syncthreads();

  // weighted V: one thread per head_dim column, all g heads in registers
  const T* vbase = v + b * st.vb + kvh * st.vh;
  for (int d = tid; d < HD; d += THREADS) {
    float a[MAXG];
#pragma unroll
    for (int j = 0; j < MAXG; ++j) a[j] = 0.f;
    for (int c = 0; c < n; ++c) {
      if (!svalid[c]) continue;
      const float vv = rt::to_f(vbase[(long long)(s0 + c) * st.vs + d]);
#pragma unroll
      for (int j = 0; j < MAXG; ++j)
        if (j < g) a[j] += sp[j * CHUNK + c] * vv;
    }
#pragma unroll
    for (int j = 0; j < MAXG; ++j)
      if (j < g) part_acc[(part * g + j) * HD + d] = a[j];
  }
}

// One block per (b, q-head): rescale every chunk's partial to the global
// max and divide by the global sum.
template <typename T, int HD>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l, T* __restrict__ o, int H,
                                      int K, int n_split, Strides st) {
  const int g = H / K;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / g;
  const int j = h % g;
  const long long base = (long long)(b * K + kvh) * n_split;

  float M = rt::kNegInit;
  for (int sp = 0; sp < n_split; ++sp) M = fmaxf(M, part_m[(base + sp) * g + j]);
  float L = 0.f;
  for (int sp = 0; sp < n_split; ++sp)
    L += expf(part_m[(base + sp) * g + j] - M) * part_l[(base + sp) * g + j];
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float acc = 0.f;
    for (int sp = 0; sp < n_split; ++sp)
      acc += expf(part_m[(base + sp) * g + j] - M) * part_acc[((base + sp) * g + j) * HD + d];
    o[b * st.ob + (long long)h * st.oh + d] = rt::from_f<T>(acc * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* kpos, void* o,
           void* part_acc, void* part_m, void* part_l, int B, int H, int K, int S,
           const Strides& st, int pos, int window, float scale, cudaStream_t stream) {
  const int g = H / K;
  const int n_split = (S + CHUNK - 1) / CHUNK;
  const size_t smem = sizeof(float) * (size_t)g * (HD + CHUNK);
  dim3 grid(n_split, B * K);
  decode_split_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kpos), static_cast<float*>(part_acc), static_cast<float*>(part_m),
      static_cast<float*>(part_l), H, K, S, pos, window, scale, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int threads = HD < 32 ? 32 : (HD > 256 ? 256 : HD);
  decode_combine_kernel<T, HD><<<B * H, threads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<T*>(o), H, K, n_split, st);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* kpos, void* o,
                void* pa, void* pm, void* pl, int B, int H, int K, int S, const Strides& st,
                int pos, int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, kpos, o, pa, pm, pl, B, H, K, S, st, pos, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, kpos, o, pa, pm, pl, B, H, K, S, st, pos, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, kpos, o, pa, pm, pl, B, H, K, S, st, pos, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, kpos, o, pa, pm, pl, B, H, K, S, st, pos, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, kpos, o, pa, pm, pl, B, H, K, S, st, pos, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Number of cache chunks the split kernel uses; the wrapper sizes the
// float32 scratch as part_acc (B*K*n_split*g*hd), part_m and part_l
// (B*K*n_split*g each).
extern "C" int rt_flash_decode_splits(int S) { return (S + CHUNK - 1) / CHUNK; }

// strides: 12 element strides: q (batch, head), k (batch, head, seq),
// v (batch, head, seq), kpos (batch, seq), o (batch, head); the head_dim
// axis of q, k, v and o has stride 1.
extern "C" int rt_flash_decode(const void* q, const void* k, const void* v, const void* kpos,
                               void* o, void* part_acc, void* part_m, void* part_l, int B, int H,
                               int K, int S, int hd, const long long* strides, int pos,
                               int window, float scale, int dtype, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || H / K > MAXG || S <= 0 || B * K > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],  strides[5],
             strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return dispatch_hd<float>(hd, q, k, v, kpos, o, part_acc, part_m, part_l, B, H, K, S, st,
                              pos, window, scale, s);
  if (dtype == rt::kBF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, kpos, o, part_acc, part_m, part_l, B, H, K, S,
                                      st, pos, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
