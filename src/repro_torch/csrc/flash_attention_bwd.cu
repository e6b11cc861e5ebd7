// Backward of the blocked causal / sliding-window GQA attention of
// flash_attention.cu: dQ, dK and dV from q, k, v, the output o, its
// gradient dO and the forward's per-row log-sum-exp lse.
//
// Replaces: nothing written for the TPU. The Pallas kernel
// src/repro/kernels/flash_attention.py::flash_attention (pallas_call at
// :99) has no backward; the reference trains by jax.grad of its jnp
// attention (src/repro/models/layers.py::_sdpa). On the card the forward
// runs the CUDA kernel, so its gradient is this kernel.
//
// With s = q·kᵀ·scale (masked), P = exp(s − lse), D = rowsum(dO ∘ O):
//   dV = Pᵀ·dO,   dP = dO·Vᵀ,   dS = P ∘ (dP − D),
//   dQ = dS·K·scale,   dK = dSᵀ·Q·scale,
// dK and dV summed over the query heads that share a KV head.
//
// Bound on the H100: operations. At gemma-2b's training shape (B=4, H=8,
// K=1, S=512, hd=256, causal, bf16) the two passes do 14·hd flops per
// causal (query, key) pair, 4·B·H·S(S+1)/2·hd·3.5 ≈ 15 GFLOP over ~34 MB:
// ~0.015 ms at 989 TFLOP/s (~0.2 ms at the 67 TFLOP/s of float32 FMA,
// which is what this kernel runs on).
//
// Design (simple and exact first; tensor cores are a later PR's work):
// - flash_bwd_dot_kernel: D, one warp per query row, float32.
// - flash_bwd_dkdv_kernel: one block per (16 keys, KV head, batch). K and
//   V tiles sit in shared memory as float32; the block walks every query
//   head of its group and, for each, the 32-row query chunks that can see
//   its keys (causal: from the tile's first key on; window: up to its last
//   key + window − 1), staging Q and dO chunks. Per chunk it recomputes P
//   and dS into shared memory, then each thread adds Pᵀ·dO and dSᵀ·Q into
//   its registers: one column, hd/16 keys (hd/8 accumulators).
// - flash_bwd_dq_kernel: one block per (32 query rows, head, batch) with
//   Q and dO resident, walking its visible 16-key tiles; each thread owns
//   one column of hd/8 rows of dQ.
// Every sum runs in a fixed order inside one block: no atomics and no
// split over keys, so the gradients are bit-identical from run to run (the
// fault-tolerant trainer's invariant). Shared memory at hd 256: ~103 KB a
// block for dK/dV, ~101 KB for dQ; two blocks an SM.
//
// All tensors are read and written through element strides (batch, head,
// seq), the head_dim axis contiguous; lse and D are (B, H, S) float32.
#include "common.cuh"

namespace {

constexpr int BW_THREADS = 256;
constexpr int BW_Q = 32;  // query rows per chunk (dK/dV) or per block (dQ)
constexpr int BW_K = 16;  // keys per block (dK/dV) or per tile (dQ)
constexpr int BW_NE = BW_Q * BW_K / BW_THREADS;  // (row, key) scores per thread: 2

struct BwdStrides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os, gb, gh, gs;  // g: dO
  long long dqb, dqh, dqs, dkb, dkh, dks, dvb, dvh, dvs;
};

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int causal, int window) {
  bool ok = qpos < S && kpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// rows x HD of a (b, head) slice into float shared memory [rows][HD + 1],
// zeros past S
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss, int p0, int rows,
                                      int S) {
  for (int idx = threadIdx.x; idx < rows * HD; idx += BW_THREADS) {
    const int rr = idx / HD, dd = idx % HD;
    const int p = p0 + rr;
    dst[rr * (HD + 1) + dd] = p < S ? rt::to_f(src[(long long)p * ss + dd]) : 0.f;
  }
}

template <int HD>
__device__ __forceinline__ float dot_row(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 8
  for (int dd = 0; dd < HD; ++dd) acc += a[dd] * b[dd];
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(BW_THREADS)
    flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ g, float* __restrict__ D,
                         int H, int S, int hd, BwdStrides st, long long rows) {
  const long long row = (long long)blockIdx.x * (BW_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int s = (int)(row % S);
  const int h = (int)((row / S) % H);
  const int b = (int)(row / ((long long)S * H));
  const T* orow = o + b * st.ob + h * st.oh + (long long)s * st.os;
  const T* grow = g + b * st.gb + h * st.gh + (long long)s * st.gs;
  float acc = 0.f;
  for (int c = lane; c < hd; c += 32) acc += rt::to_f(orow[c]) * rt::to_f(grow[c]);
  acc = rt::warp_sum(acc);
  if (lane == 0) D[row] = acc;
}

template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(float) *
         (2 * (size_t)BW_K * (HD + 1) + 2 * (size_t)BW_Q * (HD + 1) + 2 * BW_Q * (BW_K + 1) +
          2 * BW_Q);
}

template <typename T, int HD>
__global__ void __launch_bounds__(BW_THREADS)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ g,
                          const float* __restrict__ lse, const float* __restrict__ D,
                          T* __restrict__ dk, T* __restrict__ dv, int H, int K, int S,
                          BwdStrides st, int causal, int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int LP = BW_K + 1;
  constexpr int KPT = BW_K * HD / BW_THREADS;  // keys per thread in the accumulators
  constexpr int KSTEP = BW_THREADS / HD;       // key stride between them
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BW_K * LD;
  float* sQ = sV + BW_K * LD;
  float* sG = sQ + BW_Q * LD;
  float* sP = sG + BW_Q * LD;
  float* sS = sP + BW_Q * LP;
  float* sL = sS + BW_Q * LP;
  float* sD = sL + BW_Q;

  const int k0 = blockIdx.x * BW_K;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int grp = H / K;
  const int tid = threadIdx.x;
  const int col = tid % HD;
  const int kj0 = tid / HD;

  stage<T, HD>(sK, k + b * st.kb + kvh * st.kh, st.ks, k0, BW_K, S);
  stage<T, HD>(sV, v + b * st.vb + kvh * st.vh, st.vs, k0, BW_K, S);

  float acc_k[KPT], acc_v[KPT];
#pragma unroll
  for (int m = 0; m < KPT; ++m) acc_k[m] = acc_v[m] = 0.f;

  // the query rows that can see a key of this tile
  const int k_last = min(k0 + BW_K, S) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, k_last + window) : S;

  for (int hh = 0; hh < grp; ++hh) {
    const int h = kvh * grp + hh;
    const T* qh = q + b * st.qb + h * st.qh;
    const T* gh = g + b * st.gb + h * st.gh;
    const float* lh = lse + ((long long)b * H + h) * S;
    const float* dh = D + ((long long)b * H + h) * S;
    for (int i0 = (q_lo / BW_Q) * BW_Q; i0 < q_hi; i0 += BW_Q) {
      __syncthreads();  // the previous chunk is no longer read
      stage<T, HD>(sQ, qh, st.qs, i0, BW_Q, S);
      stage<T, HD>(sG, gh, st.gs, i0, BW_Q, S);
      if (tid < BW_Q) {
        const int p = i0 + tid;
        sL[tid] = p < S ? lh[p] : 0.f;
        sD[tid] = p < S ? dh[p] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < BW_NE; ++r) {
        const int e = tid + BW_THREADS * r;
        const int i = e / BW_K, j = e % BW_K;
        float p = 0.f, ds = 0.f;
        if (visible(i0 + i, k0 + j, S, causal, window)) {
          const float sc = dot_row<HD>(sQ + i * LD, sK + j * LD) * scale;
          p = expf(sc - sL[i]);
          const float dp = dot_row<HD>(sG + i * LD, sV + j * LD);
          ds = p * (dp - sD[i]);
        }
        sP[i * LP + j] = p;
        sS[i * LP + j] = ds;
      }
      __syncthreads();
      for (int i = 0; i < BW_Q; ++i) {
        const float gi = sG[i * LD + col];
        const float qi = sQ[i * LD + col];
#pragma unroll
        for (int m = 0; m < KPT; ++m) {
          const int j = kj0 + KSTEP * m;
          acc_v[m] += sP[i * LP + j] * gi;
          acc_k[m] += sS[i * LP + j] * qi;
        }
      }
    }
  }

  T* dkb = dk + b * st.dkb + kvh * st.dkh;
  T* dvb = dv + b * st.dvb + kvh * st.dvh;
#pragma unroll
  for (int m = 0; m < KPT; ++m) {
    const int kpos = k0 + kj0 + KSTEP * m;
    if (kpos < S) {
      dkb[(long long)kpos * st.dks + col] = rt::from_f<T>(acc_k[m] * scale);
      dvb[(long long)kpos * st.dvs + col] = rt::from_f<T>(acc_v[m]);
    }
  }
}

template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) *
         (2 * (size_t)BW_Q * (HD + 1) + 2 * (size_t)BW_K * (HD + 1) + BW_Q * (BW_K + 1) +
          2 * BW_Q);
}

template <typename T, int HD>
__global__ void __launch_bounds__(BW_THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ D,
                        T* __restrict__ dq, int H, int K, int S, BwdStrides st, int causal,
                        int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int LP = BW_K + 1;
  constexpr int RPT = BW_Q * HD / BW_THREADS;  // query rows per thread in the accumulators
  constexpr int RSTEP = BW_THREADS / HD;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + BW_Q * LD;
  float* sK = sG + BW_Q * LD;
  float* sV = sK + BW_K * LD;
  float* sS = sV + BW_K * LD;
  float* sL = sS + BW_Q * LP;
  float* sD = sL + BW_Q;

  const int i0 = blockIdx.x * BW_Q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const int tid = threadIdx.x;
  const int col = tid % HD;
  const int qi0 = tid / HD;

  stage<T, HD>(sQ, q + b * st.qb + h * st.qh, st.qs, i0, BW_Q, S);
  stage<T, HD>(sG, g + b * st.gb + h * st.gh, st.gs, i0, BW_Q, S);
  if (tid < BW_Q) {
    const int p = i0 + tid;
    const long long row = ((long long)b * H + h) * S + p;
    sL[tid] = p < S ? lse[row] : 0.f;
    sD[tid] = p < S ? D[row] : 0.f;
  }

  float acc[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m) acc[m] = 0.f;

  // the keys any row of this block can see
  const int i_last = min(i0 + BW_Q, S) - 1;
  const int k_lo = window > 0 ? max(0, i0 - window + 1) : 0;
  const int k_hi = causal ? i_last + 1 : S;
  const T* kh = k + b * st.kb + kvh * st.kh;
  const T* vh = v + b * st.vb + kvh * st.vh;

  for (int k0 = (k_lo / BW_K) * BW_K; k0 < k_hi; k0 += BW_K) {
    __syncthreads();  // the previous tile is no longer read
    stage<T, HD>(sK, kh, st.ks, k0, BW_K, S);
    stage<T, HD>(sV, vh, st.vs, k0, BW_K, S);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < BW_NE; ++r) {
      const int e = tid + BW_THREADS * r;
      const int i = e / BW_K, j = e % BW_K;
      float ds = 0.f;
      if (visible(i0 + i, k0 + j, S, causal, window)) {
        const float sc = dot_row<HD>(sQ + i * LD, sK + j * LD) * scale;
        const float p = expf(sc - sL[i]);
        const float dp = dot_row<HD>(sG + i * LD, sV + j * LD);
        ds = p * (dp - sD[i]);
      }
      sS[i * LP + j] = ds;
    }
    __syncthreads();
    for (int j = 0; j < BW_K; ++j) {
      const float kj = sK[j * LD + col];
#pragma unroll
      for (int m = 0; m < RPT; ++m) acc[m] += sS[(qi0 + RSTEP * m) * LP + j] * kj;
    }
  }

  T* dqb = dq + b * st.dqb + h * st.dqh;
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    const int qpos = i0 + qi0 + RSTEP * m;
    if (qpos < S) dqb[(long long)qpos * st.dqs + col] = rt::from_f<T>(acc[m] * scale);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* g,
           const float* lse, float* D, void* dq, void* dk, void* dv, int B, int H, int K, int S,
           const BwdStrides& st, int causal, int window, float scale, cudaStream_t stream) {
  static int dkdv_set[rt::kMaxDevices], dq_set[rt::kMaxDevices];
  cudaError_t e = rt::max_dynamic_smem(
      reinterpret_cast<const void*>(flash_bwd_dkdv_kernel<T, HD>), (int)dkdv_smem<HD>(),
      dkdv_set);
  if (e != cudaSuccess) return (int)e;
  e = rt::max_dynamic_smem(reinterpret_cast<const void*>(flash_bwd_dq_kernel<T, HD>),
                           (int)dq_smem<HD>(), dq_set);
  if (e != cudaSuccess) return (int)e;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  const long long rows = (long long)B * H * S;
  const long long dot_blocks = (rows + BW_THREADS / 32 - 1) / (BW_THREADS / 32);
  if (dot_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  flash_bwd_dot_kernel<T><<<(unsigned)dot_blocks, BW_THREADS, 0, stream>>>(
      static_cast<const T*>(o), gt, D, H, S, HD, st, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_kernel<T, HD><<<dim3((S + BW_K - 1) / BW_K, K, B), BW_THREADS,
                                 dkdv_smem<HD>(), stream>>>(
      qt, kt, vt, gt, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), H, K, S, st, causal,
      window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<T, HD><<<dim3((S + BW_Q - 1) / BW_Q, H, B), BW_THREADS, dq_smem<HD>(),
                               stream>>>(qt, kt, vt, gt, lse, D, static_cast<T*>(dq), H, K, S,
                                         st, causal, window, scale);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const void*, const void*, const void*, const void*, const void*,
                         const float*, float*, void*, void*, void*, int, int, int, int,
                         const BwdStrides&, int, int, float, cudaStream_t);

template <typename T>
LaunchFn pick_hd(int hd) {
  switch (hd) {
    case 16: return launch<T, 16>;
    case 32: return launch<T, 32>;
    case 64: return launch<T, 64>;
    case 128: return launch<T, 128>;
    case 256: return launch<T, 256>;
    default: return nullptr;
  }
}

}  // namespace

// strides: 24 element strides, (batch, head, seq) for q, k, v, o, dO, dq,
// dk and dv in that order; the head_dim axis of every tensor has stride 1.
// lse: (B, H, S) float32 from the forward; D: (B, H, S) float32 scratch.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse, void* D,
                                      void* dq, void* dk, void* dv, int B, int H, int K, int S,
                                      int hd, const long long* strides, int causal, int window,
                                      float scale, int dtype, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || S <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  LaunchFn fn = nullptr;
  if (dtype == rt::kF32) fn = pick_hd<float>(hd);
  else if (dtype == rt::kBF16) fn = pick_hd<__nv_bfloat16>(hd);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const long long* t = strides;
  BwdStrides st{t[0],  t[1],  t[2],  t[3],  t[4],  t[5],  t[6],  t[7],
                t[8],  t[9],  t[10], t[11], t[12], t[13], t[14], t[15],
                t[16], t[17], t[18], t[19], t[20], t[21], t[22], t[23]};
  return fn(q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(D), dq, dk, dv,
            B, H, K, S, st, causal, window, scale, static_cast<cudaStream_t>(stream));
}
