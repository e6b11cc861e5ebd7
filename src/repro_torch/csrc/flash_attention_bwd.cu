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
// Bound on the H100 (the five products are 10·hd flops per visible (query,
// key) pair; bytes count the inputs and outputs once and, for bf16, the
// round trip of the per-head dK/dV partials): at gemma-2b's training shape
// (B=4, H=8, K=1, S=512, hd=256, causal, bf16) bytes, ~102 MB (67 of them
// the partials) in ~0.030 ms at 3.35 TB/s against ~10.8 GFLOP in ~0.011 ms
// at 989 TFLOP/s; at recurrentgemma-9b's (B=4, H=16, S=2048, window 2048)
// operations, ~344 GFLOP in ~0.35 ms.
//
// Two routes in one source, chosen by the input type. Every sum runs in a
// fixed order (no atomics, no split whose order depends on scheduling), so
// the gradients are bit-identical from run to run: the fault-tolerant
// trainer's invariant.
//
// bfloat16 (flash_bwd_tc_kernel, wgmma + TMA): four launches.
// - flash_bwd_dot_kernel: D, one warp per query row, float32.
// - flash_bwd_tc_kernel<HD, false>, dK/dV: one block per (64 keys, query
//   head, batch), K and V resident, the 64-row Q and dO tiles that can see
//   the keys streamed by TMA into a two-stage mbarrier ring (the forward's
//   producer warpgroup and setmaxnreg split). Consumer warpgroup 0 computes
//   Sᵀ = K·Qᵀ, Pᵀ = exp2(Sᵀ·scale·log2e − lse·log2e) and dV += Pᵀ·dO;
//   warpgroup 1 computes dPᵀ = V·dOᵀ, takes Pᵀ from warpgroup 0 through a
//   16 KB float32 hand-over buffer (two named barriers), forms
//   dSᵀ = Pᵀ ∘ (dPᵀ − D) and accumulates dK += dSᵀ·Q. So each warpgroup
//   holds one 64 × hd float32 accumulator (128 registers a thread at hd
//   256). Each block writes its head's float32 partials to a (2, B, H, S,
//   hd) scratch: B·H·S/64 blocks (256 at gemma's MQA shape) instead of one
//   per KV head.
// - flash_bwd_tc_kernel<HD, true>, dQ: one block per (64 query rows, head,
//   batch), Q and dO resident, K and V tiles streamed; warpgroup 0 computes
//   S and P, warpgroup 1 dP, dS and dQ += dS·K (K read MN-major).
// - flash_bwd_sum_kernel: each KV head's partials summed over its group in
//   head order (head 0 first), rounded once to bf16.
// The products read both operands from the 128-byte-swizzled tiles the
// TMA lands (Sᵀ, dPᵀ, S, dP: m64n64k16, K-major) or take P / dS from
// registers as A fragments with B read MN-major (dV, dK, dQ). P and dS
// enter those as a bf16 high part plus the bf16 rounding of the rest, two
// products each: one bf16 rounding alone leaves the bf16 tolerance against
// the float32 plain version (tests/test_torch_flash_bwd.py). Only tiles on
// the causal diagonal, the window edge or the ragged end are masked; tiles
// above the diagonal or before the window are never loaded. Shared memory
// at hd 256: 2 resident + 2 × 2 streamed 32 KB tiles + 16 KB = 208 KB.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): 0.105
// ms on the device at gemma-2b's shape and 1.65 ms at recurrentgemma-9b's,
// against 0.0995 and 1.14 ms for SDPA's backward.
//
// float32 (unchanged from the first port; FMA, exact to ~1e-6, which one
// TF32 rounding would not be; the forward's 3xTF32 split would):
// - flash_bwd_dot_kernel: D as above.
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
//
// All tensors are read and written through element strides (batch, head,
// seq), the head_dim axis contiguous; lse and D are (B, H, S) float32. The
// bf16 route also needs 16-byte aligned q, k, v, dO and their batch, head
// and seq strides a multiple of 8 elements (the tensor maps' rule; the
// Python wrapper copies a tensor that breaks it).
#include "hopper.cuh"

namespace {

using namespace hopper;

// ---------------------------------------------------------------------------
// float32: FMA kernels (and the D pass of both routes)
// ---------------------------------------------------------------------------

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

template <int HD>
int launch_fma(const void* q, const void* k, const void* v, const void* o, const void* g,
               const float* lse, float* D, float* /*part*/, void* dq, void* dk, void* dv, int B,
               int H, int K, int S, const BwdStrides& st, int causal, int window, float scale,
               cudaStream_t stream) {
  using T = float;
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

// ---------------------------------------------------------------------------
// bfloat16: wgmma kernels
// ---------------------------------------------------------------------------

constexpr int TB_ROWS = 64;  // rows of every tile, resident or streamed
constexpr int TB_CONSUMERS = 256;
constexpr int TB_THREADS = TB_CONSUMERS + 128;  // + one producer warpgroup
// registers a thread after the producer gives its share to the consumers:
// 128·24 + 256·240 = 64,512 of the SM's 65,536
constexpr int TB_PRODUCER_REGS = 24;
constexpr int TB_CONSUMER_REGS = 240;
constexpr int BAR_X_FULL = 1;   // named barrier: P is in the hand-over buffer
constexpr int BAR_X_EMPTY = 2;  // named barrier: warpgroup 1 has read it
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct BwdShape {
  static constexpr int HDP = HD < 64 ? 64 : HD;  // row padded to whole 64-column blocks
  static constexpr int NDB = HDP / 64;           // 64-column blocks
  static constexpr int TILE = TB_ROWS * HDP * 2;  // one 64-row bf16 tile
  static constexpr int X_OFF = 6 * TILE;  // 2 resident tiles, 2 stages of 2 streamed tiles
  static constexpr int BAR_OFF = X_OFF + TB_ROWS * TB_ROWS * 4;  // + the float32 hand-over
  static constexpr int SMEM = BAR_OFF + 64 + SW_ATOM;  // + 5 mbarriers, + alignment slack
};

// A 64x64 float32 accumulator tile as bf16 wgmma A fragments of its high
// part and of the bf16 rounding of the rest; k16 step t covers its columns
// 16t .. 16t + 15
__device__ __forceinline__ void split_frags(const float (&x)[32], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float a = x[8 * t + 2 * u], c = x[8 * t + 2 * u + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, c);
      const float2 hf = __bfloat1622float2(h);
      hi[t][u] = *reinterpret_cast<const uint32_t*>(&h);
      lo[t][u] = pack_bf16(a - hf.x, c - hf.y);
    }
  }
}

// acc[nb] += A · B for the NDB 64-column blocks of a streamed tile read
// MN-major (its rows are the k16 steps); A as high and low fragments
template <int NDB>
__device__ __forceinline__ void rs_products(float (&acc)[NDB][32], const uint32_t (&hi)[4][4],
                                            const uint32_t (&lo)[4][4], uint32_t tile) {
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int nb = 0; nb < NDB; ++nb) {
      const uint64_t d =
          sw128_desc(tile + nb * (TB_ROWS * SW_ROW) + t * 2 * SW_ATOM, TB_ROWS * SW_ROW, SW_ATOM);
      wgmma_rs_tb(acc[nb], hi[t], d);
      wgmma_rs_tb(acc[nb], lo[t], d);
    }
  }
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int nb = 0; nb < NDB; ++nb) reg_fence(acc[nb]);
}

// DQ false, dK/dV: one block per (64 keys, query head h, batch); resident
// tiles r0 = K, r1 = V of h's KV head; streamed tiles s0 = Q, s1 = dO of h.
// Writes h's float32 partials: part[0] = dV, part[1] = dK·scale, each
// (B, H, S, HD).
// DQ true, dQ: one block per (64 query rows, head, batch); resident
// r0 = Q, r1 = dO; streamed s0 = K, s1 = V. Writes dQ·scale in bf16.
// Warpgroup w multiplies resident tile w by streamed tile w (Sᵀ or S for
// w = 0, dPᵀ or dP for w = 1); its accumulator rows are the resident tile's
// positions and its columns the streamed tile's.
template <int HD, bool DQ>
__global__ void __launch_bounds__(TB_THREADS, 1)
    flash_bwd_tc_kernel(const __grid_constant__ CUtensorMap tm_r0,
                        const __grid_constant__ CUtensorMap tm_r1,
                        const __grid_constant__ CUtensorMap tm_s0,
                        const __grid_constant__ CUtensorMap tm_s1, const float* __restrict__ lse,
                        const float* __restrict__ D, float* __restrict__ part,
                        __nv_bfloat16* __restrict__ dq, long long dqb, long long dqh,
                        long long dqs, int B, int H, int K, int S, int causal, int window,
                        float scale, float scale_log2) {
  using Sh = BwdShape<HD>;
  constexpr int NDB = Sh::NDB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + SW_ATOM - 1) & ~uint32_t(SW_ATOM - 1);
  const uint32_t sRes = base;                  // resident tile w at sRes + w·TILE
  const uint32_t sRing = base + 2 * Sh::TILE;  // stage s, streamed tile w: + (2s + w)·TILE
  float* xbuf = reinterpret_cast<float*>(smem_raw + (base - raw) + Sh::X_OFF);
  const uint32_t bar_res = base + Sh::BAR_OFF;  // resident tiles arrived
  const uint32_t bar_full = bar_res + 8;        // [2]: stage s arrived
  const uint32_t bar_empty = bar_res + 24;      // [2]: stage s read by both warpgroups

  // dQ: heaviest causal query tiles (the last) first; dK/dV: the first key tiles
  const int n_t = (S + TB_ROWS - 1) / TB_ROWS;
  const int bh = blockIdx.x % (B * H);
  const int own = DQ ? n_t - 1 - (int)(blockIdx.x / (B * H)) : (int)(blockIdx.x / (B * H));
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / K);
  const int p0 = own * TB_ROWS;  // first resident position
  const int p_last = min(p0 + TB_ROWS, S) - 1;
  int t_lo, t_hi;  // the streamed tiles that hold a visible pair
  if (DQ) {
    t_hi = causal ? min(n_t, p_last / TB_ROWS + 1) : n_t;
    t_lo = window > 0 ? max(0, p0 - window + 1) / TB_ROWS : 0;
  } else {
    t_lo = causal ? own : 0;
    t_hi = window > 0 ? min(n_t, (p_last + window - 1) / TB_ROWS + 1) : n_t;
  }
  const int n = t_hi - t_lo;
  const int res_head = DQ ? h : kvh, st_head = DQ ? kvh : h;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar_res, 1);
    mbar_init(bar_full, 1);
    mbar_init(bar_full + 8, 1);
    mbar_init(bar_empty, TB_CONSUMERS);
    mbar_init(bar_empty + 8, TB_CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= TB_CONSUMERS) {  // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(TB_PRODUCER_REGS));
    if (tid == TB_CONSUMERS && n > 0) {
      mbar_expect_tx(bar_res, 2 * Sh::TILE);
#pragma unroll
      for (int db = 0; db < NDB; ++db) {
        tma_load(sRes + db * (TB_ROWS * SW_ROW), &tm_r0, 64 * db, p0, res_head, b, bar_res);
        tma_load(sRes + Sh::TILE + db * (TB_ROWS * SW_ROW), &tm_r1, 64 * db, p0, res_head, b,
                 bar_res);
      }
      for (int t = t_lo; t < t_hi; ++t) {
        const int i = t - t_lo, s = i & 1;
        if (i >= 2) mbar_wait(bar_empty + 8 * s, ((i >> 1) - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t tS = sRing + (2 * s) * Sh::TILE;
        mbar_expect_tx(full, 2 * Sh::TILE);
#pragma unroll
        for (int db = 0; db < NDB; ++db) {
          tma_load(tS + db * (TB_ROWS * SW_ROW), &tm_s0, 64 * db, t * TB_ROWS, st_head, b, full);
          tma_load(tS + Sh::TILE + db * (TB_ROWS * SW_ROW), &tm_s1, 64 * db, t * TB_ROWS,
                   st_head, b, full);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(TB_CONSUMER_REGS));
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int lane = tid & 31;
  const int r0 = ((wtid >> 5) << 4) + (lane >> 2);  // this thread's rows: r0, r0 + 8 of 64
  const int cq = (lane & 3) << 1;                    // its first column in each 8-column group
  const int rp0 = p0 + r0, rp1 = rp0 + 8;           // their resident positions
  const uint32_t tA = sRes + wg * Sh::TILE;
  const float* lse_bh = lse + ((long long)b * H + h) * S;
  const float* d_bh = D + ((long long)b * H + h) * S;
  // dQ: the rows' lse in log2 units (warpgroup 0) or D (warpgroup 1)
  float rv0 = 0.f, rv1 = 0.f;
  if (DQ) {
    const float* src = wg == 0 ? lse_bh : d_bh;
    const float mul = wg == 0 ? LOG2E : 1.f;
    if (rp0 < S) rv0 = src[rp0] * mul;
    if (rp1 < S) rv1 = src[rp1] * mul;
  }

  float acc[NDB][32];
#pragma unroll
  for (int nb = 0; nb < NDB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;

  if (n > 0) mbar_wait(bar_res, 0);
  for (int t = t_lo; t < t_hi; ++t) {
    const int i = t - t_lo, s = i & 1;
    mbar_wait(bar_full + 8 * s, (i >> 1) & 1);
    const uint32_t tS0 = sRing + (2 * s) * Sh::TILE;  // Q (dK/dV) or K (dQ)
    const uint32_t tB = tS0 + wg * Sh::TILE;
    const int c0 = t * TB_ROWS;  // first streamed position

    // resident tile wg · (streamed tile wg)ᵀ: hd/16 steps of k16
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Sh::HDP / 16; ++kk) {
      const uint32_t off = (kk & 3) << 5;
      const uint64_t da = sw128_desc(tA + (kk >> 2) * (TB_ROWS * SW_ROW) + off, 16, SW_ATOM);
      const uint64_t db = sw128_desc(tB + (kk >> 2) * (TB_ROWS * SW_ROW) + off, 16, SW_ATOM);
      wgmma_ss(sc, da, db, kk > 0);
    }
    wgmma_commit();
    // dK/dV: the streamed queries' lse (log2 units) or D, while the product runs
    float cv[8][2];
    if (!DQ) {
      const float* src = wg == 0 ? lse_bh : d_bh;
      const float mul = wg == 0 ? LOG2E : 1.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int qp = c0 + 8 * j + cq + u;
          cv[j][u] = qp < S ? src[qp] * mul : 0.f;
        }
    }
    wgmma_wait0();
    reg_fence(sc);

    // sc[4j + e]: resident row r0 + 8·(e >> 1), streamed column 8j + cq + (e & 1)
    const int qa = DQ ? p0 : c0, ka = DQ ? c0 : p0;  // first query and key of the pair
    const bool masked = (qa + TB_ROWS > S) || (ka + TB_ROWS > S) ||
                        (causal && ka + TB_ROWS - 1 > qa) ||
                        (window > 0 && ka <= qa + TB_ROWS - 1 - window);
    uint32_t hi[4][4], lo[4][4];
    if (wg == 0) {
      // P = exp2(s·scale·log2e − lse·log2e), 0 off the mask
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l2 = DQ ? (e < 2 ? rv0 : rv1) : cv[j][e & 1];
          float p = exp2f(sc[4 * j + e] * scale_log2 - l2);
          if (masked) {
            const int rp = e < 2 ? rp0 : rp1, cp = c0 + 8 * j + cq + (e & 1);
            const int qp = DQ ? rp : cp, kp = DQ ? cp : rp;
            bool ok = qp < S && kp < S;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
            p = ok ? p : 0.f;
          }
          sc[4 * j + e] = p;
        }
      }
      if (i > 0) bar_sync(BAR_X_EMPTY, TB_CONSUMERS);  // warpgroup 1 has read the last P
#pragma unroll
      for (int e = 0; e < 32; ++e) xbuf[e * 128 + wtid] = sc[e];
      bar_arrive(BAR_X_FULL, TB_CONSUMERS);
      if (!DQ) {  // dV += Pᵀ·dO
        split_frags(sc, hi, lo);
        rs_products<NDB>(acc, hi, lo, tS0 + Sh::TILE);
      }
    } else {
      // dS = P ∘ (dP − D); warpgroup 0's thread wtid holds the same elements
      bar_sync(BAR_X_FULL, TB_CONSUMERS);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dv = DQ ? (e < 2 ? rv0 : rv1) : cv[j][e & 1];
          sc[4 * j + e] = xbuf[(4 * j + e) * 128 + wtid] * (sc[4 * j + e] - dv);
        }
      }
      if (i + 1 < n) bar_arrive(BAR_X_EMPTY, TB_CONSUMERS);
      split_frags(sc, hi, lo);
      rs_products<NDB>(acc, hi, lo, tS0);  // dK += dSᵀ·Q, or dQ += dS·K
    }
    mbar_arrive(bar_empty + 8 * s);  // this thread no longer reads stage s
  }

  // rows rp0 / rp1, columns nb·64 + 8j + cq (+1)
  if (DQ) {
    if (wg == 0) return;
    __nv_bfloat16* out = dq + b * dqb + h * dqh;
#pragma unroll
    for (int nb = 0; nb < NDB; ++nb) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = nb * 64 + 8 * j + cq;
        if (col >= HD) continue;
        if (rp0 < S)
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)rp0 * dqs + col) =
              __floats2bfloat162_rn(acc[nb][4 * j] * scale, acc[nb][4 * j + 1] * scale);
        if (rp1 < S)
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)rp1 * dqs + col) =
              __floats2bfloat162_rn(acc[nb][4 * j + 2] * scale, acc[nb][4 * j + 3] * scale);
      }
    }
  } else {
    const float mul = wg == 0 ? 1.f : scale;
    float* out = part + (((long long)wg * B + b) * H + h) * S * HD;
#pragma unroll
    for (int nb = 0; nb < NDB; ++nb) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = nb * 64 + 8 * j + cq;
        if (col >= HD) continue;
        if (rp0 < S)
          *reinterpret_cast<float2*>(out + (long long)rp0 * HD + col) =
              make_float2(acc[nb][4 * j] * mul, acc[nb][4 * j + 1] * mul);
        if (rp1 < S)
          *reinterpret_cast<float2*>(out + (long long)rp1 * HD + col) =
              make_float2(acc[nb][4 * j + 2] * mul, acc[nb][4 * j + 3] * mul);
      }
    }
  }
}

// dK and dV: each KV head's g partials (part[1] and part[0], (B, H, S, hd)
// float32) summed over its group in head order, head 0 first, then
// rounded once to bf16. One thread per 4 columns of one row of dK or dV.
__global__ void __launch_bounds__(256)
    flash_bwd_sum_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int B, int H, int K, int S, int hd,
                         BwdStrides st, long long n4) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * n4) return;
  const int which = idx >= n4;  // 0: dV, 1: dK
  long long e = idx - which * n4;
  const int hd4 = hd >> 2;
  const int c = (int)(e % hd4) * 4;
  e /= hd4;
  const int s = (int)(e % S);
  e /= S;
  const int kvh = (int)(e % K);
  const int b = (int)(e / K);
  const int g = H / K;
  const long long head_stride = (long long)S * hd;
  const float* src =
      part + ((((long long)which * B + b) * H + (long long)kvh * g) * S + s) * hd + c;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int hh = 1; hh < g; ++hh) {
    const float4 x = *reinterpret_cast<const float4*>(src + hh * head_stride);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  __nv_bfloat16* out = which ? dk + b * st.dkb + kvh * st.dkh + (long long)s * st.dks + c
                             : dv + b * st.dvb + kvh * st.dvh + (long long)s * st.dvs + c;
  const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x, acc.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z, acc.w);
  uint2 packed;
  packed.x = *reinterpret_cast<const uint32_t*>(&lo);
  packed.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out) = packed;
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* o, const void* g,
              const float* lse, float* D, float* part, void* dq, void* dk, void* dv, int B,
              int H, int K, int S, const BwdStrides& st, int causal, int window, float scale,
              cudaStream_t stream) {
  constexpr int smem = BwdShape<HD>::SMEM;
  static int dkdv_set[rt::kMaxDevices], dq_set[rt::kMaxDevices];
  cudaError_t e = rt::max_dynamic_smem(
      reinterpret_cast<const void*>(flash_bwd_tc_kernel<HD, false>), smem, dkdv_set);
  if (e != cudaSuccess) return (int)e;
  e = rt::max_dynamic_smem(reinterpret_cast<const void*>(flash_bwd_tc_kernel<HD, true>), smem,
                           dq_set);
  if (e != cudaSuccess) return (int)e;
  if (part == nullptr) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H * S;
  const long long dot_blocks = (rows + BW_THREADS / 32 - 1) / (BW_THREADS / 32);
  const long long blocks = (long long)((S + TB_ROWS - 1) / TB_ROWS) * B * H;
  const long long n4 = (long long)B * K * S * (HD / 4);
  const long long sum_blocks = (2 * n4 + 255) / 256;
  if (dot_blocks > 2147483647LL || blocks > 2147483647LL || sum_blocks > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tg;
  if (!encode_map(&tq, q, HD, S, H, B, st.qb, st.qh, st.qs, TB_ROWS) ||
      !encode_map(&tk, k, HD, S, K, B, st.kb, st.kh, st.ks, TB_ROWS) ||
      !encode_map(&tv, v, HD, S, K, B, st.vb, st.vh, st.vs, TB_ROWS) ||
      !encode_map(&tg, g, HD, S, H, B, st.gb, st.gh, st.gs, TB_ROWS))
    return (int)cudaErrorInvalidValue;
  flash_bwd_dot_kernel<__nv_bfloat16><<<(unsigned)dot_blocks, BW_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(g), D, H, S, HD,
      st, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = scale * LOG2E;
  flash_bwd_tc_kernel<HD, false><<<(unsigned)blocks, TB_THREADS, smem, stream>>>(
      tk, tv, tq, tg, lse, D, part, nullptr, 0, 0, 0, B, H, K, S, causal, window, scale,
      scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_tc_kernel<HD, true><<<(unsigned)blocks, TB_THREADS, smem, stream>>>(
      tq, tg, tk, tv, lse, D, nullptr, static_cast<__nv_bfloat16*>(dq), st.dqb, st.dqh, st.dqs,
      B, H, K, S, causal, window, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_sum_kernel<<<(unsigned)sum_blocks, 256, 0, stream>>>(
      part, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, H, K, S, HD, st,
      n4);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const void*, const void*, const void*, const void*, const void*,
                         const float*, float*, float*, void*, void*, void*, int, int, int, int,
                         const BwdStrides&, int, int, float, cudaStream_t);

LaunchFn pick(int dtype, int hd) {
  const bool bf = dtype == rt::kBF16;
  if (dtype != rt::kF32 && !bf) return nullptr;
  switch (hd) {
    case 16: return bf ? launch_tc<16> : launch_fma<16>;
    case 32: return bf ? launch_tc<32> : launch_fma<32>;
    case 64: return bf ? launch_tc<64> : launch_fma<64>;
    case 128: return bf ? launch_tc<128> : launch_fma<128>;
    case 256: return bf ? launch_tc<256> : launch_fma<256>;
    default: return nullptr;
  }
}

}  // namespace

// strides: 24 element strides, (batch, head, seq) for q, k, v, o, dO, dq,
// dk and dv in that order; the head_dim axis of every tensor has stride 1.
// lse: (B, H, S) float32 from the forward; D: (B, H, S) float32 scratch;
// part: bfloat16 only, (2, B, H, S, hd) float32 scratch for the per-head
// dV and dK partials (null for float32).
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse, void* D,
                                      void* part, void* dq, void* dk, void* dv, int B, int H,
                                      int K, int S, int hd, const long long* strides, int causal,
                                      int window, float scale, int dtype, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || S <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const LaunchFn fn = pick(dtype, hd);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const long long* t = strides;
  BwdStrides st{t[0],  t[1],  t[2],  t[3],  t[4],  t[5],  t[6],  t[7],
                t[8],  t[9],  t[10], t[11], t[12], t[13], t[14], t[15],
                t[16], t[17], t[18], t[19], t[20], t[21], t[22], t[23]};
  return fn(q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(D),
            static_cast<float*>(part), dq, dk, dv, B, H, K, S, st, causal, window, scale,
            static_cast<cudaStream_t>(stream));
}
