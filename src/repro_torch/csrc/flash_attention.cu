// Blocked causal / sliding-window GQA attention, forward only, for prefill
// self-attention with positions 0..S-1.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (pallas_call at :99, body _flash_kernel at :26).
//
// Bound on the H100: at the serve shape (B=4, H=8, K=1, S=512, hd=256,
// bf16) the inputs and output are ~19 MB (~5.6 us at 3.35 TB/s) and the
// causal half of QK^T and PV is ~4.3 GFLOP (~4.4 us at 989 TFLOP/s), so
// both limits are a few microseconds. This first kernel uses plain FMA
// from shared memory, not the tensor cores, and is far from either limit;
// mma/wgmma and TMA are later work.
//
// Design: one block per (q-block of 64 rows, head, batch). The TPU's
// sequential k-block grid axis becomes a loop inside the block, with the
// online-softmax running max, running sum and the float32 accumulator held
// in registers (each of the 256 threads owns one query row and a quarter
// of its head_dim columns). The K/V tiles (32 rows) and the Q tile are
// staged in dynamic shared memory as float32 with a padded row so that the
// column-wise reads hit distinct banks; at hd = 256 that is ~137 KB, above
// the 48 KB static limit, hence cudaFuncSetAttribute. Causal blocks above
// the diagonal and window blocks before it are skipped. S need not divide
// by the block: the ragged edge is masked. Masked scores get weight 0,
// and the final division keeps the Pallas kernel's max(l, 1e-30) guard.
// Inputs are read through element strides, so the model's (B, S, H, hd)
// projections are passed as (B, H, S, hd) views without a copy.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;  // 4 threads per query row

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (HD + 1) + 2 * (size_t)BK * (HD + 1) + (size_t)BQ * (BK + 1));
}

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int H, int K, int S, Strides st, int causal, int window,
                     float scale) {
  constexpr int LD = HD + 1;
  constexpr int LDP = BK + 1;
  constexpr int CPT = HD / 4;  // accumulator columns per thread
  constexpr int SPT = BK / 4;  // scores per thread per k-block
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const int tid = threadIdx.x;
  const int r = tid >> 2;    // query row within the block
  const int quad = tid & 3;  // which quarter of the row's columns / keys
  const int qpos = q0 + r;

  const T* qbase = q + b * st.qb + h * st.qh;
  const T* kbase = k + b * st.kb + kvh * st.kh;
  const T* vbase = v + b * st.vb + kvh * st.vh;

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int rr = idx / HD, dd = idx % HD;
    const int p = q0 + rr;
    sQ[rr * LD + dd] = p < S ? rt::to_f(qbase[(long long)p * st.qs + dd]) : 0.f;
  }

  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.f;
  float m = rt::kNegInit;
  float l = 0.f;

  const int n_kb = (S + BK - 1) / BK;
  int kb_hi = n_kb;
  if (causal) {
    const int last_q = min(q0 + BQ, S) - 1;
    kb_hi = min(n_kb, last_q / BK + 1);
  }
  int kb_lo = 0;
  if (window > 0) {
    const int first_k = q0 - window + 1;  // smallest key any row here may see
    if (first_k > 0) kb_lo = first_k / BK;
  }

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int cc = idx / HD, dd = idx % HD;
      const int p = k0 + cc;
      const bool in = p < S;
      sK[cc * LD + dd] = in ? rt::to_f(kbase[(long long)p * st.ks + dd]) : 0.f;
      sV[cc * LD + dd] = in ? rt::to_f(vbase[(long long)p * st.vs + dd]) : 0.f;
    }
    __syncthreads();

    float s[SPT];
    bool ok[SPT];
    float mloc = rt::kNegInit;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int c = quad + 4 * j;
      const int kpos = k0 + c;
      float dot = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < HD; ++dd) dot += sQ[r * LD + dd] * sK[c * LD + dd];
      dot *= scale;
      bool valid = kpos < S && qpos < S;
      if (causal) valid = valid && kpos <= qpos;
      if (window > 0) valid = valid && kpos > qpos - window;
      ok[j] = valid;
      s[j] = dot;
      if (valid) mloc = fmaxf(mloc, dot);
    }
    // the 4 threads of a row are adjacent lanes of one warp
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
    const float m_new = fmaxf(m, mloc);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const float p = ok[j] ? expf(s[j] - m_new) : 0.f;
      sP[r * LDP + quad + 4 * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's P is written by the same 4 lanes that read it

#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float p = sP[r * LDP + c];
      const float* vr = sV + c * LD + quad;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[j] += p * vr[4 * j];
    }
  }

  if (qpos < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = o + b * st.ob + h * st.oh + (long long)qpos * st.os;
#pragma unroll
    for (int j = 0; j < CPT; ++j) orow[quad + 4 * j] = rt::from_f<T>(acc[j] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int K, int S,
           const Strides& st, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, K, S, st, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B, int H, int K,
                int S, const Strides& st, int causal, int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, K, S, st, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, B, H, K, S, st, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, K, S, st, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, K, S, st, causal, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, B, H, K, S, st, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) for q, k, v and o in that
// order; the head_dim axis of every tensor has stride 1.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                  int H, int K, int S, int hd, const long long* strides,
                                  int causal, int window, float scale, int dtype, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || S <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],  strides[5],
             strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return dispatch_hd<float>(hd, q, k, v, o, B, H, K, S, st, causal, window, scale, s);
  if (dtype == rt::kBF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, K, S, st, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
