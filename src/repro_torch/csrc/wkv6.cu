// WKV6 (RWKV-6 / Finch) recurrence, forward, per (batch, head):
//   y_t     = S_t^T r_t + (r_t . (u * k_t)) v_t
//   S_{t+1} = diag(exp(w_t)) S_t + k_t v_t^T
// with the N x N float32 state S (k-dim -> v-dim) starting from state_in;
// returns y in r's type and the final state in float32.
//
// Replaces: src/repro/kernels/rwkv6.py::wkv6 (pallas_call at :83, body
// _wkv6_kernel at :22).
//
// Bound on the H100: memory. r, k, v (2 bytes each in bf16), wlog (4
// bytes) and y are read or written once, plus the two states: at the serve
// shape (B=4, H=32, S=512, N=64) ~46 MB, ~14 us at 3.35 TB/s. The
// arithmetic is ~4 flops per state element per token (~1.1 GFLOP, ~16 us
// at the 67 TFLOP/s float32 rate), so the two limits are close.
//
// Design: the original per-token RWKV CUDA form, not the TPU's chunked
// matrix form. One block per (b, h) with N threads; thread j owns column j
// of the state (N floats in registers) and walks the tokens in order, the
// loop that replaces the TPU's sequential chunk grid axis. Each pass stages
// CH tokens of r, k, v and exp(wlog) in shared memory (coalesced loads,
// 32 KB for every N), so the token loop reads them as broadcasts with one
// barrier per CH tokens; y_t's dot product over i runs in four partial
// sums. Only exp of wlog <= 0 is taken: no exponent is positive, so a
// strong decay (wlog = -8) cannot overflow. Any S works; the last pass is
// short. Inputs are read through element strides (the
// head axis contiguous), so the model's (B, S, H, N) projections are
// passed as (B, H, S, N) views, and y is written the same way. Built for
// N = 8, 16, 32 and 64: the reduced and the full rwkv6-1.6b's head sizes
// (16, 64) and every size the reference's own test sweeps. At N = 8 a
// block is a quarter warp and a pass stages 256 tokens; nothing in the
// kernel assumes whole warps (barriers only, no shuffles).
//
// B*H blocks of N threads (128 blocks of 64 at the serve shape) cannot
// hide the latency of 132 SMs; a chunked tensor-core form is later work.
#include "common.cuh"

namespace {

struct Strides {
  long long rb, rh, rs, kb, kh, ks, vb, vh, vs, wb, wh, ws, yb, yh, ys;
};

template <typename T, int N>
__global__ void __launch_bounds__(N)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ wlog, const float* __restrict__ u,
                const float* __restrict__ s_in, T* __restrict__ y, float* __restrict__ s_out,
                int H, int S, Strides st) {
  constexpr int CH = 2048 / N;  // tokens per shared-memory pass
  __shared__ __align__(16) float sr[CH][N];
  __shared__ __align__(16) float sk[CH][N];
  __shared__ __align__(16) float sv[CH][N];
  __shared__ __align__(16) float sw[CH][N];
  __shared__ __align__(16) float su[N];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int j = threadIdx.x;
  su[j] = u[(long long)h * N + j];

  float s[N];  // column j of the state: s[i] = S[i][j]
  const float* s0 = s_in + (long long)bh * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = s0[i * N + j];

  const T* rp = r + b * st.rb + h * st.rh + j;
  const T* kp = k + b * st.kb + h * st.kh + j;
  const T* vp = v + b * st.vb + h * st.vh + j;
  const float* wp = wlog + b * st.wb + h * st.wh + j;
  T* yp = y + b * st.yb + h * st.yh + j;

  for (int t0 = 0; t0 < S; t0 += CH) {
    const int n = min(CH, S - t0);
    __syncthreads();  // the previous pass is done with the staged tokens
#pragma unroll 8
    for (int tt = 0; tt < n; ++tt) {
      const long long t = t0 + tt;
      sr[tt][j] = rt::to_f(rp[t * st.rs]);
      sk[tt][j] = rt::to_f(kp[t * st.ks]);
      sv[tt][j] = rt::to_f(vp[t * st.vs]);
      sw[tt][j] = expf(wp[t * st.ws]);
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sv[tt][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};  // four partial sums: a shorter dependent chain
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float kv = sk[tt][i] * vj;
        acc[i & 3] += sr[tt][i] * (su[i] * kv + s[i]);
        s[i] = s[i] * sw[tt][i] + kv;
      }
      yp[(long long)(t0 + tt) * st.ys] = rt::from_f<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }

  float* sT = s_out + (long long)bh * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) sT[i * N + j] = s[i];
}

template <typename T>
int dispatch_n(int N, const void* r, const void* k, const void* v, const void* wlog,
               const void* u, const void* s_in, void* y, void* s_out, int B, int H, int S,
               const Strides& st, cudaStream_t stream) {
  const unsigned blocks = (unsigned)B * (unsigned)H;
#define RT_WKV6_CASE(NN)                                                                      \
  case NN:                                                                                    \
    wkv6_kernel<T, NN><<<blocks, NN, 0, stream>>>(                                            \
        static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),         \
        static_cast<const float*>(wlog), static_cast<const float*>(u),                        \
        static_cast<const float*>(s_in), static_cast<T*>(y), static_cast<float*>(s_out), H, S, \
        st);                                                                                  \
    break;
  switch (N) {
    RT_WKV6_CASE(8)
    RT_WKV6_CASE(16)
    RT_WKV6_CASE(32)
    RT_WKV6_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_WKV6_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// strides: r, k, v, wlog, y, each (batch, head, token) in elements; the
// head_dim axis has stride 1. u is (H, N) and the states (B, H, N, N),
// contiguous float32.
extern "C" int rt_wkv6(const void* r, const void* k, const void* v, const void* wlog,
                       const void* u, const void* s_in, void* y, void* s_out, int B, int H,
                       int S, int N, const long long* strides, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long* p = strides;
  Strides st{p[0], p[1], p[2],  p[3],  p[4],  p[5],  p[6], p[7],
             p[8], p[9], p[10], p[11], p[12], p[13], p[14]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return dispatch_n<float>(N, r, k, v, wlog, u, s_in, y, s_out, B, H, S, st, s);
  if (dtype == rt::kBF16)
    return dispatch_n<__nv_bfloat16>(N, r, k, v, wlog, u, s_in, y, s_out, B, H, S, st, s);
  return (int)cudaErrorInvalidValue;
}
