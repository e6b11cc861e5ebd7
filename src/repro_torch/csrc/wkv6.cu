// WKV6 (RWKV-6 / Finch) recurrence, forward, per (batch, head):
//   y_t     = S_t^T r_t + bonus_t v_t,   bonus_t = r_t . (u * k_t)
//   S_{t+1} = diag(exp(w_t)) S_t + k_t v_t^T
// with the N x N float32 state S (k-dim -> v-dim) starting from state_in;
// returns y in r's type and the final state in float32.
//
// Replaces: src/repro/kernels/rwkv6.py::wkv6 (pallas_call at :83, body
// _wkv6_kernel at :24).
//
// Bound on the H100: memory, barely. r, k, v (2 bytes each in bf16), wlog
// (4 bytes) and y are read or written once, plus the two states: at the
// serve shape (B=4, H=32, S=512, N=64) 54.5 MB, 16.3 us at 3.35 TB/s. The
// arithmetic is 4 flops per state element per token (1.07 GFLOP, 16.0 us
// at the 67 TFLOP/s float32 rate). This per-token FMA form costs at least
// 3 FP instructions per state element per token (acc += r_i s_i, kv = k_i
// v_j, s_i = s_i w_i + kv): ~24 us of issue on 132 SMs, ~35 us with its
// shared loads. Reaching the 16 us bound takes the chunked tensor-core
// form of the TPU kernel (later work).
//
// Design: the per-token RWKV form, the loop over tokens replacing the
// TPU's sequential chunk grid axis, with the state spread over many warps
// and each shared load used for several state elements.
//  - A thread carries an R x C tile of the state: R rows of C columns
//    (Tile<N>; 4 x 4 at N = 64) in registers. The G = N / R threads that
//    share a group of C columns are adjacent lanes (row group g = lane %
//    G), and a block owns a slab of JC columns of one (b, h): B * H * N /
//    JC blocks of JC / C * G threads (512 blocks of 64 at the serve shape,
//    ~4 an SM, every block resident in one wave; rt_wkv6_plan reports the
//    occupancy).
//  - Per token a thread reads its R rows of r, k and exp(w) and its C
//    values of v as float4s from the staged tile (one 16-byte load per 4
//    state elements at 4 x 4), then does 3 FP instructions per element:
//    acc_c += r_i s_ic in row order, s_ic = s_ic w_i + k_i v_c.
//  - y_t sums acc over the G row groups: a butterfly whose first log2(C)
//    steps also halve what a lane carries (it keeps the columns whose bit
//    matches its own), so lane g ends with column g % C. The sums of U = 8
//    tokens go out step by step together, so that their shuffle latencies
//    overlap instead of chaining token after token.
//  - The bonus r_t . (u * k_t) is one scalar per token: its products are
//    staged with the tile and summed once per token (in a few parts, row
//    order), so u never enters the inner loop.
//  - Staging: TT = 32 tokens of r, k, exp(w) and the bonus products at N
//    wide and of v at the slab's JC wide, plain coalesced loads, all of a
//    thread's loads out before any is used; a whole tile walks each array
//    by a fixed step per pass (35.2 KB a block at N = 64). r, k and w are
//    staged by each of a (b, h)'s N / JC slabs: the repeats hit L2.
// Only exp of wlog <= 0 is taken, once per staged element: no exponent is
// positive, so a strong decay (wlog = -8) cannot overflow. Any S works;
// a short last tile stages r = k = v = 0 and exp(w) = 1 past the end,
// which leaves the state exactly as it is. Inputs are read through element
// strides (the head axis contiguous), so the model's (B, S, H, N)
// projections are passed as (B, H, S, N) views, and y is written the same
// way. Built for N = 8, 16, 32 and 64: the reduced and the full
// rwkv6-1.6b's head sizes (16, 64) and every size the reference's own test
// sweeps. One launch per call; no block waits for another, and nothing
// outlives the call. kernels/rwkv6.py::launch_plan mirrors Tile<N>.
#include <type_traits>

#include "wkv6.cuh"

namespace {

using namespace wkv6;

// The element strides: r, k, v, wlog, y, each (batch, head, token)
struct Strides {
  long long rb, rh, rs, kb, kh, ks, vb, vh, vs, wb, wh, ws, yb, yh, ys;
};

template <int N>
struct Plan {
  static constexpr int R = Tile<N>::R, C = Tile<N>::C, JC = Tile<N>::JC;
  static constexpr int G = N / R;                   // row groups: lanes of one column group
  static constexpr int SLABS = N / JC;              // blocks per (b, h)
  static constexpr int THREADS = JC / C * G;
  static constexpr int PARTS = THREADS / TT;        // threads summing one token's bonus
  static constexpr int PITCH = N + 1;               // of the products' tile: conflict-free rows
  static constexpr int SMEM =
      (3 * TT * N + TT * PITCH + TT * JC + PARTS * TT) * (int)sizeof(float);
  static_assert(N % JC == 0 && JC % C == 0 && C <= G && G <= 32 && 32 % G == 0,
                "a column group's lanes lie in one warp and hold its C columns after the sum");
  static_assert(THREADS % 32 == 0 && THREADS % N == 0 && THREADS % TT == 0 && N % PARTS == 0,
                "whole warps; each thread stages one row; each token's bonus in equal parts");
  static_assert(SMEM <= 48 * 1024, "the tile fits the static shared memory limit");
  static_assert(TT % U == 0, "a tile is whole batches of tokens");
};

template <typename T, int N>
__global__ void __launch_bounds__(Plan<N>::THREADS)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ wlog, const float* __restrict__ u,
                const float* __restrict__ s_in, T* __restrict__ y, float* __restrict__ s_out,
                int H, int S, Strides st) {
  using P = Plan<N>;
  constexpr int R = P::R, C = P::C, G = P::G, JC = P::JC, NT = P::THREADS;
  constexpr int PASSES = TT * N / NT;          // staging passes of r, k and w per tile
  constexpr int VP = TT * JC / NT;             // staging passes of v per tile
  constexpr int L = N / P::PARTS;              // rows of one part of a token's bonus
  __shared__ __align__(16) float sr[TT][N];
  __shared__ __align__(16) float sk[TT][N];
  __shared__ __align__(16) float sw[TT][N];
  __shared__ __align__(16) float sv[TT][JC];
  __shared__ float sp[TT][P::PITCH];  // r_i * (u_i * k_i)
  __shared__ float sb[P::PARTS][TT];  // the parts of bonus_t

  const int bh = blockIdx.x / P::SLABS;
  const int j0 = blockIdx.x % P::SLABS * JC;  // the slab's first column
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int g = tid % G;                 // row group
  const int c0 = tid / G * C;            // the thread's first column within the slab
  const int i0 = g * R;

  float s[R][C];  // s[q][c] = S[i0 + q][j0 + c0 + c]
  const float* s0 = s_in + (long long)bh * N * N + j0 + c0;
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int c = 0; c < C; ++c) s[q][c] = s0[(i0 + q) * N + c];

  // Staging: element e = pass * NT + tid of a TT x N tile is token e / N,
  // row e % N; NT is a multiple of N, so a thread stages one row (si).
  const int si = tid % N;
  const float usi = u[(long long)h * N + si];
  const T* rp = r + b * st.rb + h * st.rh + si;
  const T* kp = k + b * st.kb + h * st.kh + si;
  const float* wp = wlog + b * st.wb + h * st.wh + si;
  const int vc = tid % JC;  // the slab column this thread stages of v
  const T* vp = v + b * st.vb + h * st.vh + j0 + vc;
  // After the sums lane g holds column c0 + g % C.
  T* yp = y + b * st.yb + h * st.yh + j0 + c0 + g % C;

  // Stages the tile of n tokens from t0: all loads go out before any is
  // used. A whole tile (FULL) walks each array by a fixed step per pass; in
  // a short one a token past the end reads the last one (in bounds) and
  // stages r = k = v = 0 and exp(w) = 1.
  const int tq = tid / N, vq = tid / JC;  // the thread's first token in a pass
  auto stage = [&](auto full, int t0, int n) {
    constexpr bool FULL = decltype(full)::value;
    T rv[PASSES], kv[PASSES], vv[VP];
    float wv[PASSES];
    const T* ra = rp + (t0 + tq) * st.rs;
    const T* ka = kp + (t0 + tq) * st.ks;
    const float* wa = wp + (t0 + tq) * st.ws;
    const T* va = vp + (t0 + vq) * st.vs;
#pragma unroll
    for (int q = 0; q < VP; ++q) {
      const int tt = q * (NT / JC) + vq;
      vv[q] = va[(FULL ? q * (NT / JC) : min(tt, n - 1) - vq) * st.vs];
    }
#pragma unroll
    for (int q = 0; q < PASSES; ++q) {
      const int tt = q * (NT / N) + tq;
      const long long o = FULL ? q * (NT / N) : min(tt, n - 1) - tq;
      rv[q] = ra[o * st.rs];
      kv[q] = ka[o * st.ks];
      wv[q] = wa[o * st.ws];
    }
#pragma unroll
    for (int q = 0; q < PASSES; ++q) {
      const int tt = q * (NT / N) + tq;
      const bool in = FULL || tt < n;
      const float rf = in ? rt::to_f(rv[q]) : 0.f;
      const float kf = in ? rt::to_f(kv[q]) : 0.f;
      sr[tt][si] = rf;
      sk[tt][si] = kf;
      sw[tt][si] = in ? expf(wv[q]) : 1.f;
      sp[tt][si] = rf * (usi * kf);
    }
#pragma unroll
    for (int q = 0; q < VP; ++q) {
      const int tt = q * (NT / JC) + vq;
      sv[tt][vc] = FULL || tt < n ? rt::to_f(vv[q]) : 0.f;
    }
  };

  for (int t0 = 0; t0 < S; t0 += TT) {
    const int n = min(TT, S - t0);
    __syncthreads();  // the previous tile is consumed
    if (n == TT)
      stage(std::true_type{}, t0, n);
    else
      stage(std::false_type{}, t0, n);
    __syncthreads();
    {  // bonus_t in PARTS parts of L rows, each summed in row order
      const int tt = tid % TT, part = tid / TT;
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < L; ++q) sum += sp[tt][part * L + q];
      sb[part][tt] = sum;
    }
    __syncthreads();
    // U tokens at a time; a token past the end staged r = k = v = 0 and
    // exp(w) = 1, which leaves the state exactly as it is.
    for (int u0 = 0; u0 < n; u0 += U) {
      float acc[U][C];
#pragma unroll
      for (int x = 0; x < U; ++x) {
        float rr[R], kk[R], ww[R], vj[C];
        load_vec<R>(rr, &sr[u0 + x][i0]);
        load_vec<R>(kk, &sk[u0 + x][i0]);
        load_vec<R>(ww, &sw[u0 + x][i0]);
        load_vec<C>(vj, &sv[u0 + x][c0]);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[x][c] = 0.f;
#pragma unroll
        for (int q = 0; q < R; ++q)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            acc[x][c] = fmaf(rr[q], s[q][c], acc[x][c]);
            s[q][c] = fmaf(s[q][c], ww[q], kk[q] * vj[c]);
          }
      }
      group_sums<U, C, G>(acc, g);
#pragma unroll
      for (int x = 0; x < U; ++x) {
        const int tt = u0 + x;
        float bonus = sb[0][tt];
#pragma unroll
        for (int part = 1; part < P::PARTS; ++part) bonus += sb[part][tt];
        // the G / C lanes of a column hold the same sum: all store it
        if (tt < n)
          yp[(long long)(t0 + tt) * st.ys] =
              rt::from_f<T>(fmaf(bonus, sv[tt][c0 + g % C], acc[x][0]));
      }
    }
  }

  float* sT = s_out + (long long)bh * N * N + j0 + c0;
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int c = 0; c < C; ++c) sT[(i0 + q) * N + c] = s[q][c];
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const void* wlog, const void* u,
           const void* s_in, void* y, void* s_out, int B, int H, int S, const Strides& st,
           cudaStream_t stream) {
  using P = Plan<N>;
  const long long blocks = (long long)B * H * P::SLABS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  wkv6_kernel<T, N><<<(unsigned)blocks, P::THREADS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(wlog), static_cast<const float*>(u),
      static_cast<const float*>(s_in), static_cast<T*>(y), static_cast<float*>(s_out), H, S, st);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(int N, const void* r, const void* k, const void* v, const void* wlog,
               const void* u, const void* s_in, void* y, void* s_out, int B, int H, int S,
               const Strides& st, cudaStream_t stream) {
  switch (N) {
    case 8: return launch<T, 8>(r, k, v, wlog, u, s_in, y, s_out, B, H, S, st, stream);
    case 16: return launch<T, 16>(r, k, v, wlog, u, s_in, y, s_out, B, H, S, st, stream);
    case 32: return launch<T, 32>(r, k, v, wlog, u, s_in, y, s_out, B, H, S, st, stream);
    case 64: return launch<T, 64>(r, k, v, wlog, u, s_in, y, s_out, B, H, S, st, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out: threads per block, static shared bytes, blocks per (b, h), blocks
// resident on one SM of the current device
template <typename T, int N>
int plan(int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, wkv6_kernel<T, N>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], wkv6_kernel<T, N>,
                                                      Plan<N>::THREADS, 0);
  out[0] = Plan<N>::THREADS;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = Plan<N>::SLABS;
  return (int)e;
}

template <typename T>
int plan_n(int N, int* out) {
  switch (N) {
    case 8: return plan<T, 8>(out);
    case 16: return plan<T, 16>(out);
    case 32: return plan<T, 32>(out);
    case 64: return plan<T, 64>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: r, k, v, wlog, y, each (batch, head, token) in elements; the
// head_dim axis has stride 1. u is (H, N) and the states (B, H, N, N),
// contiguous float32.
extern "C" int rt_wkv6(const void* r, const void* k, const void* v, const void* wlog,
                       const void* u, const void* s_in, void* y, void* s_out, int B, int H,
                       int S, int N, const long long* strides, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const long long* p = strides;
  const Strides st{p[0], p[1], p[2],  p[3],  p[4],  p[5],  p[6], p[7],
                   p[8], p[9], p[10], p[11], p[12], p[13], p[14]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return dispatch_n<float>(N, r, k, v, wlog, u, s_in, y, s_out, B, H, S, st, s);
  if (dtype == rt::kBF16)
    return dispatch_n<__nv_bfloat16>(N, r, k, v, wlog, u, s_in, y, s_out, B, H, S, st, s);
  return (int)cudaErrorInvalidValue;
}

// The (dtype, N) instantiation's launch plan, into out[4]: threads per
// block, static shared memory bytes, blocks per (b, h) and blocks resident
// on one SM of the current device (the wave a grid of B * H * out[2]
// blocks has to fit).
extern "C" int rt_wkv6_plan(int dtype, int N, int* out) {
  if (dtype == rt::kF32) return plan_n<float>(N, out);
  if (dtype == rt::kBF16) return plan_n<__nv_bfloat16>(N, out);
  return (int)cudaErrorInvalidValue;
}
