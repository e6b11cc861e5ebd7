// WKV6 (RWKV-6 / Finch) recurrence, backward, per (batch, head). With S_t
// the state before token t (S_0 = state_in), the forward is
//   y_t = S_t^T r_t + (r_t . (u * k_t)) v_t,   S_{t+1} = diag(exp(w_t)) S_t + k_t v_t^T.
// Given dy and dS_T (the final state's gradient), dS_t = diag(exp(w_t))
// dS_{t+1} + r_t dy_t^T and, with s_t = v_t . dy_t,
//   dr_t = S_t dy_t + u * k_t s_t         dk_t = dS_{t+1} v_t + u * r_t s_t
//   dv_t = dS_{t+1}^T k_t + (r_t . (u * k_t)) dy_t
//   du = sum over b, t of r_t * k_t s_t   dstate = dS_0
// and the decay's gradient by the pair-counting identity of the RWKV-6
// training kernels (w_t decays exactly the pairs s < t < t'), which never
// holds S_t and dS_{t+1} together. A pair of adjacent tokens (t - 1, t) is
// decayed by no w: it enters both sums below and cancels, so both leave it
// out, which keeps every term the size of dwlog even where the decay is
// strong (wlog = -8: exp(w) ~ 3e-4, and the adjacent pairs would be ~3000x
// dwlog and cancel in float32). With Z_t = exp(w_{t-1}) S_{t-1} (S_t
// without its newest k v^T; Z_0 = state_in) and dZ_t = exp(w_t) dS_{t+1}
// (dS_t without its newest r dy^T; dZ_T = 0):
//   A'_t = r_t * (Z_t dy_t) for t < T,  A'_T = rowsum(Z_T * dS_T),
//   B'_t = k_t * (dZ_{t+1} v_t),
//   dwlog_t = sum_{t' > t} A'_t' - sum_{s >= t} B'_s.
//
// Replaces: no Pallas kernel. The reference's gradient is jax.grad of
// src/repro/models/rwkv6.py::wkv6_chunked; this is the backward of the
// port's forward kernel (wkv6.cu), which replaces
// src/repro/kernels/rwkv6.py::wkv6 (pallas_call at :83).
//
// Bound on the H100: operations. At the training shape (B=4, H=32,
// S=512, N=64) the function carries S and dS and takes S_t dy_t, dS v_t
// and dS^T k_t: 10 float32 flops a state element a token over 2.7e8
// (2.7 GFLOP, 0.040 ms at 67 TFLOP/s); its bytes (r, k, v, dy, wlog read;
// dr, dk, dv, dwlog written; the states) are 99 MB, 0.029 ms at 3.35 TB/s.
// This design does 12 (three passes of the forward's 4) and moves A' (16.8
// MB) through memory once more.
//
// Design: four launches on the stream, no atomics (two calls give the
// same bits), every sum in a fixed order.
//  1. Rows, token order (wkv6_bwd_rows_kernel<.., false>): a block owns a
//     slab of JR rows of one (b, h)'s Z, from state_in; per token it sums
//     Z_t dy_t along each row, adds k_{t-1} (v_{t-1} . dy_t) for S_t dy_t,
//     writes dr_t and A'_t (float32 scratch), then Z_{t+1} = exp(w_t)
//     (Z_t + k_{t-1} v_{t-1}^T); at the end A'_T from dS_T.
//  2. Rows, reverse order (<.., true>): the same blocks carry dZ from dS_T
//     the same way (a = r, b = dy, c = v); per token dk_t, and dwlog_t as
//     one running sum per row (A'_T, then - B'_t, then + A'_t), which
//     stays the size of dwlog; one du partial per (b, h).
//  3. Columns, reverse order: dv and dstate are the forward kernel run
//     backward in time on (r := k, k := r, v := dy, state := dS_T): its
//     y_t is dS_{t+1}^T k_t + (k_t . (u * r_t)) dy_t and its final state
//     dS_0. The host hands it the inputs from their last token with
//     negated token strides.
//  4. du: the B partials of each (h, n) summed in b order.
// The row passes take the forward's Tile<N> transposed: a thread carries
// R = Tile::C rows of C = Tile::R columns, the G = N / C threads of a row
// group are adjacent lanes (their row sums are the forward's butterfly),
// and a block owns JR = Tile::JC rows: the forward's grid (512 blocks of
// 64 threads at the training shape). Per token a thread does 3 FP
// instructions a state element (acc_r += z_rc c_c, z_rc = (z_rc + a'_r
// b'_c) w_r, a' and b' the previous token's). TR = 16 tokens are staged at
// a time: a (one row more: the token before the tile), m, exp(w) (and A'
// in pass 2) at the slab's JR rows, b (one row more) and c at N wide; the
// products b_t . c_t and b_{t-1} . c_t are summed per token in a few
// parts. Only exp of wlog <= 0 is taken: wlog = -8 cannot overflow. A
// short last tile stages zeros past the end and leaves Z as it is there.
#include <type_traits>

#include "wkv6.cuh"

namespace {

using namespace wkv6;

// tokens per staged tile, and tokens whose row sums go out together (the
// forward stages 32 and sums 8: here the reverse pass's staging and sums
// at those sizes took 255 registers and spilled at N = 64)
constexpr int TR = 16;
constexpr int UR = 4;

template <int N>
struct RowPlan {
  static constexpr int R = Tile<N>::C, C = Tile<N>::R, JR = Tile<N>::JC;
  static constexpr int G = N / C;        // lanes of a row group (they split the columns)
  static constexpr int SLABS = N / JR;   // blocks per (b, h)
  static constexpr int THREADS = JR / R * G;
  static constexpr int PARTS = THREADS / TR;  // threads summing one token's s_t and q_t
  // of the b and c tiles: 16-byte rows for the vector loads, and the
  // per-token sums (a thread a token) read 8 banks, not 1
  static constexpr int PB = N + 4;
  static constexpr int SMEM =
      (3 * TR * JR + (TR + 1) * JR + (2 * TR + 1) * PB + 2 * PARTS * TR) * (int)sizeof(float);
  static_assert(N % JR == 0 && JR % R == 0 && R <= G && G <= 32 && 32 % G == 0,
                "a row group's lanes lie in one warp and hold its R rows after the sum");
  static_assert(JR % 4 == 0, "a token's A' slab is whole 16-byte copies");
  static_assert(THREADS % 32 == 0 && THREADS % N == 0 && THREADS % JR == 0 &&
                    THREADS % TR == 0 && N % PARTS == 0,
                "whole warps; each thread stages one column and one slab row; the sums "
                "in equal parts");
  static_assert(SMEM <= 48 * 1024, "the tile fits the static shared memory limit");
  static_assert(TR % UR == 0, "a tile is whole batches of tokens");
};

// A (B, H, S, N) tensor read or written through element strides (the head
// axis contiguous); the host points p at the last token and negates t for
// a pass in reverse order.
template <typename E>
struct View {
  E* p;
  long long b, h, t;
};

template <typename E>
View<E> reversed(View<E> x, int S) {
  x.p += (long long)(S - 1) * x.t;
  x.t = -x.t;
  return x;
}

// Pass 1 (SECOND false), token order: a = k, m = r, bv = v, cv = dy, the
// state Z from s_in = state_in; g gets dr, xa gets A'_t, fin gets A'_T
// (dS_T read from ds_T).
// Pass 2 (SECOND true), reverse order: a = r, m = k, bv = dy, cv = v, the
// state dZ from s_in = dS_T (its first step's B' is 0: dZ_T = 0); g gets
// dk, xa holds A'_t, fin holds A'_T, dw gets dwlog, du_part one row of
// partials per (b, h).
// Per step (token t of the pass): out' = X c_t along each row, q_t =
// b_{t-1} . c_t, s_t = b_t . c_t; g_t = out' + a_{t-1} q_t + u a_t s_t; the
// row's term m_t out'; X = (X + a_{t-1} b_{t-1}^T) exp(w_t).
template <typename T, int N, bool SECOND>
__global__ void __launch_bounds__(RowPlan<N>::THREADS)
    wkv6_bwd_rows_kernel(View<const T> a, View<const T> m, View<const T> bv, View<const T> cv,
                         View<const float> w, View<float> xa, View<T> g, View<float> dw,
                         const float* __restrict__ u, const float* __restrict__ s_in,
                         const float* __restrict__ ds_T, float* __restrict__ fin,
                         float* __restrict__ du_part, int H, int S) {
  using P = RowPlan<N>;
  constexpr int R = P::R, C = P::C, G = P::G, JR = P::JR, NT = P::THREADS, PB = P::PB;
  constexpr int SP = TR * JR / NT;  // staging passes of the slab's arrays per tile
  constexpr int CP = TR * N / NT;   // staging passes of b and c per tile
  constexpr int L = N / P::PARTS;   // columns of one part of the per-token sums
  // sa and sbv: row 0 is the token before the tile, row x + 1 token x
  __shared__ __align__(16) float sa[TR + 1][JR];
  __shared__ __align__(16) float sm[TR][JR];
  __shared__ __align__(16) float sw[TR][JR];  // exp(w)
  __shared__ __align__(16) float sx[TR][JR];  // A'_t (pass 2)
  __shared__ __align__(16) float sbv[TR + 1][PB];
  __shared__ __align__(16) float scv[TR][PB];
  __shared__ float ss[P::PARTS][TR];  // the parts of s_t = b_t . c_t
  __shared__ float sq[P::PARTS][TR];  // the parts of q_t = b_{t-1} . c_t

  const int bh = blockIdx.x / P::SLABS;
  const int r0 = blockIdx.x % P::SLABS * JR;  // the slab's first row
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int gl = tid % G;       // the lane within its row group: columns gl * C on
  const int j0 = gl * C;
  const int i0 = tid / G * R;   // the thread's first row within the slab
  const int io = i0 + gl % R;   // its row after the sums

  float z[R][C];  // z[q][c] = X[r0 + i0 + q][j0 + c]
  const float* z0 = s_in + (long long)bh * N * N + (long long)(r0 + i0) * N + j0;
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int c = 0; c < C; ++c) z[q][c] = z0[q * N + c];

  const float u_o = u[(long long)h * N + r0 + io];
  // the dwlog running sum of the lane's row: A'_T, then - B'_t + A'_t a step
  float run = SECOND ? fin[(long long)bh * N + r0 + io] : 0.f;
  float du_acc = 0.f;

  // Staging: element e = pass * NT + tid of a TR x JR tile is token e / JR,
  // row e % JR (si); of a TR x N tile token e / N, column e % N (sj). The
  // thread that stages token TR - 1 of a row or column keeps it for row 0
  // of the next tile (a_last, b_last): no other thread touches either.
  const int si = tid % JR, sq0 = tid / JR;
  const int sj = tid % N, cq0 = tid / N;
  const T* ap = a.p + b * a.b + h * a.h + r0 + si + sq0 * a.t;
  const T* mp = m.p + b * m.b + h * m.h + r0 + si + sq0 * m.t;
  const float* wp = w.p + b * w.b + h * w.h + r0 + si + sq0 * w.t;
  const float* xp = xa.p + b * xa.b + h * xa.h + r0;  // A' of the slab (pass 2)
  const T* bp = bv.p + b * bv.b + h * bv.h + sj + cq0 * bv.t;
  const T* cp = cv.p + b * cv.b + h * cv.h + sj + cq0 * cv.t;
  T* gp = g.p + b * g.b + h * g.h + r0 + io;
  float* xo = xa.p + b * xa.b + h * xa.h + r0 + io;
  float* dwp = dw.p + b * dw.b + h * dw.h + r0 + io;
  float a_last = 0.f, b_last = 0.f;

  // Stages the tile of n tokens from t0, all loads out before any is
  // used; A' (pass 2, float32 rows of the scratch) by 16-byte async copies,
  // which hold no registers. In a short tile a token past the end reads
  // the last one (in bounds) and stages zeros and exp(w) = 1.
  auto stage = [&](auto full, int t0, int n) {
    constexpr bool FULL = decltype(full)::value;
    if constexpr (SECOND) {
      for (int e = tid; e < TR * JR / 4; e += NT) {
        const int tt = e / (JR / 4), c4 = e % (JR / 4) * 4;
        const bool in = FULL || tt < n;
        rt::cp_async16(&sx[tt][c4], xp + c4 + (long long)(t0 + (in ? tt : 0)) * xa.t,
                       in ? 16 : 0);
      }
      rt::cp_async_commit();
    }
    T av[SP], mv[SP], bw[CP], cw[CP];
    float wv[SP];
#pragma unroll
    for (int q = 0; q < CP; ++q) {
      const long long o = t0 + (FULL ? q * (NT / N) : min(q * (NT / N) + cq0, n - 1) - cq0);
      bw[q] = bp[o * bv.t];
      cw[q] = cp[o * cv.t];
    }
#pragma unroll
    for (int q = 0; q < SP; ++q) {
      const long long o = t0 + (FULL ? q * (NT / JR) : min(q * (NT / JR) + sq0, n - 1) - sq0);
      av[q] = ap[o * a.t];
      mv[q] = mp[o * m.t];
      wv[q] = wp[o * w.t];
    }
    if (cq0 == NT / N - 1) sbv[0][sj] = b_last;
    if (sq0 == NT / JR - 1) sa[0][si] = a_last;
#pragma unroll
    for (int q = 0; q < CP; ++q) {
      const int tt = q * (NT / N) + cq0;
      const bool in = FULL || tt < n;
      b_last = in ? rt::to_f(bw[q]) : 0.f;
      sbv[tt + 1][sj] = b_last;
      scv[tt][sj] = in ? rt::to_f(cw[q]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < SP; ++q) {
      const int tt = q * (NT / JR) + sq0;
      const bool in = FULL || tt < n;
      a_last = in ? rt::to_f(av[q]) : 0.f;
      sa[tt + 1][si] = a_last;
      sm[tt][si] = in ? rt::to_f(mv[q]) : 0.f;
      sw[tt][si] = in ? expf(wv[q]) : 1.f;
    }
    if constexpr (SECOND) rt::cp_async_wait<0>();
  };

  // The steps of the tile's n tokens from t0, UR at a time; in a short tile
  // a token past the end leaves the state as it is (FULL false).
  auto steps = [&](auto full, int t0, int n) {
    constexpr bool FULL = decltype(full)::value;
#pragma unroll 1
    for (int u0 = 0; u0 < n; u0 += UR) {
      float acc[UR][R];
#pragma unroll
      for (int x = 0; x < UR; ++x) {
        float aa[R], ww[R], bb[C], cc[C];
        load_vec<R>(aa, &sa[u0 + x][i0]);  // the previous token's a and b
        load_vec<C>(bb, &sbv[u0 + x][j0]);
        load_vec<R>(ww, &sw[u0 + x][i0]);
        load_vec<C>(cc, &scv[u0 + x][j0]);
#pragma unroll
        for (int q = 0; q < R; ++q) {
          acc[x][q] = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) acc[x][q] = fmaf(z[q][c], cc[c], acc[x][q]);
        }
        if (FULL || u0 + x < n) {
#pragma unroll
          for (int q = 0; q < R; ++q)
#pragma unroll
            for (int c = 0; c < C; ++c) z[q][c] = fmaf(aa[q], bb[c], z[q][c]) * ww[q];
        }
      }
      group_sums<UR, R, G>(acc, gl);
#pragma unroll
      for (int x = 0; x < UR; ++x) {
        const int tt = u0 + x;
        float st = ss[0][tt], qt = sq[0][tt];
#pragma unroll
        for (int part = 1; part < P::PARTS; ++part) st += ss[part][tt], qt += sq[part][tt];
        const float outp = acc[x][0];
        const float a_cur = sa[tt + 1][io], m_o = sm[tt][io];
        const float out = fmaf(sa[tt][io], qt, outp);
        // the G / R lanes of a row hold the same sums: all store them
        if (tt < n) {
          const long long t = t0 + tt;
          gp[t * g.t] = rt::from_f<T>(fmaf(u_o * a_cur, st, out));
          if constexpr (SECOND) {
            run -= t == 0 ? 0.f : m_o * outp;
            dwp[t * dw.t] = run;
            run += sx[tt][io];
            du_acc = fmaf(a_cur * m_o, st, du_acc);
          } else {
            xo[t * xa.t] = m_o * outp;
          }
        }
      }
    }
  };

  for (int t0 = 0; t0 < S; t0 += TR) {
    const int n = min(TR, S - t0);
    __syncthreads();  // the previous tile is consumed
    if (n == TR)
      stage(std::true_type{}, t0, n);
    else
      stage(std::false_type{}, t0, n);
    __syncthreads();
    {  // s_t and q_t in PARTS parts of L columns, each summed in column order
      const int tt = tid % TR, part = tid / TR;
      float s_sum = 0.f, q_sum = 0.f;
#pragma unroll
      for (int q = 0; q < L; ++q) {
        const float c = scv[tt][part * L + q];
        s_sum = fmaf(sbv[tt + 1][part * L + q], c, s_sum);
        q_sum = fmaf(sbv[tt][part * L + q], c, q_sum);
      }
      ss[part][tt] = s_sum;
      sq[part][tt] = q_sum;
    }
    __syncthreads();
    if (n == TR)
      steps(std::true_type{}, t0, n);
    else
      steps(std::false_type{}, t0, n);
  }

  if constexpr (SECOND) {
    if (gl < R) du_part[(long long)bh * N + r0 + io] = du_acc;
  } else {  // A'_T = rowsum(Z_T * dS_T)
    float fa[1][R];
    const float* d0 = ds_T + (long long)bh * N * N + (long long)(r0 + i0) * N + j0;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      fa[0][q] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) fa[0][q] = fmaf(z[q][c], d0[q * N + c], fa[0][q]);
    }
    group_sums<1, R, G>(fa, gl);
    if (gl < R) fin[(long long)bh * N + r0 + io] = fa[0][0];
  }
}

// du[i] = sum over b in order of part[b][i], i over H * N
__global__ void wkv6_bwd_du_kernel(const float* __restrict__ part, float* __restrict__ du,
                                   int B, int HN) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HN) return;
  float sum = part[i];
  for (int b = 1; b < B; ++b) sum += part[(long long)b * HN + i];
  du[i] = sum;
}

// The views in the entry's order: r, k, v, dy, wlog, dr, dk, dv, dwlog
struct Args {
  const void *r, *k, *v, *dy, *wlog, *u, *s_in, *ds_T;
  void *dr, *dk, *dv, *dwlog, *du, *dstate, *scratch;
  int B, H, S;
  long long st[9][3];
};

template <typename E>
View<E> view(const void* p, const long long (&st)[3]) {
  return View<E>{static_cast<E*>(const_cast<void*>(p)), st[0], st[1], st[2]};
}

template <typename T, int N>
int launch(const Args& x, cudaStream_t stream) {
  using P = RowPlan<N>;
  const int B = x.B, H = x.H, S = x.S;
  const long long blocks = (long long)B * H * P::SLABS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const auto r = view<const T>(x.r, x.st[0]), k = view<const T>(x.k, x.st[1]);
  const auto v = view<const T>(x.v, x.st[2]), dy = view<const T>(x.dy, x.st[3]);
  const auto w = view<const float>(x.wlog, x.st[4]);
  const auto dr = view<T>(x.dr, x.st[5]), dk = view<T>(x.dk, x.st[6]);
  const auto dwlog = view<float>(x.dwlog, x.st[8]);
  // scratch: A (B, H, S, N), A_T (B, H, N), the du partials (B, H, N)
  float* A = static_cast<float*>(x.scratch);
  float* fin = A + (long long)B * H * S * N;
  float* du_part = fin + (long long)B * H * N;
  const View<float> xa{A, (long long)H * S * N, (long long)S * N, N};
  const View<float> none{nullptr, 0, 0, 0};
  const auto* u = static_cast<const float*>(x.u);
  const auto* s_in = static_cast<const float*>(x.s_in);
  const auto* ds_T = static_cast<const float*>(x.ds_T);

  wkv6_bwd_rows_kernel<T, N, false><<<(unsigned)blocks, P::THREADS, 0, stream>>>(
      k, r, v, dy, w, xa, dr, none, u, s_in, ds_T, fin, nullptr, H, S);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wkv6_bwd_rows_kernel<T, N, true><<<(unsigned)blocks, P::THREADS, 0, stream>>>(
      reversed(r, S), reversed(k, S), reversed(dy, S), reversed(v, S), reversed(w, S),
      reversed(xa, S), reversed(dk, S), reversed(dwlog, S), u, ds_T, nullptr, fin, du_part, H,
      S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the forward kernel backward in time: (r, k, v) := (k, r, dy), y := dv
  const auto rk = reversed(k, S), kr = reversed(r, S), vd = reversed(dy, S);
  const auto wr = reversed(w, S);
  const auto yv = reversed(view<T>(x.dv, x.st[7]), S);
  const Strides fst{rk.b, rk.h, rk.t, kr.b, kr.h, kr.t, vd.b, vd.h, vd.t,
                    wr.b, wr.h, wr.t, yv.b, yv.h, yv.t};
  const int err = launch_forward(std::is_same<T, float>::value ? rt::kF32 : rt::kBF16, N, rk.p,
                                 kr.p, vd.p, wr.p, u, ds_T, yv.p, x.dstate, B, H, S, fst, stream);
  if (err != 0) return err;
  const int HN = H * N;
  wkv6_bwd_du_kernel<<<(HN + 255) / 256, 256, 0, stream>>>(du_part, static_cast<float*>(x.du),
                                                          B, HN);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(int N, const Args& x, cudaStream_t stream) {
  switch (N) {
    case 8: return launch<T, 8>(x, stream);
    case 16: return launch<T, 16>(x, stream);
    case 32: return launch<T, 32>(x, stream);
    case 64: return launch<T, 64>(x, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, dy (dtype) and wlog (float32) are (B, H, S, N) and dr, dk, dv
// (dtype) and dwlog (float32) the same, each through 3 element strides
// (batch, head, token) in that order in `strides` (27 values); the head
// axis has stride 1. u and du are (H, N), state, dS_T and dstate (B, H,
// N, N), contiguous float32. scratch holds B * H * (S + 2) * N floats.
extern "C" int rt_wkv6_bwd(const void* r, const void* k, const void* v, const void* dy,
                           const void* wlog, const void* u, const void* s_in, const void* ds_T,
                           void* dr, void* dk, void* dv, void* dwlog, void* du, void* dstate,
                           void* scratch, int B, int H, int S, int N,
                           const long long* strides, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  Args x{r, k, v, dy, wlog, u, s_in, ds_T, dr, dk, dv, dwlog, du, dstate, scratch, B, H, S, {}};
  for (int i = 0; i < 9; ++i)
    for (int j = 0; j < 3; ++j) x.st[i][j] = strides[3 * i + j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32) return dispatch_n<float>(N, x, s);
  if (dtype == rt::kBF16) return dispatch_n<__nv_bfloat16>(N, x, s);
  return (int)cudaErrorInvalidValue;
}
