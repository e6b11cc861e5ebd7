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
// The two row passes do 12 (4 and 8), the chunk contributions 2 more, and
// A' (16.8 MB) and the chunk states move through memory.
//
// Design: the sequence is cut into NC chunks of CHUNK tokens (the last one
// short). The reverse pass runs every chunk at once, from the gradient
// state at the chunk's end, which a pre-pass and a short scan give; each
// pass keeps the unchunked per-token arithmetic, and only the carries at the
// chunk boundaries are new. Five launches on the stream, no atomics (two
// calls give the same bits), every sum in a fixed order:
//  1. Chunk contributions (wkv6_bwd_chunk_kernel, a block per (b, h,
//     chunk) [t0, t1] after the first): the reverse carry's term M = sum
//     over s in [t0 + 1, t1 + 1] of (r_s decayed by w_{t0..s-1}) dy_s^T
//     and the chunk's decay P. The sum is shifted one token so that the
//     carry is dZ itself: the token after the chunk is in, its own first
//     token out. Each decay is the exp of a sum of wlog <= 0 taken from
//     the chunk's start, never a difference of two sums.
//  2. Scan (wkv6_bwd_scan_kernel, a thread per 4 state elements of a (b,
//     h)): dZ at every chunk's end from dS_T (dZ' = P dZ + M), written
//     over M. dZ is never formed as dS - r dy^T.
//  3. Rows, token order (wkv6_bwd_rows_kernel<.., false>, a block per (b,
//     h, slab of JR rows), the whole sequence): from
//     state_in per token it sums Z_t dy_t along each row, adds k_{t-1}
//     (v_{t-1} . dy_t) for S_t dy_t, writes dr_t and A'_t (float32
//     scratch), then Z_{t+1} = exp(w_t) (Z_t + k_{t-1} v_{t-1}^T); at each
//     chunk's end it stores Z (float32 scratch). This pass is not chunked:
//     its 512 blocks at the training shape are all resident at once.
//  4. Rows, reverse order (<.., true>, a block per (b, h, chunk) owning
//     all N rows): from the chunk's dZ (dS_T for the last chunk; a = r, b
//     = dy, c = v, the token after the chunk as the first step's previous
//     token) it first takes A'_end = rowsum(Z_end * dS_end), dS_end its
//     starting state plus r dy^T of the token after the chunk: that is
//     dwlog of the chunk's last token. Per token dk_t, and dwlog_t as one
//     running sum per row from A'_end, then - B'_t (0 at the chunk's first
//     step), then + A'_t,
//     which stays the size of dwlog; one du partial per (b, h, chunk). The
//     same carry gives dv (no third pass over the sequence): with X =
//     dZ_{t+1} at a step, dv_t = X^T k_t + (r_{t+1} . k_t) dy_{t+1} + (k_t
//     . (u * r_t)) dy_t, the column sums taken in the warp and then across
//     the block's warps in order (dynamic shared memory); the sequence's
//     first chunk writes dstate = dZ_0 + r_0 dy_0^T.
//  5. du (wkv6_bwd_du_kernel): the partials summed in (b, chunk) order.
// The row passes take the forward's Tile<N> transposed: a thread carries
// R = Tile::C rows of C = Tile::R columns, the G = N / C threads of a row
// group are adjacent lanes (their row sums are the forward's butterfly);
// pass 3's block owns JR = Tile::JC rows (512 blocks of 64 threads at the
// training shape, 168 registers), pass 4's all N (512 blocks of 256 there,
// registers capped at 128 for 16 warps an SM). Per token a
// thread does 3 FP instructions a state element (acc_r += z_rc c_c, z_rc
// = (z_rc + a'_r b'_c) w_r, a' and b' the previous token's), and in pass
// 4 one more (the column sums). TR = 16 tokens are staged at a time: a
// (one row more: the token before the tile), m, exp(w) (and A' in pass 4)
// at the block's rows, b (one row more) and c at N wide; the token scalars
// b_t . c_t and b_{t-1} . c_t (and a_{t-1} . m_t, m_t . (u * a_t) in pass
// 4) are summed once a tile, in parts. Only exp of a sum of wlog <= 0 is
// taken: wlog = -8 cannot overflow. A short last tile stages zeros past
// the end and leaves Z as it is there. kernels/rwkv6.py::bwd_plan mirrors
// the launches and the scratch; rt_wkv6_bwd_plan reports what the card
// makes of them.
#include <type_traits>

#include "wkv6.cuh"

namespace {

using namespace wkv6;

// tokens per staged tile of the row passes, and tokens whose row sums go
// out together in pass 3 and in pass 4 (the forward stages 32 and sums 8:
// here the reverse pass's staging and sums at those sizes took 255
// registers and spilled at N = 64; pass 4 spilled at 2 under its cap)
constexpr int TR = 16;
constexpr int UR = 4;
constexpr int UR4 = 1;
// tokens a chunk (kernels/rwkv6.py::BWD_CHUNK mirrors it). Pass 3 ends a
// tile at each chunk's end, and a short tile stages zeros as the next
// tile's previous token: only the sequence's last tile may be short.
constexpr int CHUNK = 128;
static_assert(CHUNK % TR == 0, "pass 3's tiles are whole up to the sequence's end");
// warps an SM each row pass is built for: their registers are capped to
// fit (pass 3: 168 registers; pass 4, blocks of 8 warps: 128)
constexpr int ROW_WARPS = 12;
constexpr int ROW_WARPS4 = 16;

// Pass 3 (SECOND false) gives a block a slab of JR = Tile::JC rows and the
// whole sequence; pass 4 (SECOND true) all N rows and one chunk, because its
// column sums run over every row.
template <int N, bool SECOND>
struct RowPlan {
  static constexpr int R = Tile<N>::C, C = Tile<N>::R, JR = SECOND ? N : Tile<N>::JC;
  static constexpr int G = N / C;               // lanes of a row group (they split the columns)
  static constexpr int SLABS = N / JR;          // blocks per (b, h) (pass 4: and chunk)
  static constexpr int THREADS = JR / R * G;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int MIN_BLOCKS = (SECOND ? ROW_WARPS4 : ROW_WARPS) / WARPS;
  static constexpr int PARTS = THREADS / TR;    // adjacent lanes summing one token's scalars
  static constexpr int L = N / PARTS;           // columns (pass 4: also rows) of one part
  static constexpr int SP = TR * JR / THREADS;  // staging passes of the a, m, w tiles
  static constexpr int CP = TR * N / THREADS;   // staging passes of the b, c tiles
  static constexpr int UB = SECOND ? UR4 : UR;  // tokens whose row sums go out together
  // of the b and c tiles: 16-byte rows for the vector loads
  static constexpr int PB = N + 4;
  // static shared bytes (pass 4: + A' of the tile, 2 scalars a token, u),
  // and pass 4's dynamic bytes: each warp's column sums a token
  static constexpr int SMEM = ((3 * TR + 1) * JR + (2 * TR + 1) * PB + 2 * TR +
                               (SECOND ? TR * N + 2 * TR + N : 0)) * 4;
  static constexpr int COLS = SECOND ? WARPS * TR * N * 4 : 0;
  static_assert(N % JR == 0 && JR % R == 0 && R <= G && G <= 32 && 32 % G == 0,
                "a row group's lanes lie in one warp and hold its R rows after the sum");
  static_assert(JR % 4 == 0, "a token's A' slab is whole 16-byte copies");
  static_assert(THREADS % 32 == 0 && THREADS % N == 0 && THREADS % JR == 0 &&
                    THREADS % TR == 0 && N % PARTS == 0 && 32 % PARTS == 0 && MIN_BLOCKS >= 1,
                "whole warps; each thread stages one column and one slab row; the sums in "
                "equal parts, a token's parts in one warp");
  static_assert(SMEM <= 48 * 1024, "the tiles fit the static shared memory limit");
  static_assert(TR % UB == 0, "a tile is whole batches of tokens");
};

// tokens per staged tile of the chunk contributions: a warp's lanes
constexpr int CT = 32;
// warps an SM the chunk contributions are built for
constexpr int CHUNK_WARPS = 24;

template <int N>
struct ChunkPlan {
  static constexpr int TI = N >= 32 ? 4 : N / 8;  // a thread's tile of M: TI x TI
  static constexpr int THREADS = (N / TI) * (N / TI);
  static constexpr int WARPS = THREADS / 32;
  static constexpr int RW = N / WARPS;  // rows whose decays one warp scans
  static constexpr int MIN_BLOCKS = CHUNK_WARPS / WARPS;
  static constexpr int SMEM = (N * (CT + 1) + 2 * CT * N + N) * (int)sizeof(float);
  static_assert(THREADS % 32 == 0 && THREADS % N == 0 && N % WARPS == 0,
                "whole warps; each thread stages one column; the rows in equal parts");
  static_assert(SMEM <= 48 * 1024, "the tile fits the static shared memory limit");
};

constexpr int SCAN_THREADS = 256;
constexpr int DU_THREADS = 256;

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

// M floats from registers to memory aligned to their vector (load_vec's twin)
template <int M>
__device__ __forceinline__ void store_vec(float* dst, const float (&src)[M]) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int q = 0; q < M / 4; ++q)
      reinterpret_cast<float4*>(dst)[q] =
          make_float4(src[4 * q], src[4 * q + 1], src[4 * q + 2], src[4 * q + 3]);
  } else if constexpr (M % 2 == 0) {
#pragma unroll
    for (int q = 0; q < M / 2; ++q)
      reinterpret_cast<float2*>(dst)[q] = make_float2(src[2 * q], src[2 * q + 1]);
  } else {
#pragma unroll
    for (int q = 0; q < M; ++q) dst[q] = src[q];
  }
}

// A pass over S tokens cut into n chunks of CHUNK tokens, numbered in the
// pass's own direction: chunk c holds tokens [begin(c), end(c)). A pass in
// token order has off = 0 (its last chunk is the short one); a pass over
// reversed views has off = n * CHUNK - S, so that its chunks are token
// order's, last first. A chunk c > 0 starts from the state at z + bh * z_bh
// + c * z_c, which leaves out the newest rank-1 term of the token before
// the chunk; chunk 0 starts from the pass's own initial state.
struct Chunks {
  int n, off;
  const float* z;
  long long z_bh, z_c;
  __device__ __forceinline__ int begin(int c) const { return max(0, c * CHUNK - off); }
  __device__ __forceinline__ int end(int c, int S) const { return min(S, (c + 1) * CHUNK - off); }
};

// Pass 3 (SECOND false), token order over the whole sequence: a = k, m =
// r, bv = v, cv = dy, the state Z from s_in = state_in; g gets dr, xa gets
// A'_t, zs Z at the end of each chunk of ch.
// Pass 4 (SECOND true), reverse order, a block per chunk of ch: a = r, m =
// k, bv = dy, cv = v, the state dZ from s_in = dS_T (chunk 0 of the pass,
// the sequence's last) or ch's chunk states; A'_end from zs and the
// chunk's dS_end (its starting state plus a' b'^T of the token after it);
// g gets dk, xa holds A'_t, dw gets dwlog, dv dv, du_part one row of
// partials per (b, h, chunk) at the chunk's index in token order, and the
// pass's last chunk writes dstate.
// Per step (token t of the pass): out' = X c_t along each row, q_t =
// b_{t-1} . c_t, s_t = b_t . c_t; g_t = out' + a_{t-1} q_t + u a_t s_t; the
// row's term m_t out'; (pass 4) X^T m_t along each column; X = (X +
// a_{t-1} b_{t-1}^T) exp(w_t). The token next to the chunk (before it in
// the pass's order) is its first step's t - 1.
template <typename T, int N, bool SECOND>
__global__ void __launch_bounds__(RowPlan<N, SECOND>::THREADS, RowPlan<N, SECOND>::MIN_BLOCKS)
    wkv6_bwd_rows_kernel(View<const T> a, View<const T> m, View<const T> bv, View<const T> cv,
                         View<const float> w, View<float> xa, View<T> g, View<float> dw,
                         View<T> dv, const float* __restrict__ u, const float* __restrict__ s_in,
                         Chunks ch, float* __restrict__ zs, float* __restrict__ du_part,
                         float* __restrict__ dstate, int H, int S) {
  using P = RowPlan<N, SECOND>;
  constexpr int R = P::R, C = P::C, G = P::G, JR = P::JR, NT = P::THREADS, PB = P::PB;
  constexpr int L = P::L, SP = P::SP, CP = P::CP, UB = P::UB;
  // sa and sbv: row 0 is the token before the tile, row x + 1 token x
  __shared__ __align__(16) float sa[TR + 1][JR];
  __shared__ __align__(16) float sm[TR][JR];
  __shared__ __align__(16) float sw[TR][JR];  // exp(w)
  __shared__ __align__(16) float sbv[TR + 1][PB];
  __shared__ __align__(16) float scv[TR][PB];
  __shared__ float ss[TR];  // s_t = b_t . c_t
  __shared__ float sq[TR];  // q_t = b_{t-1} . c_t
  // pass 4: A' of the tile, a_{t-1} . m_t and m_t . (u * a_t), u, and each
  // warp's column sums (dynamic shared memory)
  __shared__ __align__(16) float sx[SECOND ? TR : 1][JR];
  __shared__ float sp[SECOND ? TR : 1];
  __shared__ float sbt[SECOND ? TR : 1];
  __shared__ float su[SECOND ? N : 1];
  extern __shared__ __align__(16) float scol[];  // [warp][token][column]

  const int NC = ch.n;
  const int NG = SECOND ? NC : 1;  // chunks on the grid: pass 3 walks the whole sequence
  const int bh = blockIdx.x / (NG * P::SLABS);
  const int ci = SECOND ? blockIdx.x / P::SLABS % NC : 0;  // the chunk, in the pass's order
  const int r0 = blockIdx.x % P::SLABS * JR;  // the slab's first row
  const int real = NC - 1 - ci;               // pass 4's chunk in token order
  const int b = bh / H;
  const int h = bh % H;
  const int ts = SECOND ? ch.begin(ci) : 0, te = SECOND ? ch.end(ci, S) : S;
  const int tid = threadIdx.x;
  const int gl = tid % G;       // the lane within its row group: columns gl * C on
  const int j0 = gl * C;
  const int i0 = tid / G * R;   // the thread's first row within the slab
  const int io = i0 + gl % R;   // its row after the sums
  const long long NN = (long long)N * N;

  float z[R][C];  // z[q][c] = X[r0 + i0 + q][j0 + c]
  const float* z0 = (ci == 0 ? s_in + bh * NN : ch.z + bh * ch.z_bh + ci * ch.z_c) +
                    (long long)(r0 + i0) * N + j0;
#pragma unroll
  for (int q = 0; q < R; ++q)
#pragma unroll
    for (int c = 0; c < C; ++c) z[q][c] = z0[q * N + c];

  const float u_o = SECOND ? 0.f : u[(long long)h * N + r0 + io];  // pass 4 reads su
  // the dwlog running sum of the lane's row: A'_end, then - B'_t + A'_t a step
  float run = 0.f;
  if constexpr (SECOND) {  // A'_end = rowsum(Z_end * dS_end), dS_end = X + a' b'^T
    const float* ze = zs + ((long long)bh * NC + real) * NN + (long long)i0 * N + j0;
    float an[R], bn[C], fa[1][R];  // r and dy of the token after the chunk (none after the last)
#pragma unroll
    for (int q = 0; q < R; ++q)
      an[q] = ts == 0 ? 0.f
                      : rt::to_f(a.p[b * a.b + h * a.h + (long long)(ts - 1) * a.t + i0 + q]);
#pragma unroll
    for (int c = 0; c < C; ++c)
      bn[c] = ts == 0 ? 0.f
                      : rt::to_f(bv.p[b * bv.b + h * bv.h + (long long)(ts - 1) * bv.t + j0 + c]);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      fa[0][q] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c)
        fa[0][q] = fmaf(ze[q * N + c], fmaf(an[q], bn[c], z[q][c]), fa[0][q]);
    }
    group_sums<1, R, G>(fa, gl);
    run = fa[0][0];
  }
  float du_acc = 0.f;
  if constexpr (SECOND) {
    if (tid < N) su[tid] = u[(long long)h * N + tid];
  }

  // Staging: element e = pass * NT + tid of a TR x JR tile is token e / JR,
  // row e % JR (si); of a TR x N tile token e / N, column e % N (sj). The
  // thread that stages token TR - 1 of a row or column keeps it for row 0
  // of the next tile (a_last, b_last): no other thread touches either. The
  // same threads start from the token before the chunk.
  const int si = tid % JR, sq0 = tid / JR;
  const int sj = tid % N, cq0 = tid / N;
  const T* ap = a.p + b * a.b + h * a.h + r0 + si + sq0 * a.t;
  const T* mp = m.p + b * m.b + h * m.h + r0 + si + sq0 * m.t;
  const float* wp = w.p + b * w.b + h * w.h + r0 + si + sq0 * w.t;
  const float* xp = xa.p + b * xa.b + h * xa.h + r0;  // A' of the slab (pass 4)
  const T* bp = bv.p + b * bv.b + h * bv.h + sj + cq0 * bv.t;
  const T* cp = cv.p + b * cv.b + h * cv.h + sj + cq0 * cv.t;
  T* gp = g.p + b * g.b + h * g.h + r0 + io;
  float* xo = xa.p + b * xa.b + h * xa.h + r0 + io;
  float* dwp = dw.p + b * dw.b + h * dw.h + r0 + io;
  float a_last = 0.f, b_last = 0.f;
  if (ts > 0) {
    if (cq0 == NT / N - 1) b_last = rt::to_f(bp[(long long)(ts - 1 - cq0) * bv.t]);
    if (sq0 == NT / JR - 1) a_last = rt::to_f(ap[(long long)(ts - 1 - sq0) * a.t]);
  }

  // Stages the tile of n tokens from t0, all loads out before any is
  // used; A' (pass 4, float32 rows of the scratch) by 16-byte async copies,
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

  // The steps of the tile's n tokens from t0, UB at a time; in a short tile
  // (FULL false) a token past the end leaves the state as it is.
  auto steps = [&](auto full, int t0, int n) {
    constexpr bool FULL = decltype(full)::value;
#pragma unroll 1
    for (int u0 = 0; u0 < n; u0 += UB) {
      float acc[UB][R];
#pragma unroll
      for (int x = 0; x < UB; ++x) {
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
        if constexpr (SECOND) {  // X^T m_t: the thread's rows, then the warp's
          float mm[R], col[C];
          load_vec<R>(mm, &sm[u0 + x][i0]);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            col[c] = 0.f;
#pragma unroll
            for (int q = 0; q < R; ++q) col[c] = fmaf(z[q][c], mm[q], col[c]);
          }
#pragma unroll
          for (int o = G; o < 32; o <<= 1)
#pragma unroll
            for (int c = 0; c < C; ++c) col[c] += __shfl_xor_sync(0xffffffffu, col[c], o);
          if (tid % 32 < G) {
            float* dst = scol + ((tid / 32) * TR + u0 + x) * N + j0;
#pragma unroll
            for (int c = 0; c < C; ++c) dst[c] = col[c];
          }
        }
        if (FULL || u0 + x < n) {
#pragma unroll
          for (int q = 0; q < R; ++q)
#pragma unroll
            for (int c = 0; c < C; ++c) z[q][c] = fmaf(aa[q], bb[c], z[q][c]) * ww[q];
        }
      }
      group_sums<UB, R, G>(acc, gl);
#pragma unroll
      for (int x = 0; x < UB; ++x) {
        const int tt = u0 + x;
        const float st = ss[tt], qt = sq[tt];
        const float outp = acc[x][0];
        const float a_cur = sa[tt + 1][io], m_o = sm[tt][io];
        const float out = fmaf(sa[tt][io], qt, outp);
        // the G / R lanes of a row hold the same sums: all store them
        if (FULL || tt < n) {
          const long long t = t0 + tt;
          gp[t * g.t] = rt::from_f<T>(fmaf((SECOND ? su[r0 + io] : u_o) * a_cur, st, out));
          if constexpr (SECOND) {
            run -= t == ts ? 0.f : m_o * outp;
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

  int last_n = 0;  // tokens of the last tile
  for (int t0 = ts; t0 < te;) {
    // pass 3 also ends a tile at each chunk's end
    const int n = min(TR, (SECOND ? te : min(te, (t0 / CHUNK + 1) * CHUNK)) - t0);
    last_n = n;
    __syncthreads();  // the previous tile is consumed
    if (n == TR)
      stage(std::true_type{}, t0, n);
    else
      stage(std::false_type{}, t0, n);
    __syncthreads();
    {  // the token scalars in PARTS parts of L columns (pass 4: and rows),
       // each summed in order by one of PARTS adjacent lanes, then the parts
       // by a butterfly
      const int tt = tid / P::PARTS, part = tid % P::PARTS;
      float s_sum = 0.f, q_sum = 0.f, p_sum = 0.f, b_sum = 0.f;
#pragma unroll
      for (int q = 0; q < L; ++q) {
        const int j = part * L + q;
        const float c = scv[tt][j];
        s_sum = fmaf(sbv[tt + 1][j], c, s_sum);
        q_sum = fmaf(sbv[tt][j], c, q_sum);
        if constexpr (SECOND) {
          const float mj = sm[tt][j];
          p_sum = fmaf(sa[tt][j], mj, p_sum);
          b_sum = fmaf(mj * su[j], sa[tt + 1][j], b_sum);
        }
      }
#pragma unroll
      for (int o = 1; o < P::PARTS; o <<= 1) {
        s_sum += __shfl_xor_sync(0xffffffffu, s_sum, o);
        q_sum += __shfl_xor_sync(0xffffffffu, q_sum, o);
        if constexpr (SECOND) {
          p_sum += __shfl_xor_sync(0xffffffffu, p_sum, o);
          b_sum += __shfl_xor_sync(0xffffffffu, b_sum, o);
        }
      }
      if (part == 0) {
        ss[tt] = s_sum, sq[tt] = q_sum;
        if constexpr (SECOND) sp[tt] = p_sum, sbt[tt] = b_sum;
      }
    }
    __syncthreads();
    if (n == TR)
      steps(std::true_type{}, t0, n);
    else
      steps(std::false_type{}, t0, n);
    if constexpr (SECOND) {  // dv of the tile: the warps' column sums in order
      __syncthreads();
      T* vp = dv.p + b * dv.b + h * dv.h;
      for (int e = tid; e < n * N; e += NT) {
        const int tt = e / N, j = e % N;
        float col = scol[tt * N + j];
#pragma unroll
        for (int wi = 1; wi < P::WARPS; ++wi) col += scol[(wi * TR + tt) * N + j];
        col = fmaf(sp[tt], sbv[tt][j], col);
        vp[(long long)(t0 + tt) * dv.t + j] = rt::from_f<T>(fmaf(sbt[tt], sbv[tt + 1][j], col));
      }
    }
    t0 += n;
    if constexpr (!SECOND) {  // Z at each chunk's end, for pass 4's A'_end
      if (t0 % CHUNK == 0 || t0 == S) {
        float* ze = zs + ((long long)bh * NC + (t0 - 1) / CHUNK) * NN +
                    (long long)(r0 + i0) * N + j0;
#pragma unroll
        for (int q = 0; q < R; ++q) store_vec<C>(ze + q * N, z[q]);
      }
    }
  }

  if constexpr (SECOND) {
    if (gl < R) du_part[((long long)bh * NC + real) * N + io] = du_acc;
    if (ci == NC - 1) {  // dstate = dZ_0 + r_0 dy_0^T (token 0: the last tile's last)
      float* d0 = dstate + bh * NN + (long long)i0 * N + j0;
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int c = 0; c < C; ++c)
          d0[q * N + c] = fmaf(sa[last_n][i0 + q], sbv[last_n][j0 + c], z[q][c]);
    }
  }
}

// Step 1, a block per (b, h, chunk c >= 1) of tokens [t0, t0 + n): one
// sweep of the chunk from its start in tiles of CT tokens, carrying each
// row's sum of w from the start: token x of the chunk scales r of token t0
// + x + 1 by exp(w_{t0} + .. + w_{t0+x}); the product of those rows with dy
// of the same tokens is M, written at slot c - 1 of the reverse chunk
// states, and exp of the whole sum is P (a token past the sequence is
// zeros). Per tile a warp scans the w of RW rows across its lanes (a lane
// a token; each row's sum from the earlier tiles carried in a register),
// and a thread owns a TI x TI tile of the product, summing its tokens in
// order.
template <typename T, int N>
__global__ void __launch_bounds__(ChunkPlan<N>::THREADS, ChunkPlan<N>::MIN_BLOCKS)
    wkv6_bwd_chunk_kernel(View<const T> r, View<const T> dy, View<const float> w,
                          float* __restrict__ M, float* __restrict__ Pd, int H, int S, int NC) {
  using CPn = ChunkPlan<N>;
  constexpr int TI = CPn::TI, NT = CPn::THREADS, RW = CPn::RW;
  constexpr int TQ = NT / N, EP = CT / TQ;  // tokens a staging pass, passes a tile
  __shared__ float sd[N][CT + 1];            // w by row, then the decays
  __shared__ __align__(16) float sa[CT][N];  // r, decayed
  __shared__ __align__(16) float sb[CT][N];  // dy
  __shared__ float carry[N];                 // each row's sum of w over the earlier tiles

  const int bh = blockIdx.x / (NC - 1), c = blockIdx.x % (NC - 1) + 1;
  const int b = bh / H, h = bh % H;
  const int t0 = c * CHUNK, n = min(CHUNK, S - t0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int i0 = tid / (N / TI) * TI, j0 = tid % (N / TI) * TI;
  const int si = tid % N, tq = tid / N;  // the column and first token this thread stages
  const float* wp = w.p + b * w.b + h * w.h + (long long)(t0 + tq) * w.t + si;
  const T* rp = r.p + b * r.b + h * r.h + (long long)(t0 + tq + 1) * r.t + si;
  const T* yp = dy.p + b * dy.b + h * dy.h + (long long)(t0 + tq + 1) * dy.t + si;
  float acc[TI][TI];
  if (tid < N) carry[tid] = 0.f;
#pragma unroll
  for (int q = 0; q < TI; ++q)
#pragma unroll
    for (int p = 0; p < TI; ++p) acc[q][p] = 0.f;

  for (int x0 = 0; x0 < n; x0 += CT) {
    const int nt = min(CT, n - x0);
    __syncthreads();  // the previous tile is consumed
    float wv[EP], xv[EP], yv[EP];
#pragma unroll
    for (int q = 0; q < EP; ++q) {
      const int xx = q * TQ + tq;
      const bool in = xx < nt, ok = in && t0 + x0 + xx + 1 < S;
      const int o = x0 + q * TQ;  // < CHUNK (a 64-bit offset spilled at N = 64, bf16)
      wv[q] = in ? wp[o * w.t] : 0.f;
      xv[q] = ok ? rt::to_f(rp[o * r.t]) : 0.f;
      yv[q] = ok ? rt::to_f(yp[o * dy.t]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < EP; ++q) {
      sd[si][q * TQ + tq] = wv[q];
      sb[q * TQ + tq][si] = yv[q];
    }
    __syncthreads();
    {  // the decays of the warp's rows: lane = token, an inclusive scan
      const bool in = lane < nt;
#pragma unroll
      for (int q = 0; q < RW; ++q) {
        const int i = warp + CPn::WARPS * q;
        float sum = in ? sd[i][lane] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float up = __shfl_up_sync(0xffffffffu, sum, o);
          if (lane >= o) sum += up;
        }
        const float before = carry[i];
        if (in) sd[i][lane] = expf(before + sum);
        const float total = __shfl_sync(0xffffffffu, sum, 31);
        if (lane == 0) carry[i] = before + total;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < EP; ++q) {
      const int xx = q * TQ + tq;
      sa[xx][si] = xx < nt ? xv[q] * sd[si][xx] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int xx = 0; xx < nt; ++xx) {
      float av[TI], bw[TI];
      load_vec<TI>(av, &sa[xx][i0]);
      load_vec<TI>(bw, &sb[xx][j0]);
#pragma unroll
      for (int q = 0; q < TI; ++q)
#pragma unroll
        for (int p = 0; p < TI; ++p) acc[q][p] = fmaf(av[q], bw[p], acc[q][p]);
    }
  }
  float* out = M + ((long long)bh * NC + c - 1) * N * N;
#pragma unroll
  for (int q = 0; q < TI; ++q) store_vec<TI>(out + (long long)(i0 + q) * N + j0, acc[q]);
  if (tid < N) Pd[((long long)bh * NC + c) * N + tid] = expf(carry[tid]);
}

// Step 2, a thread per 4 state elements of one (b, h): M[0..NC-2] hold M
// of the chunk after and become dZ at each chunk's end, dZ_c = P_{c+1}
// dZ_{c+1} + M_{c+1} from dZ_{NC-1} = dS_T.
template <int N>
__global__ void __launch_bounds__(SCAN_THREADS)
    wkv6_bwd_scan_kernel(const float* __restrict__ ds_T, float* __restrict__ M,
                         const float* __restrict__ Pd, int BH, int NC) {
  constexpr int Q = N * N / 4;  // float4s of a state
  const long long e = (long long)blockIdx.x * SCAN_THREADS + threadIdx.x;
  if (e >= (long long)BH * Q) return;
  const long long bh = e / Q;
  const int q = (int)(e % Q), row = q * 4 / N;
  float4* st = reinterpret_cast<float4*>(M + bh * NC * N * N) + q;  // slot c: st[c * Q]
  const float* p = Pd + bh * NC * N + row;  // P of chunk c: p[c * N]
  const float* x0 = ds_T + bh * N * N + 4 * q;
  float4 x = make_float4(x0[0], x0[1], x0[2], x0[3]);
  for (int c = NC - 2; c >= 0; --c) {
    const float d = p[(c + 1) * N];
    const float4 l = st[(long long)c * Q];
    x = make_float4(fmaf(d, x.x, l.x), fmaf(d, x.y, l.y), fmaf(d, x.z, l.z), fmaf(d, x.w, l.w));
    st[(long long)c * Q] = x;
  }
}

// Step 5: du[h][i] = sum over b, then chunks, of the partials
__global__ void __launch_bounds__(DU_THREADS)
    wkv6_bwd_du_kernel(const float* __restrict__ part, float* __restrict__ du, int B, int H,
                       int N, int NC) {
  const int e = blockIdx.x * DU_THREADS + threadIdx.x;
  if (e >= H * N) return;
  const int h = e / N, i = e % N;
  float sum = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* pb = part + ((long long)b * H + h) * NC * N + i;
    int c = 0;
    for (; c + 8 <= NC; c += 8) {  // 8 loads in flight, summed in order
      float x[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) x[q] = pb[(long long)(c + q) * N];
#pragma unroll
      for (int q = 0; q < 8; ++q) sum += x[q];
    }
    for (; c < NC; ++c) sum += pb[(long long)c * N];
  }
  du[e] = sum;
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

// The grid of each launch, in the order they run: chunk contributions (the
// chunks after the first), scan, row pass 3 (the whole sequence, one block
// per slab), row pass 4 (a block per chunk), du. The first two do not run
// with one chunk.
struct Grids {
  long long g[5];
};

template <int N>
Grids grids(int B, int H, int S) {
  const long long BH = (long long)B * H, NC = (S + CHUNK - 1) / CHUNK;
  const long long scan = (BH * (N * N / 4) + SCAN_THREADS - 1) / SCAN_THREADS;
  return Grids{{BH * (NC - 1), NC > 1 ? scan : 0, BH * RowPlan<N, false>::SLABS, BH * NC,
                ((long long)H * N + DU_THREADS - 1) / DU_THREADS}};
}

template <typename T, int N>
int launch(const Args& x, cudaStream_t stream) {
  using P3 = RowPlan<N, false>;
  using P4 = RowPlan<N, true>;
  const int B = x.B, H = x.H, S = x.S, NC = (S + CHUNK - 1) / CHUNK;
  const Grids gr = grids<N>(B, H, S);
  for (long long blocks : gr.g)
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  static int smem_set[rt::kMaxDevices];
  cudaError_t e = rt::max_dynamic_smem(
      reinterpret_cast<const void*>(wkv6_bwd_rows_kernel<T, N, true>), P4::COLS, smem_set);
  if (e != cudaSuccess) return (int)e;
  const auto r = view<const T>(x.r, x.st[0]), k = view<const T>(x.k, x.st[1]);
  const auto v = view<const T>(x.v, x.st[2]), dy = view<const T>(x.dy, x.st[3]);
  const auto w = view<const float>(x.wlog, x.st[4]);
  const auto dr = view<T>(x.dr, x.st[5]), dk = view<T>(x.dk, x.st[6]);
  const auto dv = view<T>(x.dv, x.st[7]);
  const auto dwlog = view<float>(x.dwlog, x.st[8]);
  // scratch: A (B, H, S, N), the reverse chunk states and the states at
  // the chunks' ends (B, H, NC, N, N) each, then P and the du partials (B,
  // H, NC, N) each
  const long long BH = (long long)B * H, NN = (long long)N * N;
  float* A = static_cast<float*>(x.scratch);
  float* M = A + BH * S * N;
  float* Zs = M + BH * NC * NN;
  float* Pd = Zs + BH * NC * NN;
  float* du_part = Pd + BH * NC * N;
  const View<float> xa{A, (long long)H * S * N, (long long)S * N, N};
  const View<float> none{nullptr, 0, 0, 0};
  const View<T> no_dv{nullptr, 0, 0, 0};
  const auto* u = static_cast<const float*>(x.u);
  const auto* s_in = static_cast<const float*>(x.s_in);
  const auto* ds_T = static_cast<const float*>(x.ds_T);
  // pass 3 ends its tiles at the chunks' ends; pass 4 starts its chunk c
  // (token order's NC - 1 - c) from M's slot NC - 1 - c
  const Chunks all{NC, 0, nullptr, 0, 0};
  const Chunks rev{NC, NC * CHUNK - S, M + (NC - 1) * NN, NC * NN, -NN};

  if (NC > 1) {
    wkv6_bwd_chunk_kernel<T, N><<<(unsigned)gr.g[0], ChunkPlan<N>::THREADS, 0, stream>>>(
        r, dy, w, M, Pd, H, S, NC);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    wkv6_bwd_scan_kernel<N><<<(unsigned)gr.g[1], SCAN_THREADS, 0, stream>>>(ds_T, M, Pd, B * H,
                                                                            NC);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  wkv6_bwd_rows_kernel<T, N, false><<<(unsigned)gr.g[2], P3::THREADS, 0, stream>>>(
      k, r, v, dy, w, xa, dr, none, no_dv, u, s_in, all, Zs, nullptr, nullptr, H, S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wkv6_bwd_rows_kernel<T, N, true><<<(unsigned)gr.g[3], P4::THREADS, P4::COLS, stream>>>(
      reversed(r, S), reversed(k, S), reversed(dy, S), reversed(v, S), reversed(w, S),
      reversed(xa, S), reversed(dk, S), reversed(dwlog, S), reversed(dv, S), u, ds_T, rev, Zs,
      du_part, static_cast<float*>(x.dstate), H, S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wkv6_bwd_du_kernel<<<(unsigned)gr.g[4], DU_THREADS, 0, stream>>>(
      du_part, static_cast<float*>(x.du), B, H, N, NC);
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

// One kernel's row of the plan: blocks, threads, static shared bytes and
// blocks resident on one SM of the current device with `dynamic` bytes more.
template <typename K>
cudaError_t plan_row(K kernel, long long blocks, int threads, int dynamic, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  out[0] = (int)blocks;
  out[1] = threads;
  out[2] = e == cudaSuccess ? (int)attr.sharedSizeBytes : 0;
  out[3] = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, threads, dynamic);
  return e;
}

template <typename T, int N>
int plan(int B, int H, int S, int* out) {
  using P3 = RowPlan<N, false>;
  using P4 = RowPlan<N, true>;
  const Grids gr = grids<N>(B, H, S);
  static int smem_set[rt::kMaxDevices];
  cudaError_t e = rt::max_dynamic_smem(
      reinterpret_cast<const void*>(wkv6_bwd_rows_kernel<T, N, true>), P4::COLS, smem_set);
  if (e == cudaSuccess)
    e = plan_row(wkv6_bwd_chunk_kernel<T, N>, gr.g[0], ChunkPlan<N>::THREADS, 0, out);
  if (e == cudaSuccess) e = plan_row(wkv6_bwd_scan_kernel<N>, gr.g[1], SCAN_THREADS, 0, out + 4);
  if (e == cudaSuccess)
    e = plan_row(wkv6_bwd_rows_kernel<T, N, false>, gr.g[2], P3::THREADS, 0, out + 8);
  if (e == cudaSuccess)
    e = plan_row(wkv6_bwd_rows_kernel<T, N, true>, gr.g[3], P4::THREADS, P4::COLS, out + 12);
  if (e == cudaSuccess) e = plan_row(wkv6_bwd_du_kernel, gr.g[4], DU_THREADS, 0, out + 16);
  return (int)e;
}

template <typename T>
int plan_n(int N, int B, int H, int S, int* out) {
  switch (N) {
    case 8: return plan<T, 8>(B, H, S, out);
    case 16: return plan<T, 16>(B, H, S, out);
    case 32: return plan<T, 32>(B, H, S, out);
    case 64: return plan<T, 64>(B, H, S, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, dy (dtype) and wlog (float32) are (B, H, S, N) and dr, dk, dv
// (dtype) and dwlog (float32) the same, each through 3 element strides
// (batch, head, token) in that order in `strides` (27 values); the head
// axis has stride 1. u and du are (H, N), state, dS_T and dstate (B, H,
// N, N), contiguous float32. The sequence is cut into NC = ceil(S / CHUNK)
// chunks; scratch holds B * H * (S + 2 * NC * N + 2 * NC) * N floats.
extern "C" int rt_wkv6_bwd(const void* r, const void* k, const void* v, const void* dy,
                           const void* wlog, const void* u, const void* s_in, const void* ds_T,
                           void* dr, void* dk, void* dv, void* dwlog, void* du, void* dstate,
                           void* scratch, int B, int H, int S, int N, const long long* strides,
                           int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  Args x{r, k, v, dy, wlog, u, s_in, ds_T, dr, dk, dv, dwlog, du, dstate, scratch,
         B, H, S, {}};
  for (int i = 0; i < 9; ++i)
    for (int j = 0; j < 3; ++j) x.st[i][j] = strides[3 * i + j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32) return dispatch_n<float>(N, x, s);
  if (dtype == rt::kBF16) return dispatch_n<__nv_bfloat16>(N, x, s);
  return (int)cudaErrorInvalidValue;
}

// The (dtype, N) instantiation's plan for a call at (B, H, S), into
// out[5][4]: per launch in the order they run (chunk
// contributions, scan, row pass 3, row pass 4, du) its blocks (0 for a
// launch that does not run), threads per block, static shared bytes and
// blocks resident on one SM of the current device.
extern "C" int rt_wkv6_bwd_plan(int dtype, int N, int B, int H, int S, int* out) {
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == rt::kF32) return plan_n<float>(N, B, H, S, out);
  if (dtype == rt::kBF16) return plan_n<__nv_bfloat16>(N, B, H, S, out);
  return (int)cudaErrorInvalidValue;
}
