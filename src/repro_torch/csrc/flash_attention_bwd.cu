// Backward of the blocked causal / sliding-window GQA attention of
// flash_attention.cu: dQ, dK and dV from q, k, v, the output o, its
// gradient dO and the forward's per-row log-sum-exp lse. S queries over Sk
// keys, as in the forward: Sk != S (a cross-attention over an encoder's
// memory) only when neither causal nor windowed. dQ has S rows, dK and dV
// Sk; every key-side guard runs to Sk and every query-side guard to S.
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
//   256). Each block writes its head's float32 partials to a (2, B, H, Sk,
//   hd) scratch: B·H·Sk/64 blocks (256 at gemma's MQA shape) instead of one
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
// float32 (flash_bwd_f32_kernel, its dK/dV and dQ blocks): 3xTF32 on
// mma.sync m16n8k8, as the float32 forward (wgmma takes tf32 only K-major
// from shared memory, and three of the five products read an operand
// MN-major). Bound at gemma-2b's shape in float32: ~10.8 GFLOP in ~0.065 ms
// at 165 TFLOP/s (three TF32 passes at 495) against ~76 MB in ~0.023 ms.
// - Exactness: every operand of every product (P and dS too, as they come
//   out of an accumulator) is split as it is loaded into TF32 hi + lo
//   (tf32.cuh), each product hi·hi + hi·lo + lo·hi: float32's own error,
//   where one TF32 rounding would leave ~1e-3.
// - Fragments: the forward's two patterns cover all five products. Sᵀ =
//   K·Qᵀ, dPᵀ = V·dOᵀ, S = Q·Kᵀ and dP = dO·Vᵀ read both operands K-major,
//   one 16-byte load a fragment; dV += Pᵀ·dO, dK += dSᵀ·Q and dQ += dS·K
//   take the accumulator as it stands as the A fragment and read B MN-major
//   (NU floats a row). Q and dO (dK/dV), K (dQ) are read in both patterns:
//   every tile is XOR-swizzled (tf32::swz) so that both are free of bank
//   conflicts with no padding.
// - flash_bwd_dot_kernel: D as above.
// - flash_bwd_f32_kernel: the dK/dV blocks and the dQ blocks in one
//   launch, alternating, each kind heaviest first: at small shapes neither
//   fills the card alone.
// - its dK/dV blocks: one per (64 keys, query head, batch),
//   eight warps: warps 0-3 own 16 keys each and compute Pᵀ and dV, warps
//   4-7 the same keys' dPᵀ, dSᵀ and dK, Pᵀ handed over through shared
//   memory, one named barrier a pair of warps (the bf16 route's split: one
//   hd/2-register accumulator a thread). K and V resident; Q and dO tiles
//   of 32 query rows (16 at hd 256: two stages must fit beside K and V,
//   196 KB) through a two-stage cp.async ring, one block-wide barrier a
//   tile. Per-head partials as the bf16 route's.
// - its dQ blocks: one per (64 query rows, head, batch),
//   eight warps: warp w owns 16 rows and one half of every 32-key tile;
//   the two halves of a row block are added once at the end, in order. Q
//   and dO resident, K and V one cp.async buffer each whose copies
//   alternate with the products that read the other (as the forward's).
//   192 KB at hd 256.
// - flash_bwd_sum_kernel<float>: the partials summed in head order.
// Tiles above the causal diagonal or before the window are skipped per
// warp; only diagonal, window-edge and ragged tiles are masked. q, k, v, dO
// need 16-byte aligned bases and batch, head and seq strides that are
// multiples of 4 floats (the wrapper copies a tensor that breaks the rule).
// Measured: PERF.md §6 (chip_smoke.py, tools/flash_compare.py).
//
// All tensors are read and written through element strides (batch, head,
// seq), the head_dim axis contiguous; lse and D are (B, H, S) float32. The
// bf16 route also needs 16-byte aligned q, k, v, dO and their batch, head
// and seq strides a multiple of 8 elements (the tensor maps' rule; the
// Python wrapper copies a tensor that breaks it).
#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using namespace hopper;
using namespace tf32;

// ---------------------------------------------------------------------------
// The D pass and the group sum (both routes)
// ---------------------------------------------------------------------------

constexpr int BW_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

struct BwdStrides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os, gb, gh, gs;  // g: dO
  long long dqb, dqh, dqs, dkb, dkh, dks, dvb, dvh, dvs;
};

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

// The group sum: dK and dV from each KV head's g per-head partials
// (part[1] and part[0], (B, H, Sk, hd) float32) summed in head order, head 0
// first, then stored once in T (bf16: rounded once). One thread per 4
// columns of one row of dK or dV.
__device__ __forceinline__ void store4(float* out, float4 x) {
  *reinterpret_cast<float4*>(out) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 packed;
  packed.x = *reinterpret_cast<const uint32_t*>(&lo);
  packed.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out) = packed;
}

template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_sum_kernel(const float* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv,
                         int B, int H, int K, int Sk, int hd, BwdStrides st, long long n4) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * n4) return;
  const int which = idx >= n4;  // 0: dV, 1: dK
  long long e = idx - which * n4;
  const int hd4 = hd >> 2;
  const int c = (int)(e % hd4) * 4;
  e /= hd4;
  const int s = (int)(e % Sk);
  e /= Sk;
  const int kvh = (int)(e % K);
  const int b = (int)(e / K);
  const int g = H / K;
  const long long head_stride = (long long)Sk * hd;
  const float* src =
      part + ((((long long)which * B + b) * H + (long long)kvh * g) * Sk + s) * hd + c;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int hh = 1; hh < g; ++hh) {
    const float4 x = *reinterpret_cast<const float4*>(src + hh * head_stride);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  store4(which ? dk + b * st.dkb + kvh * st.dkh + (long long)s * st.dks + c
               : dv + b * st.dvb + kvh * st.dvh + (long long)s * st.dvs + c,
         acc);
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on mma.sync
// ---------------------------------------------------------------------------

constexpr int F_THREADS = 256;  // eight warps
constexpr int F_KEYS = 64;      // dK/dV: keys a block, four warps of 16 twice over
constexpr int F_ROWS = 64;      // dQ: query rows a block, four warps of 16 twice over
constexpr int F_BK = 32;        // dQ: keys a K/V tile, a half of 16 for each warp of a row block

template <int HD>
struct BwdF32Shape {
  // tile rows in floats: whole 128-byte lines, so that the swizzle (tf32::swz)
  // stays inside each row (hd 96: three lines)
  static constexpr int LD = HD < 32 ? 32 : HD;
  // the accumulating products: NU 8-column n-tiles take their B fragments
  // from one load of NU consecutive floats; NG such groups span the head dim
  static constexpr int NU = HD >= 32 ? 4 : 2;
  static constexpr int NG = HD / (8 * NU);
  // dK/dV: query rows a streamed Q / dO tile (two stages fit beside the
  // resident K and V at hd 256 only at 16), and its 8-column n-tiles
  static constexpr int BQ = HD == 256 ? 16 : 32;
  static constexpr int NQ = BQ / 8;
  // dK/dV shared memory (floats): K, V resident; two stages of Q and dO; the
  // Pᵀ hand-over, 4 pairs of warps × 32 lanes × 4·NQ values
  static constexpr int KD_V = F_KEYS * LD;
  static constexpr int KD_RING = 2 * F_KEYS * LD;
  static constexpr int KD_X = KD_RING + 4 * BQ * LD;
  static constexpr int KD_SMEM = (int)sizeof(float) * (KD_X + 4 * 32 * 4 * NQ);
  // dQ shared memory (floats): Q, dO resident; one K and one V tile
  static constexpr int DQ_G = F_ROWS * LD;
  static constexpr int DQ_K = 2 * F_ROWS * LD;
  static constexpr int DQ_V = DQ_K + F_BK * LD;
  static constexpr int DQ_SMEM = (int)sizeof(float) * (DQ_V + F_BK * LD);
  static constexpr int SMEM = KD_SMEM > DQ_SMEM ? KD_SMEM : DQ_SMEM;
};

// sc[j] = (rows gr, gr + 8 of A) · (row 8j + gr of B)ᵀ over the head dim:
// the score-shaped products S = Q·Kᵀ, dP = dO·Vᵀ, Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ,
// both operands K-major in swizzled tiles. a and b point at row gr of the
// A rows and of the B rows; o0 and o1 are the columns 4·tq and 16 + 4·tq
// swizzled for rows ≡ gr (mod 8). 16 head columns (two k-steps, the k
// index relabelled as in the forward) a chunk, one 16-byte load a
// fragment; hi·hi in sc, hi·lo + lo·hi in their own accumulator.
template <int HD, int LD, int NT>
__device__ __forceinline__ void score_tf32(float (&sc)[NT][4], const float* a, const float* b,
                                           int o0, int o1) {
  float cc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = cc[j][e] = 0.f;
#pragma unroll 2
  for (int ch = 0; ch < HD / 16; ++ch) {
    const int off = 32 * (ch >> 1) + ((ch & 1) ? o1 : o0);
    const float4 x0 = *reinterpret_cast<const float4*>(a + off);
    const float4 x1 = *reinterpret_cast<const float4*>(a + 8 * LD + off);
    uint32_t ah[2][4], al[2][4];
    split_tf32(x0.x, ah[0][0], al[0][0]);
    split_tf32(x1.x, ah[0][1], al[0][1]);
    split_tf32(x0.y, ah[0][2], al[0][2]);
    split_tf32(x1.y, ah[0][3], al[0][3]);
    split_tf32(x0.z, ah[1][0], al[1][0]);
    split_tf32(x1.z, ah[1][1], al[1][1]);
    split_tf32(x0.w, ah[1][2], al[1][2]);
    split_tf32(x1.w, ah[1][3], al[1][3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 y = *reinterpret_cast<const float4*>(b + 8 * j * LD + off);
      uint32_t bh[4], bl[4];
      split_tf32(y.x, bh[0], bl[0]);
      split_tf32(y.y, bh[1], bl[1]);
      split_tf32(y.z, bh[2], bl[2]);
      split_tf32(y.w, bh[3], bl[3]);
      mma_tf32(sc[j], ah[0], bh[0], bh[1]);
      mma_tf32(cc[j], ah[0], bl[0], bl[1]);
      mma_tf32(cc[j], al[0], bh[0], bh[1]);
      mma_tf32(sc[j], ah[1], bh[2], bh[3]);
      mma_tf32(cc[j], ah[1], bl[2], bl[3]);
      mma_tf32(cc[j], al[1], bh[2], bh[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] += cc[j][e];
}

// acc[G][u] += A·B over NK k-steps of 8: the accumulating products dV +=
// Pᵀ·dO, dK += dSᵀ·Q and dQ += dS·K. A's k-step kk is the accumulator tile
// p[kk] as it stands (its columns 8kk + 2tq and + 1 are k = tq and tq + 4:
// A = {c0, c2, c1, c3}); B is rows 8kk + 2tq and + 1 of a swizzled tile
// read MN-major, n-tile (G, u) its columns 8·NU·G + NU·gr + u, so one load
// of NU floats a row and group. b0 and b1 are the offsets of rows 2tq and
// 2tq + 1, column NU·gr, swizzled. hi·hi, hi·lo, lo·hi in that order.
template <int LD, int NU, int NG, int NK>
__device__ __forceinline__ void acc_tf32(float (&acc)[NG][NU][4], const float (&p)[NK][4],
                                         const float* tile, int b0, int b1) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t ph[4], pl[4];
    split_tf32(p[kk][0], ph[0], pl[0]);
    split_tf32(p[kk][2], ph[1], pl[1]);
    split_tf32(p[kk][1], ph[2], pl[2]);
    split_tf32(p[kk][3], ph[3], pl[3]);
    const float* r0 = tile + 8 * kk * LD + b0;
    const float* r1 = tile + 8 * kk * LD + b1;
#pragma unroll
    for (int G = 0; G < NG; ++G) {
      float y0[NU], y1[NU];
      lds<NU>(r0 + 8 * NU * G, y0);
      lds<NU>(r1 + 8 * NU * G, y1);
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        uint32_t h0, lo0, h1, lo1;
        split_tf32(y0[u], h0, lo0);
        split_tf32(y1[u], h1, lo1);
        mma_tf32(acc[G][u], ph, h0, h1);
        mma_tf32(acc[G][u], ph, lo0, lo1);
        mma_tf32(acc[G][u], pl, h0, h1);
      }
    }
  }
}

// An accumulator's rows, positions p and p + 8 (those below S, the rows'
// own length: queries for dQ, keys for dK / dV), times mul
// into out (row stride rs): the thread holds columns 8·NU·G + 2·NU·tq + u
// and + NU, 2·NU consecutive floats of each row
template <int NU, int NG>
__device__ __forceinline__ void store_rows(float* out, long long rs, const float (&acc)[NG][NU][4],
                                           int p, int S, int tq, float mul) {
#pragma unroll
  for (int G = 0; G < NG; ++G) {
    const int col = 8 * NU * G + 2 * NU * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (p + 8 * half >= S) continue;
      float* row = out + (long long)(p + 8 * half) * rs + col;
      float x[2 * NU];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        x[u] = acc[G][u][2 * half] * mul;
        x[NU + u] = acc[G][u][2 * half + 1] * mul;
      }
#pragma unroll
      for (int i = 0; i < 2 * NU; i += 4)
        *reinterpret_cast<float4*>(row + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
    }
  }
}

// dK and dV of block blk: (64 keys, query head h, batch), the first key
// blocks (which see the most queries when causal) first. Warp w owns keys
// 16·(w & 3) .. + 15 of the block. Warps 0-3 compute Pᵀ = exp2(Sᵀ·scale·
// log2e − lse·log2e) from Sᵀ = K·Qᵀ and hold dV += Pᵀ·dO; warps 4-7 compute
// dPᵀ = V·dOᵀ, take Pᵀ from warp w − 4 through shared memory (one named
// barrier a pair), form dSᵀ = Pᵀ ∘ (dPᵀ − D) and hold dK += dSᵀ·Q: each
// warp one 16 × hd accumulator, hd/2 registers a thread. K and V are
// resident; Q and dO tiles of BQ rows stream through two cp.async stages,
// the next tile's copy in flight during this tile's products, one
// block-wide barrier a tile. Writes h's float32 partials: part[0] = dV,
// part[1] = dK·scale, each (B, H, Sk, HD).
template <int HD>
__device__ __forceinline__ void dkdv_block(const float* __restrict__ q,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           const float* __restrict__ g,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ D,
                                           float* __restrict__ part, int B, int H, int K, int S,
                                           int Sk, BwdStrides st,
                                           int causal, int window, float scale,
                                           float scale_log2, int blk) {
  using Sh = BwdF32Shape<HD>;
  constexpr int LD = Sh::LD, NU = Sh::NU, NG = Sh::NG, BQ = Sh::BQ, NQ = Sh::NQ;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = smem + Sh::KD_V;
  float* ring = smem + Sh::KD_RING;  // stage s: Q at ring + 2s·BQ·LD, dO at + (2s + 1)·BQ·LD
  float* xbuf = smem + Sh::KD_X;

  const int bh = blk % (B * H);
  const int p0 = blk / (B * H) * F_KEYS;  // first key
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / K);
  const int p_last = min(p0 + F_KEYS, Sk) - 1;
  // the query tiles that can see a key of the block
  const int n_qt = (S + BQ - 1) / BQ;
  const int t_lo = causal ? p0 / BQ : 0;
  const int t_hi = window > 0 ? min(n_qt, (p_last + window - 1) / BQ + 1) : n_qt;
  const float* qh = q + b * st.qb + h * st.qh;
  const float* gh = g + b * st.gb + h * st.gh;

  load_rows<HD, F_KEYS, LD, F_THREADS, true>(sK, k + b * st.kb + kvh * st.kh, st.ks, p0, Sk);
  load_rows<HD, F_KEYS, LD, F_THREADS, true>(sV, v + b * st.vb + kvh * st.vh, st.vs, p0, Sk);
  load_rows<HD, BQ, LD, F_THREADS, true>(ring, qh, st.qs, t_lo * BQ, S);
  load_rows<HD, BQ, LD, F_THREADS, true>(ring + BQ * LD, gh, st.gs, t_lo * BQ, S);
  rt::cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int wg = warp >> 2, wk = warp & 3;
  const int kw0 = p0 + 16 * wk;          // this warp's first key
  const int kw1 = min(kw0 + 15, Sk - 1);  // and last valid key
  // its query tiles [a_lo, a_hi): none when its keys start past Sk
  const int a_lo = max(t_lo, causal ? kw0 / BQ : 0);
  const int a_hi =
      kw0 < Sk ? min(t_hi, window > 0 ? (kw1 + window - 1) / BQ + 1 : n_qt) : a_lo;
  const int sa = swz(gr);
  const int o0 = (4 * tq) ^ sa, o1 = (16 + 4 * tq) ^ sa;
  const int b0 = 2 * tq * LD + ((NU * gr) ^ swz(2 * tq));
  const int b1 = (2 * tq + 1) * LD + ((NU * gr) ^ swz(2 * tq + 1));
  const float* a_rows = (wg == 0 ? sK : sV) + (16 * wk + gr) * LD;
  // the tile's queries' lse in log2 units (for Pᵀ) or D (for dSᵀ)
  const float* cvals = (wg == 0 ? lse : D) + ((long long)b * H + h) * S;
  const float cmul = wg == 0 ? LOG2E : 1.f;
  float* xw = xbuf + wk * (32 * 4 * NQ) + lane;  // pair wk's hand-over: value i at xw[32·i]

  float acc[NG][NU][4];
#pragma unroll
  for (int G = 0; G < NG; ++G)
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[G][u][e] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int i = t - t_lo;
    const float* sQ = ring + (i & 1) * 2 * BQ * LD;
    const float* sG = sQ + BQ * LD;
    rt::cp_async_wait<0>();
    __syncthreads();  // tile t has landed, and every warp is done with tile t - 1
    if (t + 1 < t_hi) {
      float* nQ = ring + ((i + 1) & 1) * 2 * BQ * LD;
      load_rows<HD, BQ, LD, F_THREADS, true>(nQ, qh, st.qs, (t + 1) * BQ, S);
      load_rows<HD, BQ, LD, F_THREADS, true>(nQ + BQ * LD, gh, st.gs, (t + 1) * BQ, S);
      rt::cp_async_commit();
    }
    if (t < a_lo || t >= a_hi) continue;
    const int c0 = t * BQ;  // first query
    float cv[NQ][2];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int qp = c0 + 8 * j + 2 * tq + u;
        cv[j][u] = qp < S ? cvals[qp] * cmul : 0.f;
      }

    // Sᵀ = K·Qᵀ or dPᵀ = V·dOᵀ; sc[j][e]: key kw0 + gr + 8·(e >> 1), query
    // c0 + 8j + 2tq + (e & 1)
    float sc[NQ][4];
    score_tf32<HD, LD, NQ>(sc, a_rows, (wg == 0 ? sQ : sG) + gr * LD, o0, o1);
    if (wg == 0) {
      const bool masked = (c0 + BQ > S) || (kw0 + 16 > Sk) || (causal && kw0 + 15 > c0) ||
                          (window > 0 && kw0 <= c0 + BQ - 1 - window);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(sc[j][e] * scale_log2 - cv[j][e & 1]);
          if (masked) {
            const int kp = kw0 + gr + 8 * (e >> 1), qp = c0 + 8 * j + 2 * tq + (e & 1);
            bool ok = qp < S && kp < Sk;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
            p = ok ? p : 0.f;
          }
          sc[j][e] = p;
          xw[32 * (4 * j + e)] = p;
        }
      }
      bar_arrive(1 + wk, 64);
    } else {
      bar_sync(1 + wk, 64);  // warp wk's Pᵀ is in the hand-over
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = xw[32 * (4 * j + e)] * (sc[j][e] - cv[j][e & 1]);
    }
    // dV += Pᵀ·dO or dK += dSᵀ·Q
    acc_tf32<LD, NU, NG, NQ>(acc, sc, wg == 0 ? sG : sQ, b0, b1);
  }

  if (kw0 >= Sk) return;
  store_rows<NU, NG>(part + (((long long)wg * B + b) * H + h) * Sk * HD, HD, acc, kw0 + gr, Sk,
                     tq, wg == 0 ? 1.f : scale);
}

// dQ of block blk: (64 query rows, head, batch), the heaviest causal
// query tiles (the last) first. Warp w owns rows 16·(w & 3) .. + 15 and
// keys 16·(w >> 2) .. + 15 of every 32-key tile: it computes dP = dO·Vᵀ and
// S = Q·Kᵀ, P = exp2(S·scale·log2e − lse·log2e), dS = P ∘ (dP − D) and
// dQ += dS·K for its half of the keys; the two warps of a row block add
// their halves once at the end, half 0 first. Q and dO are resident; K
// and V have one cp.async buffer each, whose copies alternate with the
// products that read the other: V of tile t + 1 lands during tile t's S
// and dQ products, K of tile t + 1 during tile t + 1's dP.
template <int HD>
__device__ __forceinline__ void dq_block(const float* __restrict__ q,
                                         const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         const float* __restrict__ g,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ D, float* __restrict__ dq,
                                         int B, int H, int K, int S, int Sk, BwdStrides st,
                                         int causal, int window, float scale, float scale_log2,
                                         int blk) {
  using Sh = BwdF32Shape<HD>;
  constexpr int LD = Sh::LD, NU = Sh::NU, NG = Sh::NG;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sG = smem + Sh::DQ_G;
  float* sK = smem + Sh::DQ_K;
  float* sV = smem + Sh::DQ_V;

  const int n_qb = (S + F_ROWS - 1) / F_ROWS;
  const int bh = blk % (B * H);
  const int q0 = (n_qb - 1 - blk / (B * H)) * F_ROWS;  // first query row
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / K);
  // the key tiles that a row of the block can see
  const int n_kt = (Sk + F_BK - 1) / F_BK;
  const int q_last = min(q0 + F_ROWS, S) - 1;
  const int kt_hi = causal ? min(n_kt, q_last / F_BK + 1) : n_kt;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / F_BK : 0;
  const float* kbase = k + b * st.kb + kvh * st.kh;
  const float* vbase = v + b * st.vb + kvh * st.vh;

  load_rows<HD, F_ROWS, LD, F_THREADS, true>(sQ, q + b * st.qb + h * st.qh, st.qs, q0, S);
  load_rows<HD, F_ROWS, LD, F_THREADS, true>(sG, g + b * st.gb + h * st.gh, st.gs, q0, S);
  load_rows<HD, F_BK, LD, F_THREADS, true>(sV, vbase, st.vs, kt_lo * F_BK, Sk);
  rt::cp_async_commit();
  load_rows<HD, F_BK, LD, F_THREADS, true>(sK, kbase, st.ks, kt_lo * F_BK, Sk);
  rt::cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int wr = warp & 3, half = warp >> 2;
  const int qw0 = q0 + 16 * wr;          // this warp's first row
  const int qw1 = min(qw0 + 15, S - 1);  // and last valid row
  const bool live = qw0 < S;
  const int qpos0 = qw0 + gr, qpos1 = qpos0 + 8;
  const long long row0 = ((long long)b * H + h) * S;
  const int sa = swz(gr);
  const int o0 = (4 * tq) ^ sa, o1 = (16 + 4 * tq) ^ sa;
  const int b0 = 2 * tq * LD + ((NU * gr) ^ swz(2 * tq));
  const int b1 = (2 * tq + 1) * LD + ((NU * gr) ^ swz(2 * tq + 1));
  const float* aQ = sQ + (16 * wr + gr) * LD;
  const float* aG = sG + (16 * wr + gr) * LD;
  const float* kh = sK + 16 * half * LD;  // this warp's keys of the K tile
  const float* vh = sV + 16 * half * LD;  // and of the V tile

  float acc[NG][NU][4];
#pragma unroll
  for (int G = 0; G < NG; ++G)
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[G][u][e] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const bool more = kt + 1 < kt_hi;
    const int kw0 = kt * F_BK + 16 * half;  // this warp's first key
    const bool active = live && kw0 < Sk && (!causal || kw0 <= qw1) &&
                        (window <= 0 || kw0 + 15 > qw0 - window);
    rt::cp_async_wait<1>();  // Q, dO and this tile's V have landed; its K may be in flight
    __syncthreads();
    // dP = dO·Vᵀ; dp[j][e]: row qw0 + gr + 8·(e >> 1), key kw0 + 8j + 2tq + (e & 1)
    float dp[2][4];
    if (active) score_tf32<HD, LD, 2>(dp, aG, vh + gr * LD, o0, o1);
    __syncthreads();  // every warp is done with this tile's V
    if (more) {
      load_rows<HD, F_BK, LD, F_THREADS, true>(sV, vbase, st.vs, (kt + 1) * F_BK, Sk);
      rt::cp_async_commit();
      rt::cp_async_wait<1>();  // this tile's K has landed; the next V may not
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      float sc[2][4];
      score_tf32<HD, LD, 2>(sc, aQ, kh + gr * LD, o0, o1);  // S = Q·Kᵀ
      // the rows' lse in log2 units and D, read where they are used (held
      // across the loop, they spill the hd-256 instantiation)
      const float l0 = qpos0 < S ? lse[row0 + qpos0] * LOG2E : 0.f;
      const float l1 = qpos1 < S ? lse[row0 + qpos1] * LOG2E : 0.f;
      const float d0 = qpos0 < S ? D[row0 + qpos0] : 0.f;
      const float d1 = qpos1 < S ? D[row0 + qpos1] : 0.f;
      const bool masked = (kw0 + 16 > Sk) || (qw0 + 16 > S) || (causal && kw0 + 15 > qw0) ||
                          (window > 0 && kw0 <= qw1 - window);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool r1 = e >= 2;
          float p = exp2f(sc[j][e] * scale_log2 - (r1 ? l1 : l0));
          if (masked) {
            const int kp = kw0 + 8 * j + 2 * tq + (e & 1), qp = r1 ? qpos1 : qpos0;
            bool ok = qp < S && kp < Sk;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
            p = ok ? p : 0.f;
          }
          sc[j][e] = p * (dp[j][e] - (r1 ? d1 : d0));  // dS
        }
      }
      acc_tf32<LD, NU, NG, 2>(acc, sc, kh, b0, b1);  // dQ += dS·K
    }
    __syncthreads();  // every warp is done with this tile's K
    if (more) {
      load_rows<HD, F_BK, LD, F_THREADS, true>(sK, kbase, st.ks, (kt + 1) * F_BK, Sk);
      rt::cp_async_commit();
    }
  }

  // half 1's dQ through shared memory (the K and V buffers: 64·LD floats),
  // added to half 0's
  float* xq = sK + (threadIdx.x & 127);
  if (half == 1) {
#pragma unroll
    for (int G = 0; G < NG; ++G)
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) xq[128 * ((G * NU + u) * 4 + e)] = acc[G][u][e];
  }
  __syncthreads();
  if (half == 1 || !live) return;
#pragma unroll
  for (int G = 0; G < NG; ++G)
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[G][u][e] += xq[128 * ((G * NU + u) * 4 + e)];
  store_rows<NU, NG>(dq + b * st.dqb + h * st.dqh, st.dqs, acc, qpos0, S, tq, scale);
}

// dQ, dK and dV in one launch of n_kv + n_q blocks, n_kv = ceil(Sk/64)·B·H
// dK/dV blocks and n_q = ceil(S/64)·B·H dQ blocks: while both kinds last,
// even blocks are dK/dV blocks and odd blocks dQ blocks, then the rest of
// the longer list; each list heaviest first, so that the two kinds share
// the card (at small shapes neither fills it alone).
template <int HD>
__global__ void __launch_bounds__(F_THREADS, 1)
    flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ D,
                         float* __restrict__ part, float* __restrict__ dq, int B, int H, int K,
                         int S, int Sk, BwdStrides st,
                         int causal, int window, float scale, float scale_log2) {
  const int n_kv = (Sk + F_KEYS - 1) / F_KEYS * B * H;
  const int n_q = (S + F_ROWS - 1) / F_ROWS * B * H;
  const int both = min(n_kv, n_q);
  const int x = (int)blockIdx.x;
  const bool is_dq = x < 2 * both ? (x & 1) : n_q > n_kv;
  const int blk = x < 2 * both ? x >> 1 : x - both;
  if (is_dq)
    dq_block<HD>(q, k, v, g, lse, D, dq, B, H, K, S, Sk, st, causal, window, scale, scale_log2,
                 blk);
  else
    dkdv_block<HD>(q, k, v, g, lse, D, part, B, H, K, S, Sk, st, causal, window, scale,
                   scale_log2, blk);
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const void* o, const void* g,
               const float* lse, float* D, float* part, void* dq, void* dk, void* dv, int B,
               int H, int K, int S, int Sk, const BwdStrides& st, int causal, int window,
               float scale, cudaStream_t stream) {
  // the 16-byte copies of q, k, v, dO and stores of dq, dk, dv: 16-byte
  // aligned bases, every batch, head and seq stride a multiple of 4 floats
  // (the wrapper copies an input that breaks the rule)
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(g) |
                          reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
                          reinterpret_cast<uintptr_t>(dv);
  const long long strides = st.qb | st.qh | st.qs | st.kb | st.kh | st.ks | st.vb | st.vh |
                            st.vs | st.gb | st.gh | st.gs | st.dqb | st.dqh | st.dqs | st.dkb |
                            st.dkh | st.dks | st.dvb | st.dvh | st.dvs;
  if ((bases & 15) || (strides & 3) || part == nullptr) return (int)cudaErrorInvalidValue;
  using Sh = BwdF32Shape<HD>;
  static int smem_set[rt::kMaxDevices];
  cudaError_t e = rt::max_dynamic_smem(reinterpret_cast<const void*>(flash_bwd_f32_kernel<HD>),
                                       Sh::SMEM, smem_set);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)B * H * S;
  const long long dot_blocks = (rows + BW_THREADS / 32 - 1) / (BW_THREADS / 32);
  const long long blocks =
      ((long long)((Sk + F_KEYS - 1) / F_KEYS) + (S + F_ROWS - 1) / F_ROWS) * B * H;
  const long long n4 = (long long)B * K * Sk * (HD / 4);
  const long long sum_blocks = (2 * n4 + 255) / 256;
  if (dot_blocks > 2147483647LL || blocks > 2147483647LL || sum_blocks > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(g);
  flash_bwd_dot_kernel<float><<<(unsigned)dot_blocks, BW_THREADS, 0, stream>>>(
      static_cast<const float*>(o), gt, D, H, S, HD, st, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_f32_kernel<HD><<<(unsigned)blocks, F_THREADS, Sh::SMEM, stream>>>(
      qt, kt, vt, gt, lse, D, part, static_cast<float*>(dq), B, H, K, S, Sk, st, causal, window,
      scale, scale * LOG2E);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_sum_kernel<float><<<(unsigned)sum_blocks, 256, 0, stream>>>(
      part, static_cast<float*>(dk), static_cast<float*>(dv), B, H, K, Sk, HD, st, n4);
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

template <int HD>
struct BwdShape {
  // row padded to whole 64-column blocks (hd 96 and 112: two, columns 96 or
  // 112 to 127 zeros, never stored)
  static constexpr int HDP = (HD + 63) / 64 * 64;
  static constexpr int NDB = HDP / 64;  // 64-column blocks
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
// (B, H, Sk, HD).
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
                        long long dqs, int B, int H, int K, int S, int Sk, int causal,
                        int window, float scale, float scale_log2) {
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

  // dQ: heaviest causal query tiles (the last) first; dK/dV: the first key
  // tiles. The resident rows are queries (dQ, S of them) or keys (dK/dV,
  // Sk), the streamed rows the other kind.
  const int S_res = DQ ? S : Sk, S_str = DQ ? Sk : S;
  const int n_res = (S_res + TB_ROWS - 1) / TB_ROWS, n_str = (S_str + TB_ROWS - 1) / TB_ROWS;
  const int bh = blockIdx.x % (B * H);
  const int own = DQ ? n_res - 1 - (int)(blockIdx.x / (B * H)) : (int)(blockIdx.x / (B * H));
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / K);
  const int p0 = own * TB_ROWS;  // first resident position
  const int p_last = min(p0 + TB_ROWS, S_res) - 1;
  int t_lo, t_hi;  // the streamed tiles that hold a visible pair
  if (DQ) {
    t_hi = causal ? min(n_str, p_last / TB_ROWS + 1) : n_str;
    t_lo = window > 0 ? max(0, p0 - window + 1) / TB_ROWS : 0;
  } else {
    t_lo = causal ? own : 0;
    t_hi = window > 0 ? min(n_str, (p_last + window - 1) / TB_ROWS + 1) : n_str;
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
    const bool masked = (qa + TB_ROWS > S) || (ka + TB_ROWS > Sk) ||
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
            bool ok = qp < S && kp < Sk;
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
    float* out = part + (((long long)wg * B + b) * H + h) * Sk * HD;
#pragma unroll
    for (int nb = 0; nb < NDB; ++nb) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = nb * 64 + 8 * j + cq;
        if (col >= HD) continue;
        if (rp0 < Sk)
          *reinterpret_cast<float2*>(out + (long long)rp0 * HD + col) =
              make_float2(acc[nb][4 * j] * mul, acc[nb][4 * j + 1] * mul);
        if (rp1 < Sk)
          *reinterpret_cast<float2*>(out + (long long)rp1 * HD + col) =
              make_float2(acc[nb][4 * j + 2] * mul, acc[nb][4 * j + 3] * mul);
      }
    }
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* o, const void* g,
              const float* lse, float* D, float* part, void* dq, void* dk, void* dv, int B,
              int H, int K, int S, int Sk, const BwdStrides& st, int causal, int window,
              float scale, cudaStream_t stream) {
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
  // dK/dV: a block per 64 keys; dQ: a block per 64 query rows
  const long long kv_blocks = (long long)((Sk + TB_ROWS - 1) / TB_ROWS) * B * H;
  const long long q_blocks = (long long)((S + TB_ROWS - 1) / TB_ROWS) * B * H;
  const long long n4 = (long long)B * K * Sk * (HD / 4);
  const long long sum_blocks = (2 * n4 + 255) / 256;
  if (dot_blocks > 2147483647LL || kv_blocks > 2147483647LL || q_blocks > 2147483647LL ||
      sum_blocks > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tg;
  if (!encode_map(&tq, q, HD, S, H, B, st.qb, st.qh, st.qs, TB_ROWS) ||
      !encode_map(&tk, k, HD, Sk, K, B, st.kb, st.kh, st.ks, TB_ROWS) ||
      !encode_map(&tv, v, HD, Sk, K, B, st.vb, st.vh, st.vs, TB_ROWS) ||
      !encode_map(&tg, g, HD, S, H, B, st.gb, st.gh, st.gs, TB_ROWS))
    return (int)cudaErrorInvalidValue;
  flash_bwd_dot_kernel<__nv_bfloat16><<<(unsigned)dot_blocks, BW_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(g), D, H, S, HD,
      st, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = scale * LOG2E;
  flash_bwd_tc_kernel<HD, false><<<(unsigned)kv_blocks, TB_THREADS, smem, stream>>>(
      tk, tv, tq, tg, lse, D, part, nullptr, 0, 0, 0, B, H, K, S, Sk, causal, window, scale,
      scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_tc_kernel<HD, true><<<(unsigned)q_blocks, TB_THREADS, smem, stream>>>(
      tq, tg, tk, tv, lse, D, nullptr, static_cast<__nv_bfloat16*>(dq), st.dqb, st.dqh, st.dqs,
      B, H, K, S, Sk, causal, window, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_sum_kernel<__nv_bfloat16><<<(unsigned)sum_blocks, 256, 0, stream>>>(
      part, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, H, K, Sk, HD,
      st, n4);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const void*, const void*, const void*, const void*, const void*,
                         const float*, float*, float*, void*, void*, void*, int, int, int, int,
                         int, const BwdStrides&, int, int, float, cudaStream_t);

LaunchFn pick(int dtype, int hd) {
  const bool bf = dtype == rt::kBF16;
  if (dtype != rt::kF32 && !bf) return nullptr;
  switch (hd) {
    case 16: return bf ? launch_tc<16> : launch_f32<16>;
    case 32: return bf ? launch_tc<32> : launch_f32<32>;
    case 64: return bf ? launch_tc<64> : launch_f32<64>;
    case 96: return bf ? launch_tc<96> : launch_f32<96>;
    // bf16 only: the float32 route's swizzled tiles need whole 128-byte
    // lines, and 112 floats are 3.5 (BwdF32Shape); the wrapper raises first
    case 112: return bf ? launch_tc<112> : LaunchFn{nullptr};
    case 128: return bf ? launch_tc<128> : launch_f32<128>;
    case 256: return bf ? launch_tc<256> : launch_f32<256>;
    default: return nullptr;
  }
}

}  // namespace

// strides: 24 element strides, (batch, head, seq) for q, k, v, o, dO, dq,
// dk and dv in that order; the head_dim axis of every tensor has stride 1.
// lse: (B, H, S) float32 from the forward; D: (B, H, S) float32 scratch;
// part: (2, B, H, Sk, hd) float32 scratch for the per-head dV and dK
// partials.
//
// Sk: the keys' length (k, v, dk and dv are (B, K, Sk, hd)); Sk != S only
// with causal = 0 and window = 0, as in the forward.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse, void* D,
                                      void* part, void* dq, void* dk, void* dv, int B, int H,
                                      int K, int S, int Sk, int hd, const long long* strides,
                                      int causal, int window, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || S <= 0 || Sk <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (Sk != S && (causal || window)) return (int)cudaErrorInvalidValue;
  const LaunchFn fn = pick(dtype, hd);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const long long* t = strides;
  BwdStrides st{t[0],  t[1],  t[2],  t[3],  t[4],  t[5],  t[6],  t[7],
                t[8],  t[9],  t[10], t[11], t[12], t[13], t[14], t[15],
                t[16], t[17], t[18], t[19], t[20], t[21], t[22], t[23]};
  return fn(q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(D),
            static_cast<float*>(part), dq, dk, dv, B, H, K, S, Sk, st, causal, window, scale,
            static_cast<cudaStream_t>(stream));
}
