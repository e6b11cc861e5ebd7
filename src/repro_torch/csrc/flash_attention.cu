// Blocked causal / sliding-window GQA attention, forward only, for prefill
// self-attention with positions 0..S-1, and not-causal attention of S
// queries over Sk keys (an encoder's self-attention, Sk = S; a
// cross-attention over an encoder's memory, Sk != S, which is never causal
// or windowed: the wrapper refuses that). Two kernels in one source, chosen
// by the input type, both on Hopper's tensor cores: bfloat16 on wgmma,
// float32 on mma.sync as 3xTF32. Asked for it (a non-null lse), either also
// writes each row's float32 log-sum-exp, the input of the backward in
// flash_attention_bwd.cu.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (pallas_call at :99, body _flash_kernel at :26).
//
// Bound on the H100: operations at the long shapes. recurrentgemma-9b's
// attn_local layers (B=4, H=16, K=1, S=2048, hd=256, window 2048 = S, bf16)
// do 4·B·H·hd·S(S+1)/2 = 137.5 GFLOP over 142 MB of inputs and output:
// ~0.139 ms at 989 TFLOP/s against ~0.042 ms at 3.35 TB/s. gemma-2b's shape
// (B=4, H=8, K=1, S=512) is ~4.3 GFLOP over ~19 MB: bytes and operations
// both bound it to a few microseconds. In float32 the card's fastest
// float32-accurate product is three TF32 passes at 495 TFLOP/s, ~165
// TFLOP/s: the train_llm surface (B=8, H=K=8, S=2048, hd=256, causal) is
// 137.5 GFLOP, ~0.83 ms.
//
// bf16 design (flash_tc_kernel): one block of three warpgroups per
// (128 query rows, head, batch), two consumers of 64 rows each and one
// producer.
// - The producer's one active thread fills shared memory with TMA: Q once
//   (128 rows, resident), then K and V tiles of 64 keys into a ring of two
//   stages, with a "full" and an "empty" mbarrier per stage, so the next
//   tile's copy overlaps this tile's products and the consumers never
//   wait on a block-wide barrier. Each TMA box lands as a 64-column block
//   of 128-byte rows in the 128-byte swizzle that the wgmma descriptors
//   name. At hd 256 that is 64 + 2·(32 + 32) = 192 KB of dynamic shared
//   memory. Rows past S and, for hd < 64, columns past hd arrive as zeros.
// - setmaxnreg moves registers from the producer (24 a thread) to the
//   consumers (240): the O accumulator alone is 64 × hd float32 per
//   warpgroup, 128 registers a thread at hd 256.
// - S = Q·Kᵀ per consumer warpgroup with wgmma.mma_async m64n64k16, Q and
//   K both read from shared memory K-major (a [row][d] tile already is).
// - The online softmax runs in float32 in the accumulator registers (exp2
//   with the scale folded in, float32 running max and per-thread partial
//   sums); P is rounded to bf16 into wgmma A fragments in registers and
//   O += P·V runs as m64n64k16 with A from registers and V read from
//   shared memory MN-major (the transpose bit), 64 output columns per
//   instruction.
// - k-tiles above the causal diagonal and before the window are skipped
//   per warpgroup; only diagonal, window-edge and ragged tiles are masked.
//   The heaviest causal q-tiles are issued first.
// - P·V uses P rounded to bf16 (as SDPA does), the reference keeps it in
//   float32: the difference stays inside the bf16 tolerance (checked on
//   the CPU by a float32 emulation of this arithmetic in the tests).
// - Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): at
//   recurrentgemma-9b's shape about 0.33 ms on the device, 2.3× the
//   operations bound (~420 TFLOP/s).
//
// float32 design (flash_f32_kernel): one block of eight warps per (128
// query rows, head, batch), each warp owning 16 rows; every product on
// mma.sync m16n8k8 tf32 (wgmma takes tf32 only K-major from shared memory,
// and V is MN-major for P·V).
// - Exactness: one TF32 rounding of each operand leaves ~1e-3 of error, 50x
//   the float32 tolerance. Each operand x is split as it is loaded into hi
//   = tf32(x) and lo = tf32(x - hi) (round to nearest, ties away, as
//   cvt.rna does, by two integer operations), and each product is
//   hi·hi + hi·lo + lo·hi (lo·lo, ~2^-22 relative, is dropped): the error
//   of float32 itself (tests/test_torch_flash_f32.py emulates it). The
//   products and the tiles run in one fixed order, so a call's bits repeat.
// - Bound: three passes make the tensor-core work 3x the function's, and
//   every fragment is split by integer ops, ~0.8 splits an mma. A block of
//   128 rows halves the K/V bytes that each flop needs from L2 against 64
//   rows (at 64 rows the tensor cores' rate asks ~5 TB/s of L2), and eight
//   warps give each SM sub-partition two warps to interleave splits, loads
//   and mma.
// - Shared memory: Q resident (128 rows), K and V tiles of 32 keys with one
//   buffer each, filled by 16-byte cp.async: K of tile t + 1 lands during
//   tile t's softmax and P·V, V of tile t + 1 during tile t + 1's Q·Kᵀ. At
//   hd 256: 136 + 34 + 33 = 203 KB, one block an SM. Row strides are padded
//   (Q, K ≡ 16 mod 32 floats; V ≡ 4 mod 16) so that the 16-byte fragment
//   loads are free of bank conflicts.
// - Layouts: the mma's k index is relabelled (see flash_f32_kernel), so
//   that Q, K and V fragments are 16-byte loads and P passes from S's
//   accumulator layout to P·V's A fragment in place, with no shuffle and
//   no patch of shared memory.
// - The online softmax runs in float32 registers (exp2, the scale folded
//   in); k-tiles above the causal diagonal and before the window are
//   skipped per warp, and only diagonal, window-edge and ragged tiles are
//   masked. The heaviest causal q-tiles are issued first. O is hd/2
//   registers a thread (128 at hd 256).
// - q, k and v need 16-byte aligned bases and batch, head and sequence
//   strides that are multiples of 4 floats; the wrapper copies a tensor
//   that breaks the rule.
// - Measured: see PERF.md §6 (chip_smoke.py).
//
// Keys: every key loop, the tensor maps and cp.async reads of K and V, and
// the ragged-tile guards run to Sk; queries, o and lse to S.
//
// Both read q, k, v and write o through element strides, so the model's
// (B, S, H, hd) projections are passed as (B, H, S, hd) views without a
// copy. The division keeps the Pallas kernel's max(l, 1e-30) guard.
#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using namespace hopper;
using namespace tf32;

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// ---------------------------------------------------------------------------
// float32: 3xTF32 on mma.sync
// ---------------------------------------------------------------------------

constexpr int F_BQ = 128;  // query rows per block: eight warps of 16
constexpr int F_BK = 32;   // keys per k-tile
constexpr int F_THREADS = 256;

template <int HD>
struct F32Shape {
  // Row strides in floats. Q and K: ≡ 16 (mod 32), so that the 8 lanes of
  // a 16-byte load phase (rows gr, gr + 1; 16 bytes each at 4·tq) cover all
  // 32 banks; V: ≡ 4 (mod 16), the same for rows 2·tq and columns NU·gr.
  static constexpr int LDQ = HD % 32 == 0 ? HD + 16 : HD;
  static constexpr int LDV = HD + 4;
  // P·V: NU 8-column n-tiles take their B fragments from one load of NU
  // consecutive floats; NG such groups span the head dim
  static constexpr int NU = HD >= 32 ? 4 : 2;
  static constexpr int NG = HD / (8 * NU);
  static constexpr int K_OFF = F_BQ * LDQ;
  static constexpr int V_OFF = K_OFF + F_BK * LDQ;
  static constexpr int SMEM = (int)sizeof(float) * (V_OFF + F_BK * LDV);
  // blocks an SM for the register budget (O is hd/2 registers a thread):
  // at hd 32 and 64 the cap of two blocks (128 registers) spills
  static constexpr int MIN_BLOCKS = HD == 16 ? 2 : 1;
};

// One block per (128 query rows, head, batch); warp w owns rows 16w .. 16w
// + 15. Fragments (lane = 4·gr + tq) follow mma.m16n8k8's tf32 layout with
// the k index relabelled, which leaves a product unchanged when A and B
// agree on it:
// - S = Q·Kᵀ, 16 columns of the head dim (two k-steps) per chunk ch: k = tq
//   and tq + 4 of step 2ch + i are columns 16ch + 4tq + 2i and + 1, so a
//   thread's A (rows gr, gr + 8) and B (key gr of n-tile j) fragments of
//   both steps are one 16-byte load each.
// - O += P·V, keys 8kk .. 8kk + 7 per k-step kk: k = tq and tq + 4 are keys
//   8kk + 2tq and + 1, which are exactly the columns of S's accumulator
//   c0, c1 (row gr) and c2, c3 (row gr + 8) in n-tile kk. So P's A fragment
//   is {c0, c2, c1, c3} of S: no shuffle and no trip through shared memory.
//   V's column n = gr of n-tile (G, u) is head column 8·NU·G + NU·gr + u,
//   so the B fragments of the NU n-tiles of group G are one load per key.
//   The accumulator's c0, c1 then hold head columns 8·NU·G + 2·NU·tq + u
//   and + NU: each thread writes 2·NU consecutive columns of a row.
template <int HD>
__global__ void __launch_bounds__(F_THREADS, F32Shape<HD>::MIN_BLOCKS)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int B, int H, int K, int S, int Sk, Strides st,
                     int causal, int window, float scale_log2) {
  using Sh = F32Shape<HD>;
  constexpr int LDQ = Sh::LDQ, LDV = Sh::LDV, NU = Sh::NU, NG = Sh::NG;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = smem + Sh::K_OFF;
  float* sV = smem + Sh::V_OFF;

  // heaviest causal q-tiles first: the last q-tile of every (b, h) leads
  const int n_qb = (S + F_BQ - 1) / F_BQ;
  const int bh = blockIdx.x % (B * H);
  const int qb = n_qb - 1 - blockIdx.x / (B * H);
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / K);
  const int q0 = qb * F_BQ;

  // the block's k-tiles
  const int n_kt = (Sk + F_BK - 1) / F_BK;
  const int q_last = min(q0 + F_BQ, S) - 1;
  const int kt_hi = causal ? min(n_kt, q_last / F_BK + 1) : n_kt;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / F_BK : 0;

  // K and V have a buffer each: K of tile kt + 1 is copied during tile kt's
  // softmax and P·V, V of tile kt + 1 during tile kt + 1's Q·Kᵀ
  const float* kbase = k + b * st.kb + kvh * st.kh;
  const float* vbase = v + b * st.vb + kvh * st.vh;
  load_rows<HD, F_BQ, LDQ, F_THREADS>(sQ, q + b * st.qb + h * st.qh, st.qs, q0, S);
  load_rows<HD, F_BK, LDQ, F_THREADS>(sK, kbase, st.ks, kt_lo * F_BK, Sk);
  rt::cp_async_commit();
  load_rows<HD, F_BK, LDV, F_THREADS>(sV, vbase, st.vs, kt_lo * F_BK, Sk);
  rt::cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int qw0 = q0 + 16 * warp;       // this warp's first row
  const int qw1 = min(qw0 + 15, S - 1);  // and last valid row
  const bool live = qw0 < S;
  const int wkt_hi = causal ? min(n_kt, qw1 / F_BK + 1) : n_kt;
  const int wkt_lo = window > 0 ? max(0, qw0 - window + 1) / F_BK : 0;
  const int qpos0 = qw0 + gr, qpos1 = qpos0 + 8;
  const float* qa = sQ + (16 * warp + gr) * LDQ + 4 * tq;  // row gr; + 8·LDQ: row gr + 8
  const float* kr = sK + gr * LDQ + 4 * tq;                 // key gr of n-tile 0
  const float* vr = sV + 2 * tq * LDV + NU * gr;            // key 2tq of k-step 0

  float oacc[NG][NU][4];
#pragma unroll
  for (int G = 0; G < NG; ++G)
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[G][u][e] = 0.f;
  float m0 = rt::kNegInit, m1 = rt::kNegInit;  // running max (log2 units), rows gr, gr + 8
  float l0 = 0.f, l1 = 0.f;                    // this thread's share of the running sums

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const bool active = live && kt >= wkt_lo && kt < wkt_hi;
    const bool more = kt + 1 < kt_hi;
    rt::cp_async_wait<1>();  // Q and K of this tile have landed; V may be in flight
    __syncthreads();

    // S = Q·Kᵀ as hi·hi + (hi·lo + lo·hi), the small terms in their own
    // accumulator; n-tile j holds keys 8j .. 8j + 7
    float sc[4][4];
    if (active) {
      float cc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = cc[j][e] = 0.f;
#pragma unroll 2
      for (int ch = 0; ch < HD / 16; ++ch) {
        const float4 x0 = *reinterpret_cast<const float4*>(qa + 16 * ch);
        const float4 x1 = *reinterpret_cast<const float4*>(qa + 8 * LDQ + 16 * ch);
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
        for (int j = 0; j < 4; ++j) {
          const float4 y = *reinterpret_cast<const float4*>(kr + 8 * j * LDQ + 16 * ch);
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
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] += cc[j][e];
    }
    __syncthreads();  // every warp is done with this tile's K
    if (more) {
      load_rows<HD, F_BK, LDQ, F_THREADS>(sK, kbase, st.ks, (kt + 1) * F_BK, Sk);
      rt::cp_async_commit();
    }

    if (active) {
      // online softmax; sc[j][e]: key 8j + 2tq + (e & 1), row gr + 8·(e >> 1)
      const int k0 = kt * F_BK;
      const bool masked = (k0 + F_BK > Sk) || (causal && k0 + F_BK - 1 > qw0) ||
                          (window > 0 && k0 <= qw1 - window);
      float mx0 = rt::kNegInit, mx1 = rt::kNegInit;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[j][e] * scale_log2;
          if (masked) {
            const int kp = k0 + 8 * j + 2 * tq + (e & 1);
            const int qp = e < 2 ? qpos0 : qpos1;
            bool ok = kp < Sk;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
            x = ok ? x : -INFINITY;
          }
          sc[j][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[j][0] = exp2f(sc[j][0] - mn0);
        sc[j][1] = exp2f(sc[j][1] - mn0);
        sc[j][2] = exp2f(sc[j][2] - mn1);
        sc[j][3] = exp2f(sc[j][3] - mn1);
        ps0 += sc[j][0] + sc[j][1];
        ps1 += sc[j][2] + sc[j][3];
      }
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
#pragma unroll
      for (int G = 0; G < NG; ++G)
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          oacc[G][u][0] *= a0;
          oacc[G][u][1] *= a0;
          oacc[G][u][2] *= a1;
          oacc[G][u][3] *= a1;
        }
    }

    if (more) rt::cp_async_wait<1>();  // this tile's V has landed; the next K may not
    else rt::cp_async_wait<0>();
    __syncthreads();
    if (active) {
      // O += P·V as P_hi·V_hi + P_hi·V_lo + P_lo·V_hi, in that order
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ph[4], pl[4];
        split_tf32(sc[kk][0], ph[0], pl[0]);
        split_tf32(sc[kk][2], ph[1], pl[1]);
        split_tf32(sc[kk][1], ph[2], pl[2]);
        split_tf32(sc[kk][3], ph[3], pl[3]);
        const float* v0 = vr + 8 * kk * LDV;  // key 8kk + 2tq; + LDV: key 8kk + 2tq + 1
#pragma unroll
        for (int G = 0; G < NG; ++G) {
          float y0[NU], y1[NU];
          lds<NU>(v0 + 8 * NU * G, y0);
          lds<NU>(v0 + LDV + 8 * NU * G, y1);
#pragma unroll
          for (int u = 0; u < NU; ++u) {
            uint32_t h0, lo0, h1, lo1;
            split_tf32(y0[u], h0, lo0);
            split_tf32(y1[u], h1, lo1);
            mma_tf32(oacc[G][u], ph, h0, h1);
            mma_tf32(oacc[G][u], ph, lo0, lo1);
            mma_tf32(oacc[G][u], pl, h0, h1);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this tile's V
    if (more) {
      load_rows<HD, F_BK, LDV, F_THREADS>(sV, vbase, st.vs, (kt + 1) * F_BK, Sk);
      rt::cp_async_commit();
    }
  }

  if (!live) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (lse != nullptr && tq == 0) {
    // natural-log units: sum_k exp(s·scale) = 2^m · l
    float* lrow = lse + ((long long)b * H + h) * S;
    if (qpos0 < S) lrow[qpos0] = (m0 + log2f(fmaxf(l0, 1e-30f))) * 0.6931471805599453f;
    if (qpos1 < S) lrow[qpos1] = (m1 + log2f(fmaxf(l1, 1e-30f))) * 0.6931471805599453f;
  }
  float* obase = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int G = 0; G < NG; ++G) {
    const int col = 8 * NU * G + 2 * NU * tq;  // this thread's 2·NU columns
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qp = half ? qpos1 : qpos0;
      const float inv = half ? inv1 : inv0;
      if (qp >= S) continue;
      float* orow = obase + (long long)qp * st.os + col;
      float x[2 * NU];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        x[u] = oacc[G][u][2 * half] * inv;
        x[NU + u] = oacc[G][u][2 * half + 1] * inv;
      }
#pragma unroll
      for (int i = 0; i < 2 * NU; i += 4)
        *reinterpret_cast<float4*>(orow + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
    }
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int K, int S, int Sk, const Strides& st, int causal, int window, float scale,
               cudaStream_t stream) {
  // the 16-byte copies and stores: 16-byte aligned bases, every batch, head
  // and sequence stride a multiple of 4 floats (the wrapper copies a tensor
  // that breaks the rule)
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const long long strides = st.qb | st.qh | st.qs | st.kb | st.kh | st.ks | st.vb | st.vh |
                            st.vs | st.ob | st.oh | st.os;
  if ((bases & 15) || (strides & 3)) return (int)cudaErrorInvalidValue;
  constexpr int smem = F32Shape<HD>::SMEM;
  static int smem_set[rt::kMaxDevices];
  const cudaError_t attr = rt::max_dynamic_smem(
      reinterpret_cast<const void*>(flash_f32_kernel<HD>), smem, smem_set);
  if (attr != cudaSuccess) return (int)attr;
  const long long blocks = (long long)((S + F_BQ - 1) / F_BQ) * B * H;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  flash_f32_kernel<HD><<<(unsigned)blocks, F_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, B, H, K, S, Sk, st, causal, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma kernel
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 128;      // query rows per block: two consumer warpgroups of 64
constexpr int TC_BK = 64;       // keys per k-tile
constexpr int TC_CONSUMERS = 256;
constexpr int TC_THREADS = TC_CONSUMERS + 128;  // + one producer warpgroup
// registers a thread after the producer gives its share to the consumers:
// 128·24 + 256·240 = 64,512 of the SM's 65,536
constexpr int TC_PRODUCER_REGS = 24;
constexpr int TC_CONSUMER_REGS = 240;

template <int HD>
struct TcShape {
  static constexpr int HDP = HD < 64 ? 64 : HD;  // row padded to whole 64-column blocks
  static constexpr int NDB = HDP / 64;           // 64-column blocks
  static constexpr int Q_BYTES = TC_BQ * HDP * 2;
  static constexpr int KV_BYTES = TC_BK * HDP * 2;  // one K or one V tile
  static constexpr int BAR_OFF = Q_BYTES + 4 * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 64 + SW_ATOM;  // + 5 mbarriers, + alignment slack
};

// The tensor maps view q as a 4-d (hd, S, heads, B) bf16 tensor and k and
// v as (hd, Sk, heads, B), with boxes of (64 columns, rows, 1, 1) in the
// 128-byte swizzle: each box lands as one 64-column block of swizzled
// 128-byte rows, the layout the wgmma descriptors name. Rows past S (Sk)
// and columns past hd are zero-filled.
template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int B, int H, int K, int S, int Sk, long long ob,
                    long long oh, long long os, int causal, int window, float scale_log2) {
  using Sh = TcShape<HD>;
  constexpr int NDB = Sh::NDB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + SW_ATOM - 1) & ~uint32_t(SW_ATOM - 1);
  const uint32_t sQ = base;
  const uint32_t sKV = base + Sh::Q_BYTES;  // stage s: K at sKV + 2s·KV, V at + (2s+1)·KV
  const uint32_t bar_q = base + Sh::BAR_OFF;  // Q arrived
  const uint32_t bar_full = bar_q + 8;        // [2]: stage s arrived
  const uint32_t bar_empty = bar_q + 24;      // [2]: stage s read by both warpgroups

  // heaviest causal q-tiles first: the last q-tile of every (b, h) leads
  const int n_qb = (S + TC_BQ - 1) / TC_BQ;
  const int bh = blockIdx.x % (B * H);
  const int qb = n_qb - 1 - blockIdx.x / (B * H);
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / K);
  const int q0 = qb * TC_BQ;
  const int tid = threadIdx.x;

  // the block's k-tiles
  const int n_kt = (Sk + TC_BK - 1) / TC_BK;
  const int q_last = min(q0 + TC_BQ, S) - 1;
  const int kt_hi = causal ? min(n_kt, q_last / TC_BK + 1) : n_kt;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / TC_BK : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_full, 1);
    mbar_init(bar_full + 8, 1);
    mbar_init(bar_empty, TC_CONSUMERS);
    mbar_init(bar_empty + 8, TC_CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= TC_CONSUMERS) {  // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(TC_PRODUCER_REGS));
    if (tid == TC_CONSUMERS && kt_lo < kt_hi) {
      mbar_expect_tx(bar_q, Sh::Q_BYTES);
#pragma unroll
      for (int db = 0; db < NDB; ++db)
        tma_load(sQ + db * (TC_BQ * SW_ROW), &tm_q, 64 * db, q0, h, b, bar_q);
      for (int kt = kt_lo; kt < kt_hi; ++kt) {
        const int i = kt - kt_lo, s = i & 1;
        if (i >= 2) mbar_wait(bar_empty + 8 * s, ((i >> 1) - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t tK = sKV + (2 * s) * Sh::KV_BYTES;
        mbar_expect_tx(full, 2 * Sh::KV_BYTES);
#pragma unroll
        for (int db = 0; db < NDB; ++db) {
          tma_load(tK + db * (TC_BK * SW_ROW), &tm_k, 64 * db, kt * TC_BK, kvh, b, full);
          tma_load(tK + Sh::KV_BYTES + db * (TC_BK * SW_ROW), &tm_v, 64 * db, kt * TC_BK, kvh,
                   b, full);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(TC_CONSUMER_REGS));
  const int wg = tid >> 7;  // consumer warpgroup: query rows q0 + 64·wg ..
  const int wtid = tid & 127;
  const int lane = tid & 31;
  const int r0 = ((wtid >> 5) << 4) + (lane >> 2);  // this thread's rows: r0, r0 + 8 of 64
  const int cq = (lane & 3) << 1;                    // its first column in each 8-column group
  const int qw0 = q0 + 64 * wg;                      // this warpgroup's first row
  const int qw1 = min(qw0 + 63, S - 1);              // and last valid row
  const bool wg_live = qw0 < S;
  const int wkt_hi = causal ? min(n_kt, qw1 / TC_BK + 1) : n_kt;
  const int wkt_lo = window > 0 ? max(0, qw0 - window + 1) / TC_BK : 0;
  const int qpos0 = qw0 + r0, qpos1 = qpos0 + 8;
  const uint32_t tQ = sQ + wg * 64 * SW_ROW;

  float oacc[NDB][32];
#pragma unroll
  for (int nb = 0; nb < NDB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[nb][i] = 0.f;
  float m0 = rt::kNegInit, m1 = rt::kNegInit;  // running max (log2 units), rows r0, r0 + 8
  float l0 = 0.f, l1 = 0.f;                    // this thread's share of the running sums

  if (kt_lo < kt_hi) mbar_wait(bar_q, 0);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int i = kt - kt_lo, s = i & 1;
    mbar_wait(bar_full + 8 * s, (i >> 1) & 1);
    if (wg_live && kt >= wkt_lo && kt < wkt_hi) {
      const uint32_t tK = sKV + (2 * s) * Sh::KV_BYTES;
      const uint32_t tV = tK + Sh::KV_BYTES;

      // S = Q·Kᵀ: hd/16 steps of k16, 32 bytes apart inside a 128-byte row
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Sh::HDP / 16; ++kk) {
        const uint32_t off = (kk & 3) << 5;
        const uint64_t da = sw128_desc(tQ + (kk >> 2) * (TC_BQ * SW_ROW) + off, 16, SW_ATOM);
        const uint64_t db = sw128_desc(tK + (kk >> 2) * (TC_BK * SW_ROW) + off, 16, SW_ATOM);
        wgmma_ss(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      reg_fence(sc);

      // online softmax over the tile; sc[4j + e]: key 8j + cq + (e & 1), row r0 + 8·(e >> 1)
      const int k0 = kt * TC_BK;
      const bool masked = (k0 + TC_BK > Sk) || (causal && k0 + TC_BK - 1 > qw0) ||
                          (window > 0 && k0 <= qw1 - window);
      float mx0 = rt::kNegInit, mx1 = rt::kNegInit;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (masked) {
            const int kp = k0 + 8 * j + cq + (e & 1);
            const int qp = e < 2 ? qpos0 : qpos1;
            bool ok = kp < Sk;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
            x = ok ? x : -INFINITY;
          }
          sc[4 * j + e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[4 * j + 0] = exp2f(sc[4 * j + 0] - mn0);
        sc[4 * j + 1] = exp2f(sc[4 * j + 1] - mn0);
        sc[4 * j + 2] = exp2f(sc[4 * j + 2] - mn1);
        sc[4 * j + 3] = exp2f(sc[4 * j + 3] - mn1);
        ps0 += sc[4 * j + 0] + sc[4 * j + 1];
        ps1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
      // P as bf16 A fragments: k16 step t covers keys 16t .. 16t + 15
      uint32_t pa[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        pa[t][0] = pack_bf16(sc[8 * t + 0], sc[8 * t + 1]);
        pa[t][1] = pack_bf16(sc[8 * t + 2], sc[8 * t + 3]);
        pa[t][2] = pack_bf16(sc[8 * t + 4], sc[8 * t + 5]);
        pa[t][3] = pack_bf16(sc[8 * t + 6], sc[8 * t + 7]);
      }
#pragma unroll
      for (int nb = 0; nb < NDB; ++nb) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          oacc[nb][4 * j + 0] *= a0;
          oacc[nb][4 * j + 1] *= a0;
          oacc[nb][4 * j + 2] *= a1;
          oacc[nb][4 * j + 3] *= a1;
        }
      }

      // O += P·V: V's 64-column block nb, keys 16t .. 16t + 15 (two 8-row groups)
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int nb = 0; nb < NDB; ++nb) {
          const uint64_t dv =
              sw128_desc(tV + nb * (TC_BK * SW_ROW) + t * 2 * SW_ATOM, TC_BK * SW_ROW, SW_ATOM);
          wgmma_rs_tb(oacc[nb], pa[t], dv);
        }
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int nb = 0; nb < NDB; ++nb) reg_fence(oacc[nb]);
    }
    mbar_arrive(bar_empty + 8 * s);  // this thread no longer reads stage s
  }

  if (!wg_live) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (lse != nullptr && (lane & 3) == 0) {
    // natural-log units: sum_k exp(s·scale) = 2^m · l
    float* lrow = lse + ((long long)b * H + h) * S;
    if (qpos0 < S) lrow[qpos0] = (m0 + log2f(fmaxf(l0, 1e-30f))) * 0.6931471805599453f;
    if (qpos1 < S) lrow[qpos1] = (m1 + log2f(fmaxf(l1, 1e-30f))) * 0.6931471805599453f;
  }
  __nv_bfloat16* obase = o + b * ob + h * oh;
#pragma unroll
  for (int nb = 0; nb < NDB; ++nb) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = nb * 64 + 8 * j + cq;
      if (col >= HD) continue;
      if (qpos0 < S)
        *reinterpret_cast<__nv_bfloat162*>(obase + (long long)qpos0 * os + col) =
            __floats2bfloat162_rn(oacc[nb][4 * j] * inv0, oacc[nb][4 * j + 1] * inv0);
      if (qpos1 < S)
        *reinterpret_cast<__nv_bfloat162*>(obase + (long long)qpos1 * os + col) =
            __floats2bfloat162_rn(oacc[nb][4 * j + 2] * inv1, oacc[nb][4 * j + 3] * inv1);
    }
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
              int K, int S, int Sk, const Strides& st, int causal, int window, float scale,
              cudaStream_t stream) {
  constexpr int smem = TcShape<HD>::SMEM;
  static int smem_set[rt::kMaxDevices];
  const cudaError_t attr = rt::max_dynamic_smem(
      reinterpret_cast<const void*>(flash_tc_kernel<HD>), smem, smem_set);
  if (attr != cudaSuccess) return (int)attr;
  const long long blocks = (long long)((S + TC_BQ - 1) / TC_BQ) * B * H;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, HD, S, H, B, st.qb, st.qh, st.qs, TC_BQ) ||
      !encode_map(&tk, k, HD, Sk, K, B, st.kb, st.kh, st.ks, TC_BK) ||
      !encode_map(&tv, v, HD, Sk, K, B, st.vb, st.vh, st.vs, TC_BK))
    return (int)cudaErrorInvalidValue;
  flash_tc_kernel<HD><<<(unsigned)blocks, TC_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, B, H, K, S, Sk, st.ob, st.oh, st.os, causal,
      window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const void*, const void*, const void*, void*, float*, int, int, int,
                         int, int, const Strides&, int, int, float, cudaStream_t);

LaunchFn pick(int dtype, int hd) {
  const bool bf = dtype == rt::kBF16;
  if (dtype != rt::kF32 && !bf) return nullptr;
  switch (hd) {
    case 16: return bf ? launch_tc<16> : launch_f32<16>;
    case 32: return bf ? launch_tc<32> : launch_f32<32>;
    case 64: return bf ? launch_tc<64> : launch_f32<64>;
    case 128: return bf ? launch_tc<128> : launch_f32<128>;
    case 256: return bf ? launch_tc<256> : launch_f32<256>;
    default: return nullptr;
  }
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) for q, k, v and o in that
// order; the head_dim axis of every tensor has stride 1. Both routes also
// need 16-byte aligned q, k, v and every q/k/v stride a multiple of 16
// bytes (8 bfloat16 elements: the tensor maps' rule; 4 float32: cp.async's,
// o's too); the Python wrapper checks (bfloat16) or copies (float32).
//
// lse: (B, H, S) float32, each row's log-sum-exp of its scaled, masked
// scores (the backward's input), or null when the caller does not ask.
//
// Sk: the keys' length (k and v are (B, K, Sk, hd)); Sk != S only with
// causal = 0 and window = 0.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int B, int H, int K, int S, int Sk, int hd,
                                  const long long* strides, int causal, int window, float scale,
                                  int dtype, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || S <= 0 || Sk <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (Sk != S && (causal || window)) return (int)cudaErrorInvalidValue;
  const LaunchFn fn = pick(dtype, hd);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],  strides[5],
             strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  return fn(q, k, v, o, static_cast<float*>(lse), B, H, K, S, Sk, st, causal, window, scale,
            static_cast<cudaStream_t>(stream));
}
