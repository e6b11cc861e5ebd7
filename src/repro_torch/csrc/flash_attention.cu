// Blocked causal / sliding-window GQA attention, forward only, for prefill
// self-attention with positions 0..S-1. Two kernels in one source, chosen
// by the input type: bfloat16 runs on Hopper's tensor cores (wgmma),
// float32 on plain FMA. Asked for it (a non-null lse), either also writes
// each row's float32 log-sum-exp, the input of the backward in
// flash_attention_bwd.cu.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (pallas_call at :99, body _flash_kernel at :26).
//
// Bound on the H100: operations at the long served shape. recurrentgemma-9b's
// attn_local layers (B=4, H=16, K=1, S=2048, hd=256, window 2048 = S, bf16)
// do 4·B·H·hd·S(S+1)/2 = 137.5 GFLOP over 142 MB of inputs and output:
// ~0.139 ms at 989 TFLOP/s against ~0.042 ms at 3.35 TB/s. gemma-2b's shape
// (B=4, H=8, K=1, S=512) is ~4.3 GFLOP over ~19 MB: bytes and operations
// both bound it to a few microseconds.
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
// float32 design (flash_fwd_kernel, unchanged from the first port): one
// block per (64 query rows, head, batch), each thread owning a query row's
// quarter of the columns; K/V tiles of 32 keys staged as float32 in
// shared memory and multiplied with FMA, so the float32 results stay exact
// to ~1e-6 (TF32 tensor cores would not be).
//
// Both read q, k, v and write o through element strides, so the model's
// (B, S, H, hd) projections are passed as (B, H, S, hd) views without a
// copy. The division keeps the Pallas kernel's max(l, 1e-30) guard.
#include "hopper.cuh"

namespace {

using namespace hopper;

// ---------------------------------------------------------------------------
// float32: FMA kernel
// ---------------------------------------------------------------------------

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
                     T* __restrict__ o, float* __restrict__ lse, int H, int K, int S, Strides st,
                     int causal, int window, float scale) {
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
    if (lse != nullptr && quad == 0)
      lse[((long long)b * H + h) * S + qpos] = m + logf(fmaxf(l, 1e-30f));
  }
}

template <int HD>
int launch_fma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int K, int S, const Strides& st, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static int smem_set[rt::kMaxDevices];
  const cudaError_t attr = rt::max_dynamic_smem(
      reinterpret_cast<const void*>(flash_fwd_kernel<float, HD>), (int)smem, smem_set);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<float, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, H, K, S, st, causal, window, scale);
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

// The tensor maps view q, k and v as 4-d (hd, S, heads, B) bf16 tensors
// with boxes of (64 columns, rows, 1, 1) in the 128-byte swizzle: each box
// lands as one 64-column block of swizzled 128-byte rows, the layout the
// wgmma descriptors name. Rows past S and columns past hd are zero-filled.
template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int B, int H, int K, int S, long long ob,
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
  const int n_kt = (S + TC_BK - 1) / TC_BK;
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
      const bool masked = (k0 + TC_BK > S) || (causal && k0 + TC_BK - 1 > qw0) ||
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
            bool ok = kp < S;
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
              int K, int S, const Strides& st, int causal, int window, float scale,
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
      !encode_map(&tk, k, HD, S, K, B, st.kb, st.kh, st.ks, TC_BK) ||
      !encode_map(&tv, v, HD, S, K, B, st.vb, st.vh, st.vs, TC_BK))
    return (int)cudaErrorInvalidValue;
  flash_tc_kernel<HD><<<(unsigned)blocks, TC_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, B, H, K, S, st.ob, st.oh, st.os, causal,
      window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const void*, const void*, const void*, void*, float*, int, int, int,
                         int, const Strides&, int, int, float, cudaStream_t);

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

// strides: 12 element strides, (batch, head, seq) for q, k, v and o in that
// order; the head_dim axis of every tensor has stride 1. bfloat16 also
// needs 16-byte aligned q, k, v and every q/k/v stride a multiple of 8
// elements (the tensor maps' rule); the Python wrapper checks both.
//
// lse: (B, H, S) float32, each row's log-sum-exp of its scaled, masked
// scores (the backward's input), or null when the caller does not ask.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int B, int H, int K, int S, int hd,
                                  const long long* strides, int causal, int window, float scale,
                                  int dtype, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || S <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const LaunchFn fn = pick(dtype, hd);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],  strides[5],
             strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  return fn(q, k, v, o, static_cast<float*>(lse), B, H, K, S, st, causal, window, scale,
            static_cast<cudaStream_t>(stream));
}
