// Flash decode: one query token per row against a ring-buffer KV cache.
// A cache slot is valid iff kpos >= 0 && kpos <= pos (&& kpos > pos - window
// when window > 0), as in the model's cache semantics.
//
// Replaces: src/repro/kernels/decode_attention.py::flash_decode
// (pallas_call at :77, body _decode_kernel at :23).
//
// Bound on the H100: bytes and latency. Each valid cache row of K and V is
// read once for all g = H/K query heads of its KV head, so the kernel does
// about g operations per byte (8 for gemma-2b, 16 for recurrentgemma-9b),
// far below the ~295 at which the tensor cores would be the limit. At the
// serve shapes the valid bytes are 2.2 MB (gemma-2b) and 8.4 MB
// (recurrentgemma-9b), under 3 us at 3.35 TB/s, so what a call costs is how
// soon all of them are in flight, the chain of dependent steps inside a
// block, and the tail that combines the blocks' partials. The products
// still run on the tensor cores for bf16 (mma.m16n8k16): on the CUDA cores
// their instruction stream (unpacking bf16, FMAs, shuffles) was the longest
// step of a block at g = 16. float32 stays on the CUDA cores, exact to ~1e-7.
// The bf16 products keep float32 precision: q and K are bf16 already, so
// their products are exact in the float32 accumulator, and P is split into
// a bf16 high part and a bf16 low part (P - hi) that make two P·V products,
// so P carries ~16 significant bits into P·V, as near float32 as the
// reference's float32 P needs.
//
// Design: one launch. The grid is (splits, B * K): the cache axis is cut
// into chunks of `chunk` slots, as many as give every SM a block where S
// allows (the wrapper's rule), padded with empty blocks to a multiple of
// the cluster size. A block
//   1. reads its chunk's kpos once and compacts the valid slots into a list
//      (a chunk with none copies nothing);
//   2. issues 16-byte cp.async copies of those K rows, then of the V rows,
//      into shared memory as two commit groups (one bf16 hd-256 row is one
//      warp instruction), and stages q, whose loads went out before kpos's,
//      while they are in flight;
//   3. computes the (slot, head) scores once K has landed: bf16 as
//      K . q^T on the tensor cores, one warp per 16-slot x 8-head tile
//      (rows past the valid ones are zero-filled by the copies); float32
//      on the CUDA cores, a thread per (slot, head); then the per-head
//      chunk max and sum;
//   4. once V has landed, P·V: bf16 on the tensor cores, P as its bf16
//      high and low parts, one warp per 8 columns; float32 with a thread
//      per (run of 8 columns, head).
//      The chunk's partial (max, sum, unnormalised accumulator) stays in
//      shared memory.
// Blocks come in clusters of CLUSTER consecutive chunks (Hopper thread
// block clusters). Combining every chunk in one block would read the
// float32 partials of a whole row through one SM (278 KB for gemma-2b), so
//   5. each block of a cluster combines its slice of the (head, 8-column)
//      runs across the cluster's chunks through distributed shared memory,
//      in rank order, and writes the cluster's partial of that slice to
//      scratch: the accumulator of each item, and the (max, sum) of each
//      head the slice touches, stored per rank (a slice holds whole heads
//      only when g is a multiple of 8, so each rank keeps its own copy);
//   6. one thread releases the slice and takes a ticket on the counter of
//      its (row, rank); the block that takes the last ticket combines the
//      slice across the row's clusters in cluster order (so the result does
//      not depend on which cluster finished last), writes the output and
//      resets the counter to 0 for the next call on the stream. The last
//      combine is spread over a cluster's blocks and needs no cluster-wide
//      barrier after the ticket: it reads only what blocks of its own rank
//      wrote, which the ticket orders. The counters and scratch belong to
//      one stream (the wrapper keeps a set per device and stream).
// A row with no valid slot at all gives the mean of V over all S slots, as
// the Pallas kernel and the plain version do (exp(NEG_INF - NEG_INF) = 1).
// The cache is read through element strides in the model's own (B, W, n,
// hd) layout (passed as a (B, K, S, hd) view): decode copies and transposes
// nothing. The 16-byte loads need q, k and v with 16-byte aligned bases and
// strides (the wrapper checks).
#include "common.cuh"

#include <cooperative_groups.h>
#include <math.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

using rt::cp_async16;
using rt::cp_async_commit;
using rt::cp_async_wait;

constexpr int THREADS = 256;
constexpr int CLUSTER = 8;     // chunks per thread block cluster
constexpr int MAX_CHUNK = 64;  // two ballots compact a chunk's valid slots
constexpr int MAXG = 16;       // query heads per KV head

static_assert(MAX_CHUNK == 64, "the valid-slot compaction uses two warp ballots");

struct Strides {
  long long qb, qh, kb, kh, ks, vb, vh, vs, pb, ps, ob, oh;
};

// 8 consecutive floats from 16-byte aligned memory
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// float32 scores of the chunk's valid slots into sp[g][sps]: one thread per
// (slot, head), a dot product from shared memory with eight partial sums.
template <int HD>
__device__ __forceinline__ void score_slots(const unsigned char* sk, const float* sq, float* sp,
                                            int g, int sps, int nvalid, float scale) {
  constexpr int ROWB = HD * 4 + 16;
  for (int it = threadIdx.x; it < nvalid * g; it += THREADS) {
    const int i = it % nvalid, j = it / nvalid;
    const float* krow = reinterpret_cast<const float*>(sk + i * ROWB);
    float d[8] = {};
#pragma unroll 4
    for (int c8 = 0; c8 < HD / 8; ++c8) {
      float kx[8], qx[8];
      load8(krow + c8 * 8, kx);
      load8(sq + j * HD + c8 * 8, qx);
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = fmaf(kx[e], qx[e], d[e]);
    }
    sp[j * sps + i] = (((d[0] + d[1]) + (d[2] + d[3])) + ((d[4] + d[5]) + (d[6] + d[7]))) * scale;
  }
}

// float32 P·V into sacc[g][HD]: one thread per (8-column run, head) over the
// chunk's valid slots, with the weights in sp[g][sps].
template <int HD>
__device__ __forceinline__ void weigh_values(const unsigned char* sv, const float* sp,
                                             float* sacc, int g, int sps, int nvalid) {
  constexpr int ROWB = HD * 4 + 16;
  constexpr int NCG = HD / 8;
  for (int it = threadIdx.x; it < NCG * g; it += THREADS) {
    const int c8 = it % NCG, j = it / NCG;
    float acc[8] = {};
#pragma unroll 4
    for (int i = 0; i < nvalid; ++i) {
      float vx[8];
      load8(reinterpret_cast<const float*>(sv + i * ROWB) + c8 * 8, vx);
      const float w = sp[j * sps + i];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(w, vx[e], acc[e]);
    }
    float4* dst = reinterpret_cast<float4*>(sacc + j * HD + c8 * 8);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

// d += a (16x16 bf16, row) . b (16x8 bf16, col), float32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// p as two packed bf16 pairs: hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split_bf16(float2 p, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p.x, p.y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(p.x - hf.x, p.y - hf.y);
}

// bf16 scores on the tensor cores into sp[g][sps]: one warp per (16-slot,
// 8-head) tile, S^T = K . q^T over HD/16 steps of mma.m16n8k16. K's rows
// past nvalid are zero-filled, q's heads past g repeat the last (unused).
template <int HD>
__device__ __forceinline__ void score_slots_mma(const unsigned char* sk,
                                                const __nv_bfloat16* sqb, float* sp, int g,
                                                int sps, int nvalid, float scale) {
  constexpr int ROWB = HD * 2 + 16;
  constexpr int QS = HD + 8;  // q's shared row, elements
  constexpr int NWARPS = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mtiles = (nvalid + 15) / 16, ntiles = (g + 7) / 8;
  for (int t = warp; t < mtiles * ntiles; t += NWARPS) {
    const int m0 = (t % mtiles) * 16, n0 = (t / mtiles) * 8;
    const unsigned char* ka = sk + (m0 + gid) * ROWB + tig * 4;
    const __nv_bfloat16* qb = sqb + min(n0 + gid, g - 1) * QS + tig * 2;
    float cc[2][4] = {};  // even and odd k-steps: two independent chains
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const unsigned a0 = *reinterpret_cast<const unsigned*>(ka + ks * 32);
      const unsigned a1 = *reinterpret_cast<const unsigned*>(ka + 8 * ROWB + ks * 32);
      const unsigned a2 = *reinterpret_cast<const unsigned*>(ka + ks * 32 + 16);
      const unsigned a3 = *reinterpret_cast<const unsigned*>(ka + 8 * ROWB + ks * 32 + 16);
      const unsigned b0 = *reinterpret_cast<const unsigned*>(qb + ks * 16);
      const unsigned b1 = *reinterpret_cast<const unsigned*>(qb + ks * 16 + 8);
      mma_bf16(cc[ks & 1], a0, a1, a2, a3, b0, b1);
    }
    const float c[4] = {cc[0][0] + cc[1][0], cc[0][1] + cc[1][1], cc[0][2] + cc[1][2],
                        cc[0][3] + cc[1][3]};
    // c[0], c[1]: slot m0 + gid, heads h and h + 1; c[2], c[3]: slot m0 + gid + 8
    const int h = n0 + tig * 2;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int slot = m0 + gid + (u >> 1) * 8, head = h + (u & 1);
      if (slot < nvalid && head < g) sp[head * sps + slot] = c[u] * scale;
    }
  }
}

// bf16 P·V on the tensor cores into sacc[g][HD]: one warp per 8-column tile,
// O = P_hi . V + P_lo . V over the slots in steps of 16, with P (zero past
// nvalid and for heads past g) split into its bf16 high part and the bf16
// rounding of the rest, and V's columns read transposed by ldmatrix.
template <int HD>
__device__ __forceinline__ void weigh_values_mma(const unsigned char* sv, const float* sp,
                                                 float* sacc, int g, int sps, int nvalid) {
  constexpr int ROWB = HD * 2 + 16;
  constexpr int NWARPS = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int ksteps = (nvalid + 15) / 16;
  const int h0 = gid, h1 = gid + 8;  // g <= MAXG = 16: one 16-row tile of heads
  // P's A fragments (high and low parts), shared by the warp's column tiles
  unsigned ah[MAX_CHUNK / 16][4], al[MAX_CHUNK / 16][4];
#pragma unroll
  for (int ks = 0; ks < MAX_CHUNK / 16; ++ks) {
    const int k0 = ks * 16 + tig * 2;
    const float2 z = make_float2(0.f, 0.f);
    const bool in = ks < ksteps;
    const float2 p00 = in && h0 < g ? *reinterpret_cast<const float2*>(sp + h0 * sps + k0) : z;
    const float2 p10 = in && h1 < g ? *reinterpret_cast<const float2*>(sp + h1 * sps + k0) : z;
    const float2 p01 =
        in && h0 < g ? *reinterpret_cast<const float2*>(sp + h0 * sps + k0 + 8) : z;
    const float2 p11 =
        in && h1 < g ? *reinterpret_cast<const float2*>(sp + h1 * sps + k0 + 8) : z;
    split_bf16(p00, ah[ks][0], al[ks][0]);
    split_bf16(p10, ah[ks][1], al[ks][1]);
    split_bf16(p01, ah[ks][2], al[ks][2]);
    split_bf16(p11, ah[ks][3], al[ks][3]);
  }
  for (int nt = warp; nt < HD / 8; nt += NWARPS) {
    float c[4] = {0.f, 0.f, 0.f, 0.f}, cl[4] = {0.f, 0.f, 0.f, 0.f};  // P_hi . V, P_lo . V
#pragma unroll
    for (int ks = 0; ks < MAX_CHUNK / 16; ++ks) {
      if (ks < ksteps) {
        unsigned b0, b1;
        const unsigned addr = static_cast<unsigned>(
            __cvta_generic_to_shared(sv + (ks * 16 + (lane & 15)) * ROWB + nt * 16));
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                     : "=r"(b0), "=r"(b1) : "r"(addr));
        mma_bf16(c, ah[ks][0], ah[ks][1], ah[ks][2], ah[ks][3], b0, b1);
        mma_bf16(cl, al[ks][0], al[ks][1], al[ks][2], al[ks][3], b0, b1);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) c[u] += cl[u];
    // c[0], c[1]: head gid, columns d and d + 1; c[2], c[3]: head gid + 8
    const int d = nt * 8 + tig * 2;
    if (h0 < g) *reinterpret_cast<float2*>(sacc + h0 * HD + d) = make_float2(c[0], c[1]);
    if (h1 < g) *reinterpret_cast<float2*>(sacc + h1 * HD + d) = make_float2(c[2], c[3]);
  }
}

template <typename T, int HD>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ kpos, T* __restrict__ o, float* __restrict__ scratch,
                  int* __restrict__ counters, int H, int K, int S, int chunk, int pos,
                  int window, float scale, Strides st) {
  constexpr int ROWB = HD * (int)sizeof(T) + 16;  // padded shared row, bytes
  constexpr int PIECES = HD * (int)sizeof(T) / 16;  // 16-byte copies per row
  constexpr int NWARPS = THREADS / 32;
  // q's 16-byte pieces a thread stages, at most
  constexpr int QPT = (MAXG * PIECES + THREADS - 1) / THREADS;
  const cg::cluster_group cluster = cg::this_cluster();
  const int g = H / K;
  const int row = blockIdx.y;  // b * K + kv head
  const int b = row / K;
  const int kvh = row % K;
  const int s0 = blockIdx.x * chunk;
  const int n = min(chunk, S - s0);  // <= 0 for a padding block
  const int rank = (int)cluster.block_rank();
  const int n_clusters = gridDim.x / CLUSTER;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;  // bf16: tensor cores
  const int cp = (chunk + 15) / 16 * 16;  // rows staged: whole 16-slot tiles
  const int sps = cp + 8;  // score row stride: rows 8 banks apart for the P loads

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sk = smem;                                       // cp x ROWB
  unsigned char* sv = sk + (size_t)cp * ROWB;                     // cp x ROWB
  float* sacc = reinterpret_cast<float*>(sv + (size_t)cp * ROWB);  // g x HD accumulator
  float* sq = sacc + g * HD;  // g x HD float query (bf16: g x (HD + 8) bf16)
  float* sp = sq + g * HD;    // g x sps scores, then weights
  __shared__ int slist[MAX_CHUNK];
  __shared__ unsigned sball[2];
  __shared__ float sm[MAXG], sl[MAXG];  // the chunk's max and sum per head
  __shared__ int s_last;

  // q's 16-byte loads go out first: they do not wait for the chunk's validity
  const T* qrow = q + b * st.qb + (long long)(kvh * g) * st.qh;
  uint4 qv[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int i = tid + u * THREADS;  // piece i % PIECES of head i / PIECES
    if (i < g * PIECES)
      qv[u] = reinterpret_cast<const uint4*>(qrow + (i / PIECES) * st.qh)[i % PIECES];
  }

  // 1. the chunk's valid slots, compacted in slot order
  bool ok = false;
  unsigned bal = 0;
  if (warp < 2) {
    const int c = warp * 32 + lane;
    if (c < n) {
      const int kp = kpos[b * st.pb + (long long)(s0 + c) * st.ps];
      ok = kp >= 0 && kp <= pos && (window <= 0 || kp > pos - window);
    }
    bal = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) sball[warp] = bal;
  }
  __syncthreads();
  const int nv0 = __popc(sball[0]);
  const int nvalid = nv0 + __popc(sball[1]);
  if (ok) slist[(warp ? nv0 : 0) + __popc(bal & ((1u << lane) - 1u))] = warp * 32 + lane;

  if (nvalid == 0) {  // nothing to read: an empty partial (sum 0)
    if (tid < g) {
      sm[tid] = rt::kNegInit;
      sl[tid] = 0.f;
    }
  } else {
    __syncthreads();  // slist

    // 2. all of the chunk's valid K rows, then its V rows, in flight at once
    const char* kbase = reinterpret_cast<const char*>(k + b * st.kb + kvh * st.kh);
    const char* vbase = reinterpret_cast<const char*>(v + b * st.vb + kvh * st.vh);
    const long long ksb = st.ks * (long long)sizeof(T), vsb = st.vs * (long long)sizeof(T);
    // (rows up to the 16-slot tile's end are zero-filled for the tensor cores)
    const int rows = (nvalid + 15) / 16 * 16;
    for (int i = tid; i < rows * PIECES; i += THREADS) {
      const int r = i / PIECES, p = i % PIECES;
      const int src = r < nvalid ? (s0 + slist[r]) : 0;
      cp_async16(sk + r * ROWB + p * 16, kbase + src * ksb + p * 16, r < nvalid ? 16 : 0);
    }
    cp_async_commit();
    for (int i = tid; i < rows * PIECES; i += THREADS) {
      const int r = i / PIECES, p = i % PIECES;
      const int src = r < nvalid ? (s0 + slist[r]) : 0;
      cp_async16(sv + r * ROWB + p * 16, vbase + src * vsb + p * 16, r < nvalid ? 16 : 0);
    }
    cp_async_commit();
    constexpr int QS = kMma ? HD + 8 : HD;  // q's shared row, elements
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      const int i = tid + u * THREADS;
      if (i < g * PIECES)
        *reinterpret_cast<uint4*>(reinterpret_cast<T*>(sq) + (i / PIECES) * QS +
                                  (i % PIECES) * (16 / (int)sizeof(T))) = qv[u];
    }
    cp_async_wait<1>();  // K has landed; V may still be arriving
    __syncthreads();

    // 3. scores, then the per-head chunk max and weights (one warp per head)
    if constexpr (kMma)
      score_slots_mma<HD>(sk, reinterpret_cast<const T*>(sq), sp, g, sps, nvalid, scale);
    else
      score_slots<HD>(sk, sq, sp, g, sps, nvalid, scale);
    __syncthreads();
    for (int j = warp; j < g; j += NWARPS) {
      float mx = rt::kNegInit;
      for (int i = lane; i < nvalid; i += 32) mx = fmaxf(mx, sp[j * sps + i]);
      mx = rt::warp_max(mx);
      float sum = 0.f;
      for (int i = lane; i < rows; i += 32) {  // weight 0 past nvalid, for the tensor cores
        const float w = i < nvalid ? expf(sp[j * sps + i] - mx) : 0.f;
        sp[j * sps + i] = w;
        sum += w;
      }
      sum = rt::warp_sum(sum);
      if (lane == 0) {
        sm[j] = mx;
        sl[j] = sum;
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // 4. P·V: the chunk's unnormalised accumulator stays in shared memory
    if constexpr (kMma)
      weigh_values_mma<HD>(sv, sp, sacc, g, sps, nvalid);
    else
      weigh_values<HD>(sv, sp, sacc, g, sps, nvalid);
  }

  // 5. the cluster's partial: each block combines its slice of the
  // (head, column pair) items across the cluster's chunks, in rank order,
  // through distributed shared memory
  cluster.sync();
  constexpr int NPAIR = HD / 2;
  const int n_items = g * NPAIR;
  const int per = (n_items + CLUSTER - 1) / CLUSTER;
  const int it0 = rank * per, it1 = min(n_items, it0 + per);
  const int cl = blockIdx.x / CLUSTER;
  float* part_acc = scratch;  // [rows][n_clusters][g][HD]
  // [rows][n_clusters][CLUSTER ranks][g]: each rank's own copy of a head's
  // (max, sum), so that its last block reads only what its rank wrote
  float2* part_ml = reinterpret_cast<float2*>(scratch + (size_t)gridDim.y * n_clusters * g * HD);
  for (int it = it0 + tid; it < it1; it += THREADS) {
    const int j = it / NPAIR, d = it % NPAIR * 2;
    float mr[CLUSTER], lr[CLUSTER];
    float2 x[CLUSTER];
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) {  // every load issued before any is used
      mr[r] = *cluster.map_shared_rank(sm + j, r);
      lr[r] = *cluster.map_shared_rank(sl + j, r);
      x[r] = *cluster.map_shared_rank(reinterpret_cast<const float2*>(sacc + j * HD + d), r);
    }
    float M = rt::kNegInit;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) M = lr[r] > 0.f ? fmaxf(M, mr[r]) : M;
    float L = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) {  // an empty chunk left its accumulator unset
      const float w = lr[r] > 0.f ? expf(mr[r] - M) : 0.f;
      L = fmaf(w, lr[r], L);
      a0 = lr[r] > 0.f ? fmaf(w, x[r].x, a0) : a0;
      a1 = lr[r] > 0.f ? fmaf(w, x[r].y, a1) : a1;
    }
    const size_t e = ((size_t)row * n_clusters + cl) * g + j;
    *reinterpret_cast<float2*>(part_acc + e * HD + d) = make_float2(a0, a1);
    if (d == 0 || it == it0)  // the first item of head j in this rank's slice
      part_ml[(((size_t)row * n_clusters + cl) * CLUSTER + rank) * g + j] = make_float2(M, L);
  }
  // done with the other blocks' shared memory: they may exit once all arrive
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // 6. ticket per (row, rank): the block of this rank whose cluster finishes
  // the row last combines the slice across the row's clusters
  __syncthreads();
  int* counter = counters + row * CLUSTER + rank;
  if (tid == 0) {
    int ticket;
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");  // release the slice
    asm volatile("atom.relaxed.gpu.global.add.s32 %0, [%1], %2;\n"
                 : "=r"(ticket) : "l"(counter), "r"(1) : "memory");
    s_last = ticket == n_clusters - 1;
    if (s_last) asm volatile("fence.acq_rel.gpu;\n" ::: "memory");  // acquire the others'
  }
  __syncthreads();
  if (s_last) {
    const size_t rbase = (size_t)row * n_clusters;
    for (int it = it0 + tid; it < it1; it += THREADS) {
      const int j = it / NPAIR, d = it % NPAIR * 2;
      float M = rt::kNegInit, L = 0.f, a0 = 0.f, a1 = 0.f;
      for (int c0 = 0; c0 < n_clusters; c0 += CLUSTER) {  // CLUSTER clusters' loads at once
        float2 ml[CLUSTER], x[CLUSTER];
#pragma unroll
        for (int u = 0; u < CLUSTER; ++u) {
          ml[u] = make_float2(rt::kNegInit, 0.f);
          if (c0 + u < n_clusters) {
            const size_t c = rbase + c0 + u;
            ml[u] = __ldcg(part_ml + (c * CLUSTER + rank) * g + j);
            x[u] = __ldcg(reinterpret_cast<const float2*>(part_acc + (c * g + j) * HD + d));
          }
        }
        float Mb = M;
#pragma unroll
        for (int u = 0; u < CLUSTER; ++u) Mb = ml[u].y > 0.f ? fmaxf(Mb, ml[u].x) : Mb;
        const float r = expf(M - Mb);  // rescale what earlier batches summed
        L *= r;
        a0 *= r;
        a1 *= r;
#pragma unroll
        for (int u = 0; u < CLUSTER; ++u) {
          if (ml[u].y > 0.f) {  // an empty cluster adds nothing
            const float w = expf(ml[u].x - Mb);
            L = fmaf(w, ml[u].y, L);
            a0 = fmaf(w, x[u].x, a0);
            a1 = fmaf(w, x[u].y, a1);
          }
        }
        M = Mb;
      }
      float inv = 1.f / L;
      if (!(L > 0.f)) {  // no valid slot in the row: the mean of V over all S slots
        const T* vcol = v + b * st.vb + kvh * st.vh + d;
        for (int s = 0; s < S; ++s) {
          a0 += rt::to_f(vcol[(long long)s * st.vs]);
          a1 += rt::to_f(vcol[(long long)s * st.vs + 1]);
        }
        inv = 1.f / (float)S;
      }
      T* out = o + b * st.ob + (long long)(kvh * g + j) * st.oh + d;
      out[0] = rt::from_f<T>(a0 * inv);
      out[1] = rt::from_f<T>(a1 * inv);
    }
    if (tid == 0) *counter = 0;  // ready for the next call on this stream
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* kpos, void* o,
           void* scratch, void* counters, int B, int H, int K, int S, int chunk,
           const Strides& st, int pos, int window, float scale, cudaStream_t stream) {
  constexpr size_t ROWB = HD * sizeof(T) + 16;
  const int g = H / K;
  const int cp = (chunk + 15) / 16 * 16;  // as the kernel lays it out
  const size_t smem = 2 * cp * ROWB + sizeof(float) * (size_t)g * (2 * HD + cp + 8);
  static int smem_set[rt::kMaxDevices];
  const cudaError_t attr = rt::max_dynamic_smem(
      reinterpret_cast<const void*>(decode_kernel<T, HD>),
      (int)(2 * MAX_CHUNK * ROWB + sizeof(float) * MAXG * (2 * HD + MAX_CHUNK + 8)), smem_set);
  if (attr != cudaSuccess) return (int)attr;
  const int chunks = (S + chunk - 1) / chunk;
  const dim3 grid((chunks + CLUSTER - 1) / CLUSTER * CLUSTER, B * K);
  decode_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kpos), static_cast<T*>(o), static_cast<float*>(scratch),
      static_cast<int*>(counters), H, K, S, chunk, pos, window, scale, st);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* kpos, void* o,
                void* scratch, void* counters, int B, int H, int K, int S, int chunk,
                const Strides& st, int pos, int window, float scale, cudaStream_t s) {
#define RT_DECODE(HD_)                                                                         \
  case HD_:                                                                                    \
    return launch<T, HD_>(q, k, v, kpos, o, scratch, counters, B, H, K, S, chunk, st, pos,    \
                          window, scale, s);
  switch (hd) {
    RT_DECODE(16)
    RT_DECODE(32)
    RT_DECODE(64)
    RT_DECODE(96)
    RT_DECODE(112)
    RT_DECODE(128)
    RT_DECODE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef RT_DECODE
}

}  // namespace

// One launch. The wrapper picks chunk (slots per block, 1..64) and passes
// float32 scratch of B*K * n_clusters * (H/K) * (hd + 16) values, with
// n_clusters = ceil(ceil(S / chunk) / 8), and B*K*8 int32 counters that are
// 0 before the call and are left at 0 after it; both used by no other
// stream while the kernel runs.
// strides: 12 element strides: q (batch, head), k (batch, head, seq),
// v (batch, head, seq), kpos (batch, seq), o (batch, head); the head_dim
// axis of q, k, v and o has stride 1; q, k and v need 16-byte aligned
// bases and strides.
extern "C" int rt_flash_decode(const void* q, const void* k, const void* v, const void* kpos,
                               void* o, void* scratch, void* counters, int B, int H, int K,
                               int S, int hd, int chunk, const long long* strides, int pos,
                               int window, float scale, int dtype, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || H / K > MAXG || S <= 0 || chunk <= 0 ||
      chunk > MAX_CHUNK || (long long)B * K > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],  strides[5],
             strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return dispatch_hd<float>(hd, q, k, v, kpos, o, scratch, counters, B, H, K, S, chunk, st,
                              pos, window, scale, s);
  if (dtype == rt::kBF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, kpos, o, scratch, counters, B, H, K, S,
                                      chunk, st, pos, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
