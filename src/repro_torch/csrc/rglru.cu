// RG-LRU linear recurrence (RecurrentGemma / Griffin), per channel:
//   h_t = exp(log_a_t) * h_{t-1} + m_t,   h_{-1} = h0,
// over log_a and m in float32 or bfloat16 (the same type for both) and a
// float32 h0; returns every h_t and the final h in float32.
//
// Replaces: src/repro/kernels/rglru.py::rglru_scan (pallas_call at :59,
// body _rglru_kernel at :22).
//
// Bound on the H100: memory. log_a and m are read once and h_seq written
// once: 12 bytes per (b, t, channel) in float32, 8 with bfloat16 inputs.
// At the serve shape (B=4, S=2048, W=4096) that is ~403 MB, ~120 us at
// 3.35 TB/s (bf16 inputs: ~268 MB, ~80 us); the arithmetic is 3 flops per
// element. Reaching the memory rate takes ~38 KB of loads in flight per
// SM (3.35 TB/s / 132 SMs x ~1.5 us of latency).
//
// Design: bytes in flight come from an asynchronous-copy ring, not from
// threads. A block is one warp and owns a slab of SLAB = 32 consecutive
// channels of one batch row for the whole sequence: lane c carries h of
// channel w0 + c in a register through the tokens, in token order, one
// FMA (a * h + m) per token, as the sequential oracle
// (src/repro/kernels/ref.py::rglru_ref). The same warp keeps a ring of
// STAGES tiles of log_a and m in shared memory filled with cp.async: a
// tile is 128 bytes' worth of tokens (32 in float32, 64 in bf16) x the
// slab's 32 channels, 4 KB per array. Before it consumes tile i, the warp
// starts the copies of tile i + STAGES - 1, so two tiles (16 KB) per
// block are in flight while it computes; the shared loads and exps of 8
// tokens go out before their chain of FMAs. At the serve shape that is
// B * W / 32 = 512 blocks of 24 KB: 4 per SM, every block resident in one
// wave (~64 KB in flight per SM). The h_seq stores are one 128-byte line
// per warp and token, streaming (st.global.cs): the kernel never reads
// them back. One launch per call; no block waits for another, and no
// counter or scratch outlives the call. (Measured on the H100 while the
// design was tuned: a grid in two waves was slower by about the second
// wave; 256-byte tiles were slower, and with 128-byte tiles so were plain
// stores.)
//
// Copies: where every token row of log_a and m starts 16-byte aligned
// (W * elem a multiple of 16 and 16-byte aligned bases, which the wrapper
// checks) a row of the slab is 8 (float32) or 4 (bf16) 16-byte copies
// (VEC = 16). Otherwise VEC = 4: 4-byte copies (cp.async has no 2-byte
// copy), of one float32 or two bf16 elements; a bf16 row that starts on
// an odd element is copied from the element before, and read at offset 1.
// The copy that holds the slab's last element reads only the slab's
// bytes (cp.async's source size; the rest of the 4 bytes is zero-filled),
// so no copy reads past the tensor. S need not be a multiple of the tile
// (the last tile is short) and W not a multiple of 32 (the last slab is
// partial: its lanes past W read stale shared memory and store nothing).
// Only exp of log_a itself is taken, never of a sum, so nothing overflows
// at any length.
#include "common.cuh"

namespace {

constexpr int SLAB = 32;        // channels per block: one warp, a channel per lane
constexpr int STAGES = 3;       // tiles in the ring: STAGES - 1 in flight
constexpr int ROW_BYTES = 128;  // bytes of one channel's tokens in a tile
constexpr int UNROLL = 8;       // tokens whose loads go out before their FMAs

template <typename T, int VEC>
struct Plan {
  static constexpr int E = VEC / (int)sizeof(T);  // elements per copy
  // elements per shared row: the slab, plus room for a row read from the
  // element before (bf16, VEC = 4), rounded to whole copies
  static constexpr int PITCH = (SLAB + (VEC == 16 ? 0 : E - 1) + E - 1) / E * E;
  static constexpr int NCH = PITCH / E;  // copies per token row
  static constexpr int TT = ROW_BYTES / (int)sizeof(T);  // tokens per tile
  static constexpr int TILE = TT * PITCH;  // elements of one array's tile
  static constexpr int SMEM = STAGES * 2 * TILE * (int)sizeof(T);
  static_assert(VEC == 16 || VEC == 4, "16- or 4-byte copies");
  static_assert(VEC != 16 || PITCH == SLAB, "16-byte copies take aligned rows only");
  static_assert(SMEM <= 48 * 1024, "the ring fits the default dynamic shared memory limit");
};

// A copy of VEC bytes of which src_bytes are read (the rest zero-filled)
template <int VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Offset of the token row that starts at element g from its first copy:
// 0 where every row is aligned to whole copies (VEC = 16, the wrapper's
// rule, or one element a copy), else g's parity (bf16, VEC = 4)
template <typename T, int VEC>
__device__ __forceinline__ int row_offset(long long g) {
  if constexpr (VEC == 16 || Plan<T, VEC>::E == 1)
    return 0;
  else
    return (int)(g & (Plan<T, VEC>::E - 1));
}

// Starts the copies of n token rows of the slab, the first at element g0,
// from each of the NA arrays src[k] into its tile dst[k] (rows PITCH
// elements apart): the arrays share every copy's offsets.
template <typename T, int VEC, int NA>
__device__ __forceinline__ void fetch_rows(T* const (&dst)[NA], const T* const (&src)[NA],
                                           long long g0, int n, int W, int nvalid, int lane) {
  using P = Plan<T, VEC>;
  for (int i = lane; i < n * P::NCH; i += 32) {
    const int r = i / P::NCH, j = i % P::NCH;
    const long long g = g0 + (long long)r * W;
    const long long c0 = g - row_offset<T, VEC>(g) + j * P::E;
    const long long left = g + nvalid - c0;  // slab elements from c0 on
    if (left <= 0) continue;
    const int bytes = left >= P::E ? VEC : (int)left * (int)sizeof(T);
#pragma unroll
    for (int k = 0; k < NA; ++k) cp_async<VEC>(dst[k] + r * P::PITCH + j * P::E, src[k] + c0, bytes);
  }
}

// Tokens r .. r + U - 1 of a tile whose first token row starts at element
// g: the shared loads and exps of all U first, then the chain of FMAs and
// the streaming stores (whose asm orders every memory access after it).
template <typename T, int VEC, int U>
__device__ __forceinline__ void consume(const T* sa, const T* sm, int r, long long g, int W,
                                        int lane, int nvalid, float& h,
                                        float* __restrict__ h_seq) {
  using P = Plan<T, VEC>;
  float a[U], x[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int o = (r + u) * P::PITCH + row_offset<T, VEC>(g + (long long)(r + u) * W) + lane;
    a[u] = expf(rt::to_f(sa[o]));
    x[u] = rt::to_f(sm[o]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    h = fmaf(a[u], h, x[u]);
    if (lane < nvalid) __stcs(h_seq + g + (long long)(r + u) * W + lane, h);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(SLAB)
    rglru_kernel(const T* __restrict__ log_a, const T* __restrict__ m,
                 const float* __restrict__ h0, float* __restrict__ h_seq,
                 float* __restrict__ h_final, int S, int W) {
  using P = Plan<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [STAGES][log_a, m][TILE]
  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * SLAB;
  const long long b = blockIdx.y;
  const int nvalid = min(SLAB, W - w0);
  const long long base = b * S * (long long)W + w0;  // element (b, 0, w0)
  const int n_tiles = (S + P::TT - 1) / P::TT;

  auto fetch = [&](int tile) {
    if (tile < n_tiles) {
      T* sa = ring + (tile % STAGES) * 2 * P::TILE;
      const int t0 = tile * P::TT;
      const long long g = base + (long long)t0 * W;
      const int n = min(P::TT, S - t0);
      fetch_rows<T, VEC, 2>({sa, sa + P::TILE}, {log_a, m}, g, n, W, nvalid, lane);
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  float h = lane < nvalid ? h0[b * W + w0 + lane] : 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  for (int tile = 0; tile < n_tiles; ++tile) {
    fetch(tile + STAGES - 1);
    cp_async_wait<STAGES - 1>();  // this lane's copies of `tile` have landed
    __syncwarp();                 // and every other lane's
    const T* sa = ring + (tile % STAGES) * 2 * P::TILE;
    const T* sm = sa + P::TILE;
    const int t0 = tile * P::TT;
    const int n = min(P::TT, S - t0);
    const long long g = base + (long long)t0 * W;
    int r = 0;
    for (; r + UNROLL <= n; r += UNROLL)
      consume<T, VEC, UNROLL>(sa, sm, r, g, W, lane, nvalid, h, h_seq);
    for (; r < n; ++r) consume<T, VEC, 1>(sa, sm, r, g, W, lane, nvalid, h, h_seq);
    __syncwarp();  // the slot is read before the next iteration refills it
  }
  if (lane < nvalid) h_final[b * W + w0 + lane] = h;
}

// Asks for the largest shared memory carveout, once per device, so that
// the SM's L1 split leaves room for every resident block's ring
template <typename T, int VEC>
cudaError_t prepare() {
  static int carveout_set[rt::kMaxDevices];
  return rt::func_attribute(reinterpret_cast<const void*>(rglru_kernel<T, VEC>),
                            cudaFuncAttributePreferredSharedMemoryCarveout,
                            cudaSharedmemCarveoutMaxShared, carveout_set);
}

template <typename T, int VEC>
int launch(const void* log_a, const void* m, const void* h0, void* h_seq, void* h_final, int B,
           int S, int W, cudaStream_t stream) {
  const cudaError_t e = prepare<T, VEC>();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((W + SLAB - 1) / SLAB), (unsigned)B);
  rglru_kernel<T, VEC><<<grid, SLAB, Plan<T, VEC>::SMEM, stream>>>(
      static_cast<const T*>(log_a), static_cast<const T*>(m), static_cast<const float*>(h0),
      static_cast<float*>(h_seq), static_cast<float*>(h_final), S, W);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int blocks_per_sm(int* out) {
  cudaError_t e = prepare<T, VEC>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, rglru_kernel<T, VEC>, SLAB,
                                                      Plan<T, VEC>::SMEM);
  return (int)e;
}

// ---------------------------------------------------------------------------
// Backward. For h_t = a_t h_{t-1} + m_t with a_t = exp(log_a_t) and
// h_{-1} = h0, given dh_seq and dh_final (the gradients of every h_t and of
// the final h):
//   g_{S-1} = dh_seq_{S-1} + dh_final,   g_t = dh_seq_t + a_{t+1} g_{t+1},
//   dm_t = g_t,   dlog_a_t = g_t a_t h_{t-1},   dh0 = a_0 g_0,
// with h_{t-1} read from the forward's h_seq (h0 at t = 0). dlog_a is never
// taken as g_t (h_t - m_t): that difference cancels where the decay is
// strong (a_t h_{t-1} << m_t).
//
// Replaces: no Pallas kernel. The reference's gradient is jax.grad of
// src/repro/models/rglru.py::rglru_scan (an associative scan); this is the
// backward of the forward kernel above, which replaces
// src/repro/kernels/rglru.py::rglru_scan (pallas_call at :59).
//
// Bound on the H100: memory. log_a, h_seq and dh_seq are read once and
// dlog_a and dm written once: 20 bytes per (b, t, channel) in float32. At
// the training shape (B=4, S=512, W=4096) that is ~168 MB, ~50 us at
// 3.35 TB/s (prefill shape, S=2048: ~671 MB, ~200 us); the arithmetic is
// ~5 flops per element.
//
// Design: the forward's, run in reverse token order. A block is one warp
// and owns a slab of SLAB channels of one batch row; lane c carries
// c_t = a_t g_t of its channel in a register from dh_final (so that
// g_t = dh_seq_t + c_{t+1} and dlog_a_t = c_t h_{t-1}: one add and one
// multiply on the chain per token), and writes dh0 = c_0 at the end. A
// ring of STAGES tiles of BWD_TT = 32 tokens (128 bytes of a float32
// channel) is walked from the last tile to the first, each tile the
// slab's rows of log_a, dh_seq and h_seq one token earlier (the rows of
// h_{t-1}); the first tile's row of h_{-1} is h0, written from a register
// (each lane reads only its own channel). Before it consumes a tile the
// warp starts the copies of the tile STAGES - 1 further back, and the
// shared loads and exps of 8 tokens go out before their chain. dlog_a and
// dm are streamed out in log_a's type, one coalesced row per warp and
// token. One launch; no atomics, no scratch, no block waits for another:
// two calls give the same bits. Copies, partial slabs, short tiles and
// unaligned rows are the forward's (Plan, fetch_rows), per array.
constexpr int BWD_TT = 32;  // tokens in a backward tile

template <typename T, int VEC>
struct BwdPlan {
  using A = Plan<T, VEC>;      // log_a's rows
  using F = Plan<float, VEC>;  // the rows of h_seq and dh_seq
  static constexpr int F_TILE = BWD_TT * F::PITCH;  // floats of one float32 tile
  static constexpr int A_TILE = BWD_TT * A::PITCH;  // elements of log_a's tile
  // a stage: the h tile, the dh tile, then log_a's (every tile 16-byte sized)
  static constexpr int STAGE = 2 * F_TILE * 4 + A_TILE * (int)sizeof(T);
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(A_TILE * sizeof(T) % 16 == 0, "tiles stay 16-byte aligned");
  static_assert(SMEM <= 48 * 1024, "the ring fits the default dynamic shared memory limit");
};

__device__ __forceinline__ void store_cs(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store_cs(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16(v)));
}

// Tokens r, r - 1, .., r - U + 1 of a tile whose first token row starts at
// element g: the shared loads and exps of all U first, then the chain.
template <typename T, int VEC, int U>
__device__ __forceinline__ void consume_bwd(const T* sa, const float* sh, const float* sd, int r,
                                            long long g, int W, int lane, int nvalid, float& c,
                                            T* __restrict__ dlog_a, T* __restrict__ dm) {
  using P = BwdPlan<T, VEC>;
  float a[U], hp[U], d[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int rr = r - u;
    a[u] = expf(rt::to_f(
        sa[rr * P::A::PITCH + row_offset<T, VEC>(g + (long long)rr * W) + lane]));
    hp[u] = sh[rr * P::F::PITCH + lane];
    d[u] = sd[rr * P::F::PITCH + lane];
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float gt = d[u] + c;  // g_t
    c = a[u] * gt;              // a_t g_t
    if (lane < nvalid) {
      const long long o = g + (long long)(r - u) * W + lane;
      store_cs(dm + o, gt);
      store_cs(dlog_a + o, c * hp[u]);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(SLAB)
    rglru_bwd_kernel(const T* __restrict__ log_a, const float* __restrict__ h_seq,
                     const float* __restrict__ h0, const float* __restrict__ dh_seq,
                     const float* __restrict__ dh_final, T* __restrict__ dlog_a,
                     T* __restrict__ dm, float* __restrict__ dh0, int S, int W) {
  using P = BwdPlan<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const int w0 = blockIdx.x * SLAB;
  const long long b = blockIdx.y;
  const int nvalid = min(SLAB, W - w0);
  const long long base = b * S * (long long)W + w0;  // element (b, 0, w0)
  const int n_tiles = (S + BWD_TT - 1) / BWD_TT;

  // the i-th tile consumed is tile n_tiles - 1 - i, in slot i % STAGES
  auto slot = [&](int i) { return reinterpret_cast<float*>(smem_raw + (i % STAGES) * P::STAGE); };
  auto fetch = [&](int i) {
    if (i < n_tiles) {
      float* sh = slot(i);
      const int t0 = (n_tiles - 1 - i) * BWD_TT;
      const int n = min(BWD_TT, S - t0);
      const long long g = base + (long long)t0 * W;
      fetch_rows<T, VEC, 1>({reinterpret_cast<T*>(sh + 2 * P::F_TILE)}, {log_a}, g, n, W,
                            nvalid, lane);
      fetch_rows<float, VEC, 1>({sh + P::F_TILE}, {dh_seq}, g, n, W, nvalid, lane);
      // h_{t-1} of the tile's tokens: h_seq's rows t0 - 1 .. t0 + n - 2,
      // but for the first tile's row 0 (h0, written when it is consumed)
      const int skip = t0 == 0;
      fetch_rows<float, VEC, 1>({sh + skip * P::F::PITCH}, {h_seq},
                                g + (long long)(skip - 1) * W, n - skip, W, nvalid, lane);
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  const long long bw = b * W + w0 + lane;
  float c = lane < nvalid ? dh_final[bw] : 0.f;
  const float h_init = lane < nvalid ? h0[bw] : 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  for (int i = 0; i < n_tiles; ++i) {
    fetch(i + STAGES - 1);
    cp_async_wait<STAGES - 1>();  // this lane's copies of tile i have landed
    __syncwarp();                 // and every other lane's
    float* sh = slot(i);
    const float* sd = sh + P::F_TILE;
    const T* sa = reinterpret_cast<const T*>(sh + 2 * P::F_TILE);
    const int t0 = (n_tiles - 1 - i) * BWD_TT;
    const int n = min(BWD_TT, S - t0);
    const long long g = base + (long long)t0 * W;
    if (t0 == 0) sh[lane] = h_init;  // h_{-1}: this lane's channel, read by this lane only
    int r = n - 1;
    for (; r >= UNROLL - 1; r -= UNROLL)
      consume_bwd<T, VEC, UNROLL>(sa, sh, sd, r, g, W, lane, nvalid, c, dlog_a, dm);
    for (; r >= 0; --r) consume_bwd<T, VEC, 1>(sa, sh, sd, r, g, W, lane, nvalid, c, dlog_a, dm);
    __syncwarp();  // the slot is read before the next iteration refills it
  }
  if (lane < nvalid) dh0[bw] = c;
}

template <typename T, int VEC>
int launch_bwd(const void* log_a, const void* h_seq, const void* h0, const void* dh_seq,
               const void* dh_final, void* dlog_a, void* dm, void* dh0, int B, int S, int W,
               cudaStream_t stream) {
  static int carveout_set[rt::kMaxDevices];
  const cudaError_t e = rt::func_attribute(
      reinterpret_cast<const void*>(rglru_bwd_kernel<T, VEC>),
      cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared,
      carveout_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((W + SLAB - 1) / SLAB), (unsigned)B);
  rglru_bwd_kernel<T, VEC><<<grid, SLAB, BwdPlan<T, VEC>::SMEM, stream>>>(
      static_cast<const T*>(log_a), static_cast<const float*>(h_seq),
      static_cast<const float*>(h0), static_cast<const float*>(dh_seq),
      static_cast<const float*>(dh_final), static_cast<T*>(dlog_a), static_cast<T*>(dm),
      static_cast<float*>(dh0), S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// log_a, m, h_seq: (B, S, W); h0, h_final: (B, W); all contiguous. log_a
// and m in `dtype` (rt::kF32 or rt::kBF16); h0, h_seq and h_final float32.
// vec: 16 where W * elem is a multiple of 16 and log_a's and m's bases
// are 16-byte aligned, else 4 (bases 4-byte aligned).
extern "C" int rt_rglru(const void* log_a, const void* m, const void* h0, void* h_seq,
                        void* h_final, int B, int S, int W, int dtype, int vec, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32 && vec == 16)
    return launch<float, 16>(log_a, m, h0, h_seq, h_final, B, S, W, s);
  if (dtype == rt::kF32 && vec == 4)
    return launch<float, 4>(log_a, m, h0, h_seq, h_final, B, S, W, s);
  if (dtype == rt::kBF16 && vec == 16)
    return launch<__nv_bfloat16, 16>(log_a, m, h0, h_seq, h_final, B, S, W, s);
  if (dtype == rt::kBF16 && vec == 4)
    return launch<__nv_bfloat16, 4>(log_a, m, h0, h_seq, h_final, B, S, W, s);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the (dtype, vec) instantiation resident on one SM of the
// current device, into *out: the wave the grid of B * ceil(W / 32) blocks
// has to fit.
extern "C" int rt_rglru_blocks_per_sm(int dtype, int vec, int* out) {
  if (dtype == rt::kF32 && vec == 16) return blocks_per_sm<float, 16>(out);
  if (dtype == rt::kF32 && vec == 4) return blocks_per_sm<float, 4>(out);
  if (dtype == rt::kBF16 && vec == 16) return blocks_per_sm<__nv_bfloat16, 16>(out);
  if (dtype == rt::kBF16 && vec == 4) return blocks_per_sm<__nv_bfloat16, 4>(out);
  return (int)cudaErrorInvalidValue;
}

// The backward: log_a, h_seq (the forward's), dh_seq, dlog_a, dm: (B, S, W);
// h0, dh_final, dh0: (B, W); all contiguous. log_a, dlog_a and dm in
// `dtype`; the rest float32. vec: 16 where W * elem is a multiple of 16 and
// the bases of log_a, h_seq and dh_seq are 16-byte aligned, else 4 (bases
// 4-byte aligned).
extern "C" int rt_rglru_bwd(const void* log_a, const void* h_seq, const void* h0,
                            const void* dh_seq, const void* dh_final, void* dlog_a, void* dm,
                            void* dh0, int B, int S, int W, int dtype, int vec, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32 && vec == 16)
    return launch_bwd<float, 16>(log_a, h_seq, h0, dh_seq, dh_final, dlog_a, dm, dh0, B, S, W, s);
  if (dtype == rt::kF32 && vec == 4)
    return launch_bwd<float, 4>(log_a, h_seq, h0, dh_seq, dh_final, dlog_a, dm, dh0, B, S, W, s);
  if (dtype == rt::kBF16 && vec == 16)
    return launch_bwd<__nv_bfloat16, 16>(log_a, h_seq, h0, dh_seq, dh_final, dlog_a, dm, dh0, B,
                                         S, W, s);
  if (dtype == rt::kBF16 && vec == 4)
    return launch_bwd<__nv_bfloat16, 4>(log_a, h_seq, h0, dh_seq, dh_final, dlog_a, dm, dh0, B,
                                        S, W, s);
  return (int)cudaErrorInvalidValue;
}
