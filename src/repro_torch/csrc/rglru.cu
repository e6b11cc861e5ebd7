// RG-LRU linear recurrence (RecurrentGemma / Griffin), per channel:
//   h_t = exp(log_a_t) * h_{t-1} + m_t,   h_{-1} = h0,
// float32 in and out; returns every h_t and the final h.
//
// Replaces: src/repro/kernels/rglru.py::rglru_scan (pallas_call at :59,
// body _rglru_kernel at :22).
//
// Bound on the H100: memory. log_a and m are read once and h_seq written
// once (12 bytes per (b, t, channel)): at the serve shape (B=4, S=2048,
// W=4096) ~403 MB, ~120 us at 3.35 TB/s; the arithmetic is 3 flops per
// element.
//
// Design: one thread per (b, channel), consecutive threads on consecutive
// channels, so every load and store of a warp is one coalesced 128-byte
// line. Each thread carries h in a register through a loop over the S
// tokens (the TPU's sequential chunk grid axis), unrolled so that the
// loads of later tokens are in flight while the chain of FMAs runs. Only
// exp of log_a <= 0 is taken, so nothing overflows at any length. At the
// serve shape that is 16,384 threads, too few to hide memory latency on
// 132 SMs; a two-pass chunked scan (chunk carries, then a fix-up) is
// later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    rglru_kernel(const float* __restrict__ log_a, const float* __restrict__ m,
                 const float* __restrict__ h0, float* __restrict__ h_seq,
                 float* __restrict__ h_final, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const long long b = blockIdx.y;
  if (w >= W) return;
  const long long row = (long long)W;
  const long long base = b * S * row + w;
  float h = h0[b * row + w];
#pragma unroll 8
  for (int t = 0; t < S; ++t) {
    const long long o = base + t * row;
    h = expf(log_a[o]) * h + m[o];
    h_seq[o] = h;
  }
  h_final[b * row + w] = h;
}

}  // namespace

// log_a, m, h_seq: (B, S, W); h0, h_final: (B, W); all contiguous float32.
extern "C" int rt_rglru(const void* log_a, const void* m, const void* h0, void* h_seq,
                        void* h_final, int B, int S, int W, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((W + THREADS - 1) / THREADS), (unsigned)B);
  rglru_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(m),
      static_cast<const float*>(h0), static_cast<float*>(h_seq), static_cast<float*>(h_final), S,
      W);
  return (int)cudaGetLastError();
}
