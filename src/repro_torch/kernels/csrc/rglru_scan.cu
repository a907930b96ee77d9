// K8: the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, seeded by h0.
//
// Replaces the TPU kernel repro/kernels/rglru/rglru.py::rglru_pallas
// (pallas_call at rglru.py:58).  a and b are (B, S, R) float32, h0 is
// (B, R) float32, all contiguous; the kernel writes every h (B, S, R) and
// h_last (B, R), float32.  h0 enters at step 0 as h_0 = a_0 * h0 + b_0,
// which is the reference's fold of h0 into its first element.
//
// What bounds it on the H100: bytes -- a and b read once, h written once
// (12 bytes per element), one multiply-add per element.  But a sequential
// walk of one channel is a chain of dependent multiply-adds, and one
// thread per (b, r) channel gives only B * R threads (16,384 at
// recurrentgemma-9b's batch 4), so a long sequence is bound by latency,
// not by the memory's rate.  Design, simple first: one thread per
// channel walks t in order, neighbouring threads on neighbouring r (every
// load and store is coalesced along r); the loads of a and b do not
// depend on h, so UNROLL steps of them are issued ahead of the chain of
// multiply-adds.  The TPU kernel's log-depth scan inside a chunk sums in
// another order; a chunk-parallel scan is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 16;

__global__ void __launch_bounds__(THREADS)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ out,
                      float* __restrict__ h_last, int B, int S, int R) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)B * R) return;
  const int bi = (int)(idx / R), r = (int)(idx % R);
  const size_t base = (size_t)bi * S * R + r;
  float h = h0[idx];
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = a[base + (size_t)(t + u) * R];
      bv[u] = b[base + (size_t)(t + u) * R];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = fmaf(av[u], h, bv[u]);
      out[base + (size_t)(t + u) * R] = h;
    }
  }
  for (; t < S; ++t) {
    h = fmaf(a[base + (size_t)t * R], h, b[base + (size_t)t * R]);
    out[base + (size_t)t * R] = h;
  }
  h_last[idx] = h;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  All pointers are
// device pointers to float32; the launch goes on `stream` and does not
// synchronise.
extern "C" int launch_rglru_scan(const void* a, const void* b, const void* h0,
                                 void* out, void* h_last, int B, int S, int R,
                                 void* stream) {
  if (B <= 0 || S <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * R;
  const int blocks = (int)((n + THREADS - 1) / THREADS);
  rglru_scan_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)h0, (float*)out,
      (float*)h_last, B, S, R);
  return (int)cudaGetLastError();
}
