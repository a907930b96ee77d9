// K8: the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, seeded by h0.
//
// Replaces the TPU kernel repro/kernels/rglru/rglru.py::rglru_pallas
// (pallas_call at rglru.py:58).  h0 is (B, R) float32; the kernel writes
// every h (B, S, R) and h_last (B, R), float32, all contiguous.  h0 enters
// at step 0 as h_0 = a_0 * h0 + b_0, which is the reference's fold of h0
// into its first element; h_last equals h at step S - 1 on bits.  h_last
// may be h0 itself (the model's decode writes the new state over the old
// one): a block reads its channels' h0 before it writes any h_last.
//
// Two variants behind one entry point, on one body:
//   VARIANT_SCAN  (the TPU kernel's counterpart): a, b (B, S, R) float32.
//   VARIANT_GATED (the model's RG-LRU, models/rglru.py::_rglru): r, i
//     (B, S, R) float32, y (B, S, R) bf16 or float32, lam (R,) float32; each
//     step's a and b are computed after the loads, one op at a time in the
//     torch code's order: log_a = (-RGLRU_C * softplus(lam)) * r with
//     torch's softplus threshold of 20, a = exp(log_a),
//     b = sqrt(max(1 - exp(2 * log_a), 1e-12)) * (i * float(y)).  That saves
//     the twelve elementwise passes the gate math takes in plain torch.
//
// What bounds it on the H100: bytes -- every input read once and h written
// once (12 bytes per element unfused, 14 fused with bf16 y), one
// multiply-add per element.  A walk of one channel is a chain of dependent
// multiply-adds, so the design has to put enough loads in flight without
// giving up the walk's order.  Chunk-parallel, single pass: a block owns 32
// consecutive channels of one batch row (each step of the block is one
// 128-byte line) and NW warps.  A round covers NW * T steps, T per warp.
// Each lane loads its T steps into registers (all loads issued before any
// multiply-add), and as it turns each step into (a, b) issues the load of
// the same step of the next round into the registers just freed, so a
// round's loads are in flight across the previous round's walks.  It walks
// its T steps from zero to get its local end value and the product of its
// a's.  After one barrier, warp w folds the partials of warps 0..w-1 into
// the carry of the previous round (a chain of w fused multiply-adds over
// shared memory, double-buffered by round parity, so one barrier a round
// suffices), then re-walks its registered T steps from that carry with
// fmaf, in order, and stores h.  The plan (NW, T) is a function of S alone
// (kernels/rglru/rglru.py::scan_chunks, mirrored in plan_for below), never
// of B, R or the card, so a row's bits do not depend on the batch it is
// launched in: the state arena admits at B = 1 and replays against
// generate() at B = 4.  Up to SERIAL_MAX_S steps (the decode step's S = 1)
// one thread walks each channel directly.  NW = 8, T = 8 at 64 registers:
// four blocks per SM, 512 blocks at recurrentgemma-9b's (4, 2560, 4096) in
// one wave.  The gated variant's exp, exp and sqrt per step cost issue
// slots beside the bytes; 16 warps, or 4 steps a warp, were no faster.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;          // channels per block of the chunked walk
constexpr int CHUNK_WARPS = 8;    // NW
constexpr int CHUNK_STEPS = 8;    // T
constexpr int CHUNK_BLOCKS = 4;   // resident blocks per SM (64 registers)
constexpr int SERIAL_MAX_S = 8;
constexpr int SERIAL_THREADS = 256;
// The Griffin paper's fixed recurrence sharpness constant (RGLRU_C of
// kernels/rglru/ref.py).
constexpr float RGLRU_C = 8.f;

struct Args {
  const float* x0;  // a (scan) or r (gated)
  const float* x1;  // b (scan) or i (gated)
  const void* y;    // gated: the RG-LRU input
  const float* lam; // gated: (R,)
  const float* h0;
  float* out;
  float* h_last;
  int S, R;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// log_a's multiplier of r for a channel: -RGLRU_C * softplus(lam), as
// torch's F.softplus (beta 1, threshold 20) followed by a multiply.
__device__ __forceinline__ float gate_coef(float lam) {
  const float sp = lam > 20.f ? lam : log1pf(expf(lam));
  return __fmul_rn(-RGLRU_C, sp);
}

// (a, b) of one step from its raw operands; the _rn intrinsics keep the
// compiler from contracting the gate math into fused multiply-adds.
template <bool GATED>
__device__ __forceinline__ void step_ab(float x0, float x1, float yv,
                                        float coef, float& a, float& b) {
  if constexpr (GATED) {
    const float log_a = __fmul_rn(coef, x0);
    a = expf(log_a);
    float m = __fsub_rn(1.f, expf(__fmul_rn(2.f, log_a)));
    m = m < 1e-12f ? 1e-12f : m;   // clamp_min, NaN passes through
    b = __fmul_rn(sqrtf(m), __fmul_rn(x1, yv));
  } else {
    a = x0;
    b = x1;
  }
}

template <bool GATED, typename Y>
__device__ __forceinline__ void load_step(const Args& p, size_t e, float& x0,
                                          float& x1, Y& yv) {
  x0 = p.x0[e];
  x1 = p.x1[e];
  if constexpr (GATED) yv = static_cast<const Y*>(p.y)[e];
}

// T steps from t0 on of one lane's channel r into registers; none past S.
template <bool GATED, typename Y, int T>
__device__ __forceinline__ void load_round(const Args& p, bool live,
                                           size_t row0, int t0, int r,
                                           float (&x0)[T], float (&x1)[T],
                                           Y (&yv)[T]) {
#pragma unroll
  for (int u = 0; u < T; ++u) {
    if (live && t0 + u < p.S) {
      load_step<GATED, Y>(p, (row0 + t0 + u) * p.R + r, x0[u], x1[u], yv[u]);
    }
  }
}

// Up to SERIAL_MAX_S steps: one thread per (batch, channel), neighbouring
// threads on neighbouring channels.
template <bool GATED, typename Y>
__global__ void __launch_bounds__(SERIAL_THREADS)
    rglru_serial_kernel(const Args p, int BR) {
  const int idx = blockIdx.x * SERIAL_THREADS + threadIdx.x;
  if (idx >= BR) return;
  const int r = idx % p.R;
  const size_t base = (size_t)(idx / p.R) * p.S * p.R + r;
  const float coef = GATED ? gate_coef(p.lam[r]) : 0.f;
  float x0[SERIAL_MAX_S], x1[SERIAL_MAX_S];
  Y yv[SERIAL_MAX_S];
#pragma unroll
  for (int t = 0; t < SERIAL_MAX_S; ++t)
    if (t < p.S) load_step<GATED, Y>(p, base + (size_t)t * p.R, x0[t], x1[t],
                                     yv[t]);
  float h = p.h0[idx];
#pragma unroll
  for (int t = 0; t < SERIAL_MAX_S; ++t) {
    if (t < p.S) {
      float a, b;
      step_ab<GATED>(x0[t], x1[t], GATED ? to_f(yv[t]) : 0.f, coef, a, b);
      h = fmaf(a, h, b);
      p.out[base + (size_t)t * p.R] = h;
    }
  }
  p.h_last[idx] = h;
}

// The chunked walk: grid (ceil(R / 32), B), NW warps of T steps a round.
template <bool GATED, typename Y, int NW, int T>
__global__ void __launch_bounds__(NW * 32, CHUNK_BLOCKS)
    rglru_chunk_kernel(const Args p) {
  __shared__ float part_a[2][NW][LANES], part_b[2][NW][LANES];
  __shared__ float carry[2][LANES];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r = blockIdx.x * LANES + lane;
  const int bi = blockIdx.y;
  const bool live = r < p.R;
  const size_t row0 = (size_t)bi * p.S;  // (bi, t, r) at (row0 + t) * R + r
  const float coef = (GATED && live) ? gate_coef(p.lam[r]) : 0.f;
  if (w == 0) carry[0][lane] = live ? p.h0[(size_t)bi * p.R + r] : 0.f;

  constexpr int ROUND = NW * T;
  const int rounds = (p.S + ROUND - 1) / ROUND;
  float x0[T], x1[T];
  Y yv[T];
  load_round<GATED, Y, T>(p, live, row0, w * T, r, x0, x1, yv);

  float c = 0.f;
  for (int k = 0; k < rounds; ++k) {
    const int t0 = k * ROUND + w * T;
    const bool next = k + 1 < rounds;
    float a[T], b[T];
#pragma unroll
    for (int u = 0; u < T; ++u) {
      if (live && t0 + u < p.S) {
        step_ab<GATED>(x0[u], x1[u], GATED ? to_f(yv[u]) : 0.f, coef, a[u],
                       b[u]);
      } else {             // past S: the identity step
        a[u] = 1.f;
        b[u] = 0.f;
      }
      // the next round's step u streams in across the rest of this round
      const int tn = t0 + ROUND + u;
      if (next && live && tn < p.S) {
        load_step<GATED, Y>(p, (row0 + tn) * p.R + r, x0[u], x1[u], yv[u]);
      }
    }
    // the local walk from zero: h_end = A * h_in + Bl
    float A = 1.f, Bl = 0.f;
#pragma unroll
    for (int u = 0; u < T; ++u) {
      Bl = fmaf(a[u], Bl, b[u]);
      A = __fmul_rn(A, a[u]);
    }
    const int buf = k & 1;
    part_a[buf][w][lane] = A;
    part_b[buf][w][lane] = Bl;
    __syncthreads();
    c = carry[buf][lane];
#pragma unroll
    for (int j = 0; j < NW - 1; ++j)
      if (j < w) c = fmaf(part_a[buf][j][lane], c, part_b[buf][j][lane]);
#pragma unroll
    for (int u = 0; u < T; ++u) {
      c = fmaf(a[u], c, b[u]);
      if (live && t0 + u < p.S) p.out[(row0 + t0 + u) * p.R + r] = c;
      // h_last is h at step S - 1 on bits, as the warp that owns it walks
      // it (not the folded carry of a partial last round)
      if (live && t0 + u == p.S - 1) p.h_last[(size_t)bi * p.R + r] = c;
    }
    if (w == NW - 1) carry[buf ^ 1][lane] = c;
  }
}

// The plan for S steps, as rglru.py::scan_chunks gives it.
void plan_for(int S, int* warps, int* steps) {
  if (S <= SERIAL_MAX_S) {
    *warps = 1;
    *steps = 1;
  } else {
    *warps = CHUNK_WARPS;
    *steps = CHUNK_STEPS;
  }
}

template <bool GATED, typename Y>
int launch(const Args& p, int B, bool serial, cudaStream_t st) {
  if (serial) {
    const int BR = B * p.R;
    rglru_serial_kernel<GATED, Y>
        <<<(BR + SERIAL_THREADS - 1) / SERIAL_THREADS, SERIAL_THREADS, 0, st>>>(
            p, BR);
  } else {
    rglru_chunk_kernel<GATED, Y, CHUNK_WARPS, CHUNK_STEPS>
        <<<dim3((p.R + LANES - 1) / LANES, B), CHUNK_WARPS * 32, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

constexpr int VARIANT_SCAN = 0;
constexpr int VARIANT_GATED = 1;

// Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for a shape or plan it does not take.  (warps,
// steps) must be the plan of S (the Python mirror's answer, checked here).
// x0, x1: a and b (scan) or r and i (gated); y and lam are read only by
// the gated variant (y_bytes 2 for bf16, 4 for float32).  All pointers are
// device pointers; the launch goes on `stream` and does not synchronise.
extern "C" int launch_rglru_scan(const void* x0, const void* x1,
                                 const void* y, const void* lam,
                                 const void* h0, void* out, void* h_last,
                                 int B, int S, int R, int y_bytes,
                                 int warps, int steps, int variant,
                                 void* stream) {
  if (B <= 0 || S <= 0 || R <= 0 || B > 65535 ||
      (long long)B * R > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  int pw, ps;
  plan_for(S, &pw, &ps);
  if (warps != pw || steps != ps) return (int)cudaErrorInvalidValue;
  Args p;
  p.x0 = (const float*)x0;
  p.x1 = (const float*)x1;
  p.y = y;
  p.lam = (const float*)lam;
  p.h0 = (const float*)h0;
  p.out = (float*)out;
  p.h_last = (float*)h_last;
  p.S = S;
  p.R = R;
  cudaStream_t st = (cudaStream_t)stream;
  const bool serial = pw == 1;
  if (variant == VARIANT_SCAN) return launch<false, float>(p, B, serial, st);
  if (variant != VARIANT_GATED) return (int)cudaErrorInvalidValue;
  if (y_bytes == 2) return launch<true, __nv_bfloat16>(p, B, serial, st);
  if (y_bytes == 4) return launch<true, float>(p, B, serial, st);
  return (int)cudaErrorInvalidValue;
}
