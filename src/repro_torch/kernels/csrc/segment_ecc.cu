// K6: fused stuck-at injection + SECDED(72,64) over one contiguous physical
// run of words.
//
// Replaces the TPU kernel repro/kernels/ecc/ecc.py::ecc_pallas (pallas_call
// at ecc.py:48).  Addressing as K5 (word i at physical word base + i in
// uint32, one threshold row t by value); the codeword math is K2's
// (fault_masks.cuh::ecc_codeword: two adjacent words, one parity-fault
// draw), so K6 equals K2 on the same words by construction.  Output: the
// corrected words and one int32 per 4096-word block, the number of
// uncorrectable (>= 2 faults) codewords of that block.
//
// The tail: the reference's kernel route zero-pads the run to whole
// 4096-word blocks and counts the uncorrectable codewords of the padding
// too (repro/kernels/ecc/ops.py).  K6 keeps that count: in the last,
// partial block every codeword is evaluated, words at or past n reading
// as 0, and only words below n are stored.
//
// What bounds it on the H100: 8 bytes per word of traffic as K1, and about
// 70 SASS ALU instructions per word (the word masks of both words of a
// codeword, two popcounts, the weak-row and parity hashes), so it sits
// with K1's word path near the memory/integer line.  Design: one CUDA
// block per 4096-word block; each thread takes two codewords (4 words) per
// iteration through one 16-byte load and store when the input is aligned.
// The per-block count is an exact integer reduced with warp shuffles and
// shared memory and written once per block: no atomics.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fault_masks.cuh"

namespace {

constexpr int BLOCK_WORDS = 4096;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    segment_ecc_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ out, int32_t* __restrict__ bad,
                       long long n, uint32_t base, fm::Thr t, uint32_t seed,
                       int wprl2, int vec) {
  __shared__ int warp_bad[THREADS / 32];
  const fm::Streams s = fm::make_streams(seed);
  const long long w0 = (long long)blockIdx.x * BLOCK_WORDS;
  const uint32_t b = base + (uint32_t)blockIdx.x * (uint32_t)BLOCK_WORDS;
  const long long rem = n - w0;
  int n_bad = 0;
  if (vec && rem >= BLOCK_WORDS) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + w0);
    uint4* ov = reinterpret_cast<uint4*>(out + w0);
    for (int i = threadIdx.x; i < BLOCK_WORDS / 4; i += THREADS) {
      uint4 v = xv[i];
      const uint32_t w = b + 4u * (uint32_t)i;
      int c0, u0, c1, u1;
      fm::ecc_codeword(v.x, v.y, w, s, t, wprl2, c0, u0);
      fm::ecc_codeword(v.z, v.w, w + 2u, s, t, wprl2, c1, u1);
      ov[i] = v;
      n_bad += u0 + u1;
    }
  } else {
    for (int c = threadIdx.x; c < BLOCK_WORDS / 2; c += THREADS) {
      const long long i0 = 2LL * c;
      uint32_t x0 = i0 < rem ? x[w0 + i0] : 0u;
      uint32_t x1 = i0 + 1 < rem ? x[w0 + i0 + 1] : 0u;
      int corr, unc;
      fm::ecc_codeword(x0, x1, b + 2u * (uint32_t)c, s, t, wprl2, corr, unc);
      if (i0 < rem) out[w0 + i0] = x0;
      if (i0 + 1 < rem) out[w0 + i0 + 1] = x1;
      n_bad += unc;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    n_bad += __shfl_down_sync(0xFFFFFFFFu, n_bad, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_bad[warp] = n_bad;
  __syncthreads();
  if (threadIdx.x == 0) {
    int tb = 0;
    for (int i = 0; i < THREADS / 32; ++i) tb += warp_bad[i];
    bad[blockIdx.x] = tb;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  x and out are
// device pointers to n words, bad to ceil(n / 4096) int32 counts; thr is a
// HOST pointer to the 11-word threshold row, copied into the kernel's
// arguments.  The launch goes on `stream` and does not synchronise.
extern "C" int launch_segment_ecc(const void* x, void* out, void* bad,
                                  long long n, unsigned int base,
                                  const unsigned int* thr, unsigned int seed,
                                  int wprl2, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long nb = (n + BLOCK_WORDS - 1) / BLOCK_WORDS;
  if (nb > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  fm::Thr t;
  for (int i = 0; i < fm::NUM_THR_COLS; ++i) t.c[i] = thr[i];
  const int vec = ((uintptr_t)x & 15u) == 0;
  segment_ecc_kernel<<<dim3((unsigned int)nb), dim3(THREADS), 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, (int32_t*)bad, n, base, t, seed,
      wprl2, vec);
  return (int)cudaGetLastError();
}
