// K5: stuck-at fault injection over one contiguous physical run of words.
//
// Replaces the TPU kernel repro/kernels/bitflip/bitflip.py::bitflip_pallas
// (pallas_call at bitflip.py:70), the legacy per-segment injector that the
// segments engine and the Algorithm 1 tester run.  Word i of x (n words)
// sits at physical word base + i, computed in uint32 so it wraps mod 2^32
// as the reference's uint32 iota does, and every word takes the one
// threshold row t (one PC at one voltage).  out = (x | m01) & ~(m10 & ~m01)
// through fault_masks.cuh, so K5 equals K1 on the same words by
// construction.
//
// What bounds it on the H100: every word is read once and written once
// (8 bytes per word); the masks cost 56 SASS ALU instructions per word on
// the word path, which sits near the line between the memory and integer
// bounds, and 624 on the bitwise path, which is bound by integer
// operations (PERF.md has both bounds at the sweep's shape, computed by
// chip_smoke.py).  Design: as K1, one CUDA block per 4096-word block, each
// thread moving 4 words per iteration through 16-byte loads and stores
// when the input is 16-byte aligned.  The threshold row, seed and base
// word are kernel arguments passed by value: the reference folds them into
// its trace and compiles again for every (voltage, PC) point of a sweep,
// while one build of K5 serves them all.  The last, partial block and
// unaligned inputs take a guarded word-at-a-time loop; words past n are
// never read or written, which equals the reference's zero padding to
// whole blocks followed by slicing.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fault_masks.cuh"

namespace {

constexpr int BLOCK_WORDS = 4096;
constexpr int THREADS = 256;

template <int METHOD>
__global__ void __launch_bounds__(THREADS)
    segment_bitflip_kernel(const uint32_t* __restrict__ x,
                           uint32_t* __restrict__ out, long long n,
                           uint32_t base, fm::Thr t, uint32_t seed, int wprl2,
                           int vec) {
  __shared__ uint32_t planes[2 * fm::PLANES];
  if (METHOD == fm::METHOD_BITWISE) {
    fm::fill_plane_inners(planes, seed);
    __syncthreads();
  }
  const fm::Streams s = fm::make_streams(seed);
  const long long w0 = (long long)blockIdx.x * BLOCK_WORDS;
  const uint32_t b = base + (uint32_t)blockIdx.x * (uint32_t)BLOCK_WORDS;
  const long long rem = n - w0;
  if (vec && rem >= BLOCK_WORDS) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + w0);
    uint4* ov = reinterpret_cast<uint4*>(out + w0);
    for (int i = threadIdx.x; i < BLOCK_WORDS / 4; i += THREADS) {
      uint4 v = xv[i];
      const uint32_t w = b + 4u * (uint32_t)i;
      v.x = fm::apply_masks<METHOD>(v.x, w + 0u, s, planes, t, wprl2);
      v.y = fm::apply_masks<METHOD>(v.y, w + 1u, s, planes, t, wprl2);
      v.z = fm::apply_masks<METHOD>(v.z, w + 2u, s, planes, t, wprl2);
      v.w = fm::apply_masks<METHOD>(v.w, w + 3u, s, planes, t, wprl2);
      ov[i] = v;
    }
  } else {
    const int m = rem < BLOCK_WORDS ? (int)rem : BLOCK_WORDS;
    for (int i = threadIdx.x; i < m; i += THREADS)
      out[w0 + i] = fm::apply_masks<METHOD>(x[w0 + i], b + (uint32_t)i, s,
                                            planes, t, wprl2);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  x and out are
// device pointers to n words; thr is a HOST pointer to the 11-word
// threshold row, copied into the kernel's arguments.  The launch goes on
// `stream` and does not synchronise.
extern "C" int launch_segment_bitflip(const void* x, void* out, long long n,
                                      unsigned int base,
                                      const unsigned int* thr,
                                      unsigned int seed, int method,
                                      int wprl2, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long nb = (n + BLOCK_WORDS - 1) / BLOCK_WORDS;
  if (nb > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  fm::Thr t;
  for (int i = 0; i < fm::NUM_THR_COLS; ++i) t.c[i] = thr[i];
  const int vec = ((uintptr_t)x & 15u) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned int)nb), block(THREADS);
  if (method == fm::METHOD_BITWISE) {
    segment_bitflip_kernel<fm::METHOD_BITWISE><<<grid, block, 0, st>>>(
        (const uint32_t*)x, (uint32_t*)out, n, base, t, seed, wprl2, vec);
  } else if (method == fm::METHOD_WORD) {
    segment_bitflip_kernel<fm::METHOD_WORD><<<grid, block, 0, st>>>(
        (const uint32_t*)x, (uint32_t*)out, n, base, t, seed, wprl2, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
