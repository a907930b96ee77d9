// K1: stuck-at fault injection over a whole memory-domain arena.
//
// Replaces the TPU kernel repro/kernels/bitflip/bitflip.py::
// arena_bitflip_pallas (pallas_call at bitflip.py:212).  The arena is
// (num_blocks * 4096) uint32 words; block i starts at physical word
// block_base[i] and takes its thresholds from row i of block_thr
// (num_blocks, 11).  out = (x | m01) & ~(m10 & ~m01).
//
// What bounds it on the H100: every word is read once and written once
// (8 bytes per word), and the masks cost 5 mix32 hashes per word on the
// word path and 41 on the bitwise path.  The word path sits near the line
// between the memory and integer-ALU bounds; the bitwise path is bound by
// integer operations (see PERF.md for both bounds, computed by
// chip_smoke.py).  Design: one CUDA block per 4096-word arena block, so
// each block reads its own base word and threshold row once (the TPU's
// scalar prefetch becomes a block-uniform load kept in registers); each
// thread moves 4 words per iteration through 16-byte uint4 loads and
// stores, neighbouring threads on neighbouring addresses; the method is a
// template argument so the word path carries no bitwise-plane code.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fault_masks.cuh"

namespace {

constexpr int BLOCK_WORDS = 4096;
constexpr int THREADS = 256;

template <int METHOD>
__global__ void __launch_bounds__(THREADS)
    arena_bitflip_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                         const uint32_t* __restrict__ block_base,
                         const uint32_t* __restrict__ block_thr,
                         uint32_t seed, int wprl2) {
  __shared__ uint32_t planes[2 * fm::PLANES];
  const int blk = blockIdx.x;
  if (METHOD == fm::METHOD_BITWISE) {
    fm::fill_plane_inners(planes, seed);
    __syncthreads();
  }
  const fm::Streams s = fm::make_streams(seed);
  const fm::Thr t = fm::load_thr(block_thr + (size_t)blk * fm::NUM_THR_COLS);
  const uint32_t base = block_base[blk];
  const size_t v0 = (size_t)blk * (BLOCK_WORDS / 4);
  for (int i = threadIdx.x; i < BLOCK_WORDS / 4; i += THREADS) {
    uint4 v = x[v0 + i];
    const uint32_t w = base + 4u * (uint32_t)i;
    v.x = fm::apply_masks<METHOD>(v.x, w + 0u, s, planes, t, wprl2);
    v.y = fm::apply_masks<METHOD>(v.y, w + 1u, s, planes, t, wprl2);
    v.z = fm::apply_masks<METHOD>(v.z, w + 2u, s, planes, t, wprl2);
    v.w = fm::apply_masks<METHOD>(v.w, w + 3u, s, planes, t, wprl2);
    out[v0 + i] = v;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  All pointers are
// device pointers; the launch goes on `stream` and does not synchronise.
extern "C" int launch_arena_bitflip(const void* x, void* out,
                                    const void* block_base,
                                    const void* block_thr, int num_blocks,
                                    unsigned int seed, int method, int wprl2,
                                    void* stream) {
  if (num_blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(num_blocks), block(THREADS);
  if (method == fm::METHOD_BITWISE) {
    arena_bitflip_kernel<fm::METHOD_BITWISE><<<grid, block, 0, st>>>(
        (const uint4*)x, (uint4*)out, (const uint32_t*)block_base,
        (const uint32_t*)block_thr, seed, wprl2);
  } else if (method == fm::METHOD_WORD) {
    arena_bitflip_kernel<fm::METHOD_WORD><<<grid, block, 0, st>>>(
        (const uint4*)x, (uint4*)out, (const uint32_t*)block_base,
        (const uint32_t*)block_thr, seed, wprl2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
