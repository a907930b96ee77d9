// K2: fused stuck-at injection + SECDED(72,64) over a memory-domain arena.
//
// Replaces the TPU kernel repro/kernels/ecc/ecc.py::arena_ecc_pallas
// (pallas_call at ecc.py:131).  Same operands as K1 (word path only), plus
// two (num_blocks,) int32 outputs: per block, the number of uncorrectable
// (>= 2 faults) and of corrected (exactly 1 fault) codewords.  A codeword
// is a pair of adjacent words with one parity-fault draw.
//
// What bounds it on the H100: 8 bytes per word of traffic as K1, and about
// 5 mix32 hashes per word plus one parity hash per codeword, so it sits
// with K1's word path near the memory/integer line.  Design: one CUDA block
// per 4096-word arena block; each thread takes two codewords (4 words) per
// iteration through one uint4 load and store.  The per-block counts are
// exact integers reduced with warp shuffles and then shared memory, and
// written once per block: no atomics, and no order-dependent sums.
//
// Count-only entry (launch_arena_ecc_events): the self-healing scheduler's
// patrol scrub.  It replaces no TPU kernel of its own: the reference runs
// the same SECDED event math in plain jnp over every referenced pool page
// each step (repro/serving/paged.py::PagedKVCache.scrub_telemetry, on
// arena_ecc_events), which at full width reads ~470 MB per step.  Operands:
// one K/V pool leaf as n_layers x total_pages slices of page_words words,
// the per-(layer, page) physical base word and threshold row, and a
// per-page "referenced" byte mask; it writes nothing to the pool and adds,
// per page, its corrected and uncorrectable codewords over every layer to
// two (total_pages,) int32 outputs the wrapper zeroes.  What bounds it:
// the referenced pages' words, read once, and about 70 integer operations
// per word of mask math (the same ecc_codeword as K2).  Design: one block
// per (page, layer) slice, so a step's ~14k referenced slices fill the
// card; a block whose page is not referenced returns at once; each thread
// takes whole codewords (one 8-byte load), and the slice's counts are
// reduced in the block and added with one integer atomic per output, which
// is exact in any order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fault_masks.cuh"

namespace {

constexpr int BLOCK_WORDS = 4096;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    arena_ecc_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                     const uint32_t* __restrict__ block_base,
                     const uint32_t* __restrict__ block_thr,
                     int32_t* __restrict__ bad, int32_t* __restrict__ corr,
                     uint32_t seed, int wprl2) {
  __shared__ int warp_bad[THREADS / 32];
  __shared__ int warp_corr[THREADS / 32];
  const int blk = blockIdx.x;
  const fm::Streams s = fm::make_streams(seed);
  const fm::Thr t = fm::load_thr(block_thr + (size_t)blk * fm::NUM_THR_COLS);
  const uint32_t base = block_base[blk];
  const size_t v0 = (size_t)blk * (BLOCK_WORDS / 4);
  int n_bad = 0, n_corr = 0;
  for (int i = threadIdx.x; i < BLOCK_WORDS / 4; i += THREADS) {
    uint4 v = x[v0 + i];
    const uint32_t w = base + 4u * (uint32_t)i;
    int c0, u0, c1, u1;
    fm::ecc_codeword(v.x, v.y, w, s, t, wprl2, c0, u0);
    fm::ecc_codeword(v.z, v.w, w + 2u, s, t, wprl2, c1, u1);
    out[v0 + i] = v;
    n_corr += c0 + c1;
    n_bad += u0 + u1;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    n_bad += __shfl_down_sync(0xFFFFFFFFu, n_bad, off);
    n_corr += __shfl_down_sync(0xFFFFFFFFu, n_corr, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    warp_bad[warp] = n_bad;
    warp_corr[warp] = n_corr;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int tb = 0, tc = 0;
    for (int i = 0; i < THREADS / 32; ++i) {
      tb += warp_bad[i];
      tc += warp_corr[i];
    }
    bad[blk] = tb;
    corr[blk] = tc;
  }
}

}  // namespace

extern "C" int launch_arena_ecc(const void* x, void* out,
                                const void* block_base, const void* block_thr,
                                void* bad, void* corr, int num_blocks,
                                unsigned int seed, int wprl2, void* stream) {
  if (num_blocks <= 0) return (int)cudaErrorInvalidValue;
  arena_ecc_kernel<<<dim3(num_blocks), dim3(THREADS), 0,
                     (cudaStream_t)stream>>>(
      (const uint4*)x, (uint4*)out, (const uint32_t*)block_base,
      (const uint32_t*)block_thr, (int32_t*)bad, (int32_t*)corr, seed, wprl2);
  return (int)cudaGetLastError();
}

namespace {

__global__ void __launch_bounds__(THREADS)
    arena_ecc_events_kernel(const uint2* __restrict__ x,
                            const uint32_t* __restrict__ page_base,
                            const uint32_t* __restrict__ page_thr,
                            const uint8_t* __restrict__ referenced,
                            int32_t* __restrict__ corr,
                            int32_t* __restrict__ bad, int total_pages,
                            int page_words, uint32_t seed, int wprl2) {
  __shared__ int warp_bad[THREADS / 32];
  __shared__ int warp_corr[THREADS / 32];
  const int page = blockIdx.x;
  if (!referenced[page]) return;
  const size_t slice = (size_t)blockIdx.y * total_pages + page;
  const fm::Streams s = fm::make_streams(seed);
  const fm::Thr t = fm::load_thr(page_thr + slice * fm::NUM_THR_COLS);
  const uint32_t base = page_base[slice];
  const int cws = page_words / 2;
  const uint2* px = x + slice * (size_t)cws;
  int n_bad = 0, n_corr = 0;
  for (int i = threadIdx.x; i < cws; i += THREADS) {
    uint2 v = px[i];
    int c, u;
    fm::ecc_codeword(v.x, v.y, base + 2u * (uint32_t)i, s, t, wprl2, c, u);
    n_corr += c;
    n_bad += u;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    n_bad += __shfl_down_sync(0xFFFFFFFFu, n_bad, off);
    n_corr += __shfl_down_sync(0xFFFFFFFFu, n_corr, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    warp_bad[warp] = n_bad;
    warp_corr[warp] = n_corr;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int tb = 0, tc = 0;
    for (int i = 0; i < THREADS / 32; ++i) {
      tb += warp_bad[i];
      tc += warp_corr[i];
    }
    if (tc) atomicAdd(corr + page, tc);
    if (tb) atomicAdd(bad + page, tb);
  }
}

}  // namespace

extern "C" int launch_arena_ecc_events(const void* x, const void* page_base,
                                       const void* page_thr,
                                       const void* referenced, void* corr,
                                       void* bad, int n_layers,
                                       int total_pages, int page_words,
                                       unsigned int seed, int wprl2,
                                       void* stream) {
  if (n_layers <= 0 || total_pages <= 0 || page_words <= 0 ||
      page_words % 2 || n_layers > 65535)
    return (int)cudaErrorInvalidValue;
  arena_ecc_events_kernel<<<dim3(total_pages, n_layers), dim3(THREADS), 0,
                            (cudaStream_t)stream>>>(
      (const uint2*)x, (const uint32_t*)page_base, (const uint32_t*)page_thr,
      (const uint8_t*)referenced, (int32_t*)corr, (int32_t*)bad, total_pages,
      page_words, seed, wprl2);
  return (int)cudaGetLastError();
}
