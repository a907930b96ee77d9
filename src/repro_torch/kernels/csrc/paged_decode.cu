// K4: one-token GQA decode attention of every serving slot over its own
// ring cache stored in pool pages, corrupting each page as it is loaded.
//
// Replaces the TPU kernel repro/kernels/flash_attention/faulty.py::
// paged_decode_attention (pallas_call at faulty.py:529).  q (S, 1, H, D),
// one decode query per serving slot; k_pool, v_pool (N, PS, KH, D) -- one
// layer's page pool; pos_pool (N, PS) int32; page_table (S, n_lp) int32
// maps each slot's logical page to its physical pool page.  The ring length
// is n_lp * PS, so a narrower table gives a window ring.  Each K/V word of
// page pid is corrupted at physical id page_base[pid] + row * wps +
// kv_head * Dw + col with threshold row page_thr[pid] (a page never
// straddles an arena block), by the mask math of fault_masks.cuh, except in
// the row of ring slot q_pos[s] % length (the token written this step,
// still in the store buffer).  The online softmax folds one page per tile.
// With telemetry (ECC), counts[s, lp] receives the corrected codewords of
// logical page lp of slot s over K and V, the clean slot's excluded.  The
// fault-map seed is a runtime argument: nothing is specialised per shard.
//
// The per-tile body is decode_tile.cuh, the same code K3 runs, so K4 over
// a pool equals K3 over the same words with page-granular tables and a tile
// of PS slots, bit for bit.
//
// What bounds it on the H100: the live K/V pages of the layer (16.8 MB for
// 4 slots x 1024 slots x 8 KV heads x 128 bf16 at the llama3.2-3b
// main-path shape) and, with injection, the mask hashes per word.  Design:
// the simple, correct form first -- one CUDA block of 256 threads per
// (serving slot, KV head) walks the slot's pages in order, as K3 walks its
// tiles, so the G query heads share every loaded word.  A page of 8 slots
// is a small tile (128 16-byte groups per head): the walk is bound by the
// latency of one page load after another.  Splitting the pages across
// blocks and overlapping the next page's load with this page's math are
// the next steps, recorded in PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_tile.cuh"

namespace {

using dt::THREADS;

struct Params {
  const uint32_t* q;
  const uint32_t* k;
  const uint32_t* v;
  const int32_t* pos;
  const int32_t* ptab;
  const int32_t* q_pos;
  void* out;
  int* counts;
  const uint32_t* kbase;
  const uint32_t* kthr;
  const uint32_t* vbase;
  const uint32_t* vthr;
  int S, n_lp, PS, KH, G, D;
  int causal, window;
  float scale;
  uint32_t seed;
  int wprl2;
};

// Rows of one physical page of one KV head.
struct PageAddr {
  const uint32_t* src;
  const uint32_t* base_tab;
  const uint32_t* thr_tab;
  int pid, PS, KH, Dw, kvh, slot0;

  __device__ __forceinline__ const uint32_t* row(int r) const {
    return src + (((size_t)pid * PS + r) * KH + kvh) * Dw;
  }
  __device__ __forceinline__ int slot(int r) const { return slot0 + r; }
  __device__ __forceinline__ void lookup(int r, int c, uint32_t& wid,
                                         fm::Thr& t) const {
    wid = __ldg(base_tab + pid) + (uint32_t)(r * KH * Dw + kvh * Dw + c);
#pragma unroll
    for (int i = 0; i < fm::NUM_THR_COLS; ++i)
      t.c[i] = __ldg(thr_tab + (size_t)pid * fm::NUM_THR_COLS + i);
  }
};

// Block-wide sum of one int per thread; thread 0 gets the total.
__device__ __forceinline__ int block_sum(int x, int* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

template <int PACK, int METHOD, bool INJECT, bool COUNT>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(Params p) {
  extern __shared__ float smem[];
  __shared__ uint32_t planes[2 * fm::PLANES];
  __shared__ int red[THREADS / 32];
  const int kvh = blockIdx.x, si = blockIdx.y;
  const int H = p.KH * p.G;
  const int length = p.n_lp * p.PS;
  const dt::Smem sh = dt::carve<PACK>(smem, p.G, p.D, p.PS);
  if (INJECT && METHOD == fm::METHOD_BITWISE) fm::fill_plane_inners(planes, p.seed);
  const fm::Streams s = fm::make_streams(p.seed);
  const int q_pos = p.q_pos[si];
  const int clean = ((q_pos % length) + length) % length;  // floor mod
  dt::init_query<PACK>(sh, p.q + ((size_t)si * H + kvh * p.G) * sh.Dw,
                       p.scale);
  for (int lp = 0; lp < p.n_lp; ++lp) {
    const int pid = p.ptab[(size_t)si * p.n_lp + lp];
    const PageAddr ka{p.k, p.kbase, p.kthr, pid, p.PS, p.KH, sh.Dw, kvh,
                      lp * p.PS};
    const PageAddr va{p.v, p.vbase, p.vthr, pid, p.PS, p.KH, sh.Dw, kvh,
                      lp * p.PS};
    int corrected = 0;
    dt::load_tile<METHOD, INJECT, COUNT>(ka, sh.k, sh, clean, s, planes,
                                         p.wprl2, corrected);
    dt::load_tile<METHOD, INJECT, COUNT>(va, sh.v, sh, clean, s, planes,
                                         p.wprl2, corrected);
    for (int r = threadIdx.x; r < p.PS; r += THREADS)
      sh.pos[r] = p.pos[(size_t)pid * p.PS + r];
    if (COUNT) {
      const int total = block_sum(corrected, red);
      // KV heads are separate blocks: integer atomics, exact in any order
      if (threadIdx.x == 0 && total)
        atomicAdd(p.counts + (size_t)si * p.n_lp + lp, total);
    }
    __syncthreads();
    dt::tile_update<PACK>(sh, q_pos, p.causal, p.window);
  }
  dt::finish<PACK>(sh, p.out, (size_t)si * H + kvh * p.G);
}

template <int PACK, int METHOD, bool INJECT, bool COUNT>
int launch(const Params& p, cudaStream_t st) {
  const size_t bytes = dt::smem_bytes(p.G, p.D, p.PS, PACK);
  auto kern = paged_decode_kernel<PACK, METHOD, INJECT, COUNT>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(p.KH, p.S), dim3(THREADS), bytes, st>>>(p);
  return (int)cudaGetLastError();
}

template <int PACK>
int dispatch(const Params& p, int method, int inject, int telemetry,
             cudaStream_t st) {
  if (!inject) return launch<PACK, fm::METHOD_WORD, false, false>(p, st);
  switch (method) {
    case fm::METHOD_WORD:
      return launch<PACK, fm::METHOD_WORD, true, false>(p, st);
    case fm::METHOD_BITWISE:
      return launch<PACK, fm::METHOD_BITWISE, true, false>(p, st);
    case fm::METHOD_ECC:
      return telemetry ? launch<PACK, fm::METHOD_ECC, true, true>(p, st)
                       : launch<PACK, fm::METHOD_ECC, true, false>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int launch_paged_decode(
    const void* q, const void* k, const void* v, const void* pos,
    const void* ptab, const void* q_pos, void* out, void* counts,
    const void* kbase, const void* kthr, const void* vbase,
    const void* vthr, int S, int n_lp, int PS, int KH, int G, int D,
    int causal, int window, float scale, unsigned int seed, int wprl2,
    int method, int inject, int telemetry, int elem_bytes, void* stream) {
  if (S <= 0 || n_lp <= 0 || PS <= 0 || KH <= 0 || G <= 0 ||
      (D / (elem_bytes == 2 ? 2 : 1)) % 4 ||
      (telemetry && (method != fm::METHOD_ECC || !inject || !counts))) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = (const uint32_t*)q;
  p.k = (const uint32_t*)k;
  p.v = (const uint32_t*)v;
  p.pos = (const int32_t*)pos;
  p.ptab = (const int32_t*)ptab;
  p.q_pos = (const int32_t*)q_pos;
  p.out = out;
  p.counts = (int*)counts;
  p.kbase = (const uint32_t*)kbase;
  p.kthr = (const uint32_t*)kthr;
  p.vbase = (const uint32_t*)vbase;
  p.vthr = (const uint32_t*)vthr;
  p.S = S;
  p.n_lp = n_lp;
  p.PS = PS;
  p.KH = KH;
  p.G = G;
  p.D = D;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.seed = seed;
  p.wprl2 = wprl2;
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 2) return dispatch<2>(p, method, inject, telemetry, st);
  if (elem_bytes == 4) return dispatch<1>(p, method, inject, telemetry, st);
  return (int)cudaErrorInvalidValue;
}
