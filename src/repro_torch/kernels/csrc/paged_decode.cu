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
// still in the store buffer).  The online softmax folds one page per tile
// within each split.
// With telemetry (ECC), counts[s, lp] receives the corrected codewords of
// logical page lp of slot s over K and V, the clean slot's excluded.  The
// fault-map seed is a runtime argument: nothing is specialised per shard.
//
// The split body is decode_tile.cuh, the same code K3 runs, and the
// splits come from the same function of the ring length and the tile
// (faulty.py::decode_splits), so K4 over a pool equals K3 over the same
// words with page-granular tables and a tile of PS slots, bit for bit.
//
// What bounds it on the H100: the live K/V pages of the layer (16.8 MB for
// 4 slots x 1024 slots x 8 KV heads x 128 bf16 at the llama3.2-3b
// main-path shape) and, with injection, the mask hashes per word.  Design:
// the ring is split across blocks (flash-decoding): one CUDA block of 256
// threads per (KV head, serving slot, split), so the G query heads share
// every loaded word, and a split is a run of whole pages (16 pages of 8
// slots at the main-path shape: 8 splits, 256 blocks, one wave).  A block
// stages its pages' ids, then loads all of its pages' K and V at once (8
// groups of 16 bytes in flight per thread, each corrupted in registers
// with one table lookup; cp.async without injection), folds them one page
// per tile in ring order, and the last block of each (slot, KV head)
// merges the partials in split order in the same launch.  Corrected-
// codeword counts are summed per page in shared memory (integer atomics)
// and added to counts[s, lp] once per page and KV head; a page lies in one
// split, so the counts stay exact.  What bounds it now is what bounds K3
// (faulty_decode.cu): the hashing with injection, the block's dependent
// steps after its load without.
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
  float* part;
  int* tickets;
  const uint32_t* kbase;
  const uint32_t* kthr;
  const uint32_t* vbase;
  const uint32_t* vthr;
  int S, n_lp, PS, KH, G, D, tps, n_splits;
  int causal, window;
  float scale;
  uint32_t seed;
  int wprl2;
};

// Split rows of one KV head over the split's pool pages (ids staged in
// shared memory): split row r is row r % PS of logical page lp0 + r / PS.
// Half h: 0 = K, 1 = V.
struct PageAddr {
  const uint32_t *k, *v, *kbase, *vbase, *kthr, *vthr;
  const int* pid;
  int PS, KH, Dw, kvh, slot0;

  __device__ __forceinline__ const uint32_t* row(int h, int r) const {
    return (h ? v : k) +
           (((size_t)pid[r / PS] * PS + r % PS) * KH + kvh) * Dw;
  }
  __device__ __forceinline__ int slot(int r) const { return slot0 + r; }
  __device__ __forceinline__ void lookup(int h, int r, int c, uint32_t& wid,
                                         fm::Thr& t) const {
    const int page = pid[r / PS];
    const uint32_t* thr = (h ? vthr : kthr) + (size_t)page * fm::NUM_THR_COLS;
    wid = __ldg((h ? vbase : kbase) + page) +
          (uint32_t)((r % PS) * KH * Dw + kvh * Dw + c);
#pragma unroll
    for (int i = 0; i < fm::NUM_THR_COLS; ++i) t.c[i] = __ldg(thr + i);
  }
};

template <int PACK, int METHOD, bool INJECT, bool COUNT>
__global__ void __launch_bounds__(THREADS, 2) paged_decode_kernel(Params p) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t planes[2 * fm::PLANES];
  const int kvh = blockIdx.x, si = blockIdx.y, split = blockIdx.z;
  const int H = p.KH * p.G;
  const int length = p.n_lp * p.PS;
  const dt::Smem sh = dt::carve<PACK>(smem, p.G, p.D, p.PS, p.tps);
  const int lp0 = split * p.tps;
  const int nt = min(p.tps, p.n_lp - lp0);
  const int rows = nt * p.PS;
  if (INJECT && METHOD == fm::METHOD_BITWISE) fm::fill_plane_inners(planes, p.seed);
  const fm::Streams s = fm::make_streams(p.seed);
  const int q_pos = p.q_pos[si];
  const int clean = ((q_pos % length) + length) % length;  // floor mod
  dt::stage_query(sh, p.q + ((size_t)si * H + kvh * p.G) * sh.Dw);
  for (int t = threadIdx.x; t < nt; t += THREADS)
    sh.pid[t] = p.ptab[(size_t)si * p.n_lp + lp0 + t];
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += THREADS)
    dt::cp_async4(sh.pos + r,
                  p.pos + (size_t)sh.pid[r / p.PS] * p.PS + r % p.PS);
  const PageAddr a{p.k,    p.v,    p.kbase, p.vbase, p.kthr, p.vthr,
                   sh.pid, p.PS,   p.KH,    sh.Dw,   kvh,    lp0 * p.PS};
  dt::load_split<METHOD, INJECT, COUNT>(a, sh, rows, clean, s, planes,
                                        p.wprl2);
  dt::cp_async_wait_all();
  __syncthreads();
  if (COUNT) {
    // KV heads are separate blocks: integer atomics, exact in any order
    for (int t = threadIdx.x; t < nt; t += THREADS)
      if (sh.cnt[t]) atomicAdd(p.counts + (size_t)si * p.n_lp + lp0 + t,
                               sh.cnt[t]);
  }
  dt::scores<PACK>(sh, rows, p.scale, q_pos, p.causal, p.window);
  __syncthreads();
  dt::fold(sh, nt);
  __syncthreads();
  const int pf = dt::partial_floats(p.G, p.D);
  float* parts = p.part + ((size_t)si * p.KH + kvh) * p.n_splits * pf;
  dt::write_partial<PACK>(sh, nt, parts + (size_t)split * pf);
  if (dt::last_block(p.tickets + si * p.KH + kvh, p.n_splits))
    dt::merge<PACK>(sh, parts, p.n_splits, p.out,
                    (size_t)si * H + kvh * p.G);
}

template <int PACK, int METHOD, bool INJECT, bool COUNT>
int launch(const Params& p, cudaStream_t st) {
  const size_t bytes = dt::smem_bytes(p.G, p.D, p.PS, p.tps, PACK);
  auto kern = paged_decode_kernel<PACK, METHOD, INJECT, COUNT>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(p.KH, p.S, p.n_splits), dim3(THREADS), bytes, st>>>(p);
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
    const void* ptab, const void* q_pos, void* out, void* counts, void* part,
    void* tickets, const void* kbase, const void* kthr, const void* vbase,
    const void* vthr, int S, int n_lp, int PS, int KH, int G, int D, int tps,
    int n_splits, int causal, int window, float scale, unsigned int seed,
    int wprl2, int method, int inject, int telemetry, int elem_bytes,
    void* stream) {
  if (S <= 0 || n_lp <= 0 || PS <= 0 || KH <= 0 || G <= 0 || tps <= 0 ||
      n_splits != (n_lp + tps - 1) / tps ||
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
  p.part = (float*)part;
  p.tickets = (int*)tickets;
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
  p.tps = tps;
  p.n_splits = n_splits;
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
