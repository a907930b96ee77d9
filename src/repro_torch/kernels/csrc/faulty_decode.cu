// K3: one-token GQA decode attention over a ring cache, corrupting K/V
// tiles as they are loaded from the undervolted cache domain.
//
// Replaces the TPU kernel repro/kernels/flash_attention/faulty.py::
// faulty_decode_attention (pallas_call at faulty.py:314).  q (B, 1, H, D);
// k, v (B, L, KH, D) -- one layer's slice of the stored cache, read in
// place; pos (B, L) int32 absolute positions (-1 = empty slot).  Each K/V
// word is corrupted through the leaf's block tables: leaf word offset
// word0 + (b * L + slot) * words_per_slot + kv_head * D / pack + d / pack,
// table entry offset >> words_log2, with the mask math of fault_masks.cuh
// (word, bitwise or SECDED), except in the row of clean_slot (the token
// written this step, still in the store buffer).  Masks: causal, window
// and pos < 0, added as -1e30 like the reference.  Online softmax in f32
// over tiles of bkv slots, with the reference's tile semantics.  The
// per-tile body (loads, corruption, scores, softmax, PV) lives in
// decode_tile.cuh, shared with the paged kernel K4 (paged_decode.cu).
//
// What bounds it on the H100: the K and V bytes of the layer (the decode
// working set, 16.8 MB at the llama3.2-3b main-path shape), and with
// injection on, 5 (word) or 41 (bitwise) mix32 hashes per word.  Design:
// the simple, correct form first -- one CUDA block of 256 threads per
// (batch row, KV head), so the G = H / KH query heads of the group share
// every K/V word it loads.  Tiles are read as 16-byte groups of 4 words
// with several groups in flight per thread (a decode block is bound by
// load latency, not arithmetic), corrupted in registers with one table
// lookup per group, and staged through shared memory (rows padded by one
// word against bank conflicts).  At B = 4, KH = 8 the grid is only 32
// blocks on 132 SMs; splitting the ring across blocks (flash-decoding) is
// the next step and is recorded in PERF.md.
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
  void* out;
  const uint32_t* kbase;
  const uint32_t* kthr;
  const uint32_t* vbase;
  const uint32_t* vthr;
  int k_nblocks, v_nblocks;
  uint32_t k_word0, v_word0;
  int B, L, KH, G, D, bkv;
  int q_pos, clean_slot, causal, window;
  float scale;
  uint32_t seed;
  int wprl2, words_log2;
};

// Tile rows t0.. of one (batch row, KV head) of a contiguous ring leaf,
// addressed through the leaf's block (or page) tables at words_log2
// granularity: leaf word word0 + (b * L + slot) * wps + kvh * Dw + c.
struct RingAddr {
  const uint32_t* src;
  const uint32_t* base_tab;
  const uint32_t* thr_tab;
  int nblocks, lg2, b, L, KH, Dw, kvh, t0;
  uint32_t word0;

  __device__ __forceinline__ const uint32_t* row(int r) const {
    return src + (((size_t)b * L + t0 + r) * KH + kvh) * Dw;
  }
  __device__ __forceinline__ int slot(int r) const { return t0 + r; }
  __device__ __forceinline__ void lookup(int r, int c, uint32_t& wid,
                                         fm::Thr& t) const {
    const uint32_t wps = (uint32_t)(KH * Dw);
    const uint32_t off = word0 + (uint32_t)(b * L + t0 + r) * wps +
                         (uint32_t)(kvh * Dw + c);
    const uint32_t j = off >> lg2;
    const uint32_t rem = off & ((1u << lg2) - 1u);
    if (j < (uint32_t)nblocks) {
      wid = __ldg(base_tab + j) + rem;
#pragma unroll
      for (int i = 0; i < fm::NUM_THR_COLS; ++i)
        t.c[i] = __ldg(thr_tab + (size_t)j * fm::NUM_THR_COLS + i);
    } else {  // outside the table: zero base and thresholds, like the reference
      wid = rem;
      t = fm::zero_thr();
    }
  }
};

template <int PACK, int METHOD, bool INJECT>
__global__ void __launch_bounds__(THREADS) faulty_decode_kernel(Params p) {
  extern __shared__ float smem[];
  __shared__ uint32_t planes[2 * fm::PLANES];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int H = p.KH * p.G;
  const dt::Smem sh = dt::carve<PACK>(smem, p.G, p.D, p.bkv);
  if (INJECT && METHOD == fm::METHOD_BITWISE) fm::fill_plane_inners(planes, p.seed);
  const fm::Streams s = fm::make_streams(p.seed);
  dt::init_query<PACK>(sh, p.q + ((size_t)b * H + kvh * p.G) * sh.Dw,
                       p.scale);
  int unused = 0;
  for (int t0 = 0; t0 < p.L; t0 += p.bkv) {
    const RingAddr ka{p.k, p.kbase, p.kthr, p.k_nblocks, p.words_log2,
                      b, p.L, p.KH, sh.Dw, kvh, t0, p.k_word0};
    const RingAddr va{p.v, p.vbase, p.vthr, p.v_nblocks, p.words_log2,
                      b, p.L, p.KH, sh.Dw, kvh, t0, p.v_word0};
    dt::load_tile<METHOD, INJECT, false>(ka, sh.k, sh, p.clean_slot, s,
                                         planes, p.wprl2, unused);
    dt::load_tile<METHOD, INJECT, false>(va, sh.v, sh, p.clean_slot, s,
                                         planes, p.wprl2, unused);
    for (int r = threadIdx.x; r < p.bkv; r += THREADS)
      sh.pos[r] = p.pos[(size_t)b * p.L + t0 + r];
    __syncthreads();
    dt::tile_update<PACK>(sh, p.q_pos, p.causal, p.window);
  }
  dt::finish<PACK>(sh, p.out, (size_t)b * H + kvh * p.G);
}

template <int PACK, int METHOD, bool INJECT>
int launch(const Params& p, cudaStream_t st) {
  const size_t bytes = dt::smem_bytes(p.G, p.D, p.bkv, PACK);
  auto kern = faulty_decode_kernel<PACK, METHOD, INJECT>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(p.KH, p.B), dim3(THREADS), bytes, st>>>(p);
  return (int)cudaGetLastError();
}

template <int PACK>
int dispatch(const Params& p, int method, int inject, cudaStream_t st) {
  if (!inject) return launch<PACK, fm::METHOD_WORD, false>(p, st);
  switch (method) {
    case fm::METHOD_WORD:
      return launch<PACK, fm::METHOD_WORD, true>(p, st);
    case fm::METHOD_BITWISE:
      return launch<PACK, fm::METHOD_BITWISE, true>(p, st);
    case fm::METHOD_ECC:
      return launch<PACK, fm::METHOD_ECC, true>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int launch_faulty_decode(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    const void* kbase, const void* kthr, int k_nblocks, const void* vbase,
    const void* vthr, int v_nblocks, unsigned int k_word0,
    unsigned int v_word0, int B, int L, int KH, int G, int D, int bkv,
    int q_pos, int clean_slot, int causal, int window, float scale,
    unsigned int seed, int wprl2, int words_log2, int method, int inject,
    int elem_bytes, void* stream) {
  if (B <= 0 || KH <= 0 || G <= 0 || bkv <= 0 || L % bkv ||
      (D / (elem_bytes == 2 ? 2 : 1)) % 4) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = (const uint32_t*)q;
  p.k = (const uint32_t*)k;
  p.v = (const uint32_t*)v;
  p.pos = (const int32_t*)pos;
  p.out = out;
  p.kbase = (const uint32_t*)kbase;
  p.kthr = (const uint32_t*)kthr;
  p.vbase = (const uint32_t*)vbase;
  p.vthr = (const uint32_t*)vthr;
  p.k_nblocks = k_nblocks;
  p.v_nblocks = v_nblocks;
  p.k_word0 = k_word0;
  p.v_word0 = v_word0;
  p.B = B;
  p.L = L;
  p.KH = KH;
  p.G = G;
  p.D = D;
  p.bkv = bkv;
  p.q_pos = q_pos;
  p.clean_slot = clean_slot;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.seed = seed;
  p.wprl2 = wprl2;
  p.words_log2 = words_log2;
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 2) return dispatch<2>(p, method, inject, st);
  if (elem_bytes == 4) return dispatch<1>(p, method, inject, st);
  return (int)cudaErrorInvalidValue;
}
