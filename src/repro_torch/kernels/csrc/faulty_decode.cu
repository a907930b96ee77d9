// K3: one-token GQA decode attention over a ring cache, corrupting K/V
// tiles as they are loaded from the undervolted cache domain.
//
// Replaces the TPU kernel repro/kernels/flash_attention/faulty.py::
// faulty_decode_attention (pallas_call at faulty.py:314).  q (B, 1, H, D);
// k, v (B, L, KH, D) -- one layer's slice of the stored cache, read in
// place; pos (B, L) int32 absolute positions (-1 = empty slot); q_pos (B,)
// int32 on the device, each row's decode position, read by the kernel so
// that a captured launch (a CUDA graph) follows the position buffer.  Each
// K/V word is corrupted through the leaf's block tables: leaf word offset
// word0 + (b * L + slot) * words_per_slot + kv_head * D / pack + d / pack,
// table entry offset >> words_log2, with the mask math of fault_masks.cuh
// (word, bitwise or SECDED), except in the row of ring slot q_pos[b] % L
// (the token written this step, still in the store buffer).  Masks:
// causal, window and pos < 0, added as -1e30 like the reference.  Online
// softmax in f32 over tiles of bkv slots, with the reference's tile
// semantics inside each split.  The split body (loads, corruption, scores, softmax, PV, merge)
// lives in decode_tile.cuh, shared with the paged kernel K4
// (paged_decode.cu).
//
// What bounds it on the H100: the K and V bytes of the layer (the decode
// working set, 16.8 MB at the llama3.2-3b main-path shape, 5 us at the
// HBM rate), and with injection on, 5 (word) or 41 (bitwise) mix32 hashes
// per word.  Design: the ring is split across blocks (flash-decoding): one
// CUDA block of 256 threads per (KV head, batch row, split), so the G = H /
// KH query heads of the group share every K/V word it loads, and a split
// is a run of whole bkv tiles (faulty.py::decode_splits; at the main-path
// shape 8 splits of one 128-slot tile, 256 blocks at B = 4, KH = 8, two on
// nearly every SM, one wave).  A block loads its whole split at once (8
// groups of 16 bytes in flight per thread, or cp.async without injection),
// corrupts the groups in registers with one table lookup each, folds its
// tiles into a partial, and the last block of each (row, KV head) merges
// the partials in split order in the same launch (decode_tile.cuh).  What
// bounds it now: with injection, the split's hashing (integer work of two
// blocks per SM, about half of a block's time); without, not the bytes
// but the block's dependent steps after its load -- scores, fold, PV,
// ticket and merge, each a few microseconds of barrier-separated latency
// (PERF.md).
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
  const int32_t* q_pos;
  void* out;
  float* part;
  int* tickets;
  const uint32_t* kbase;
  const uint32_t* kthr;
  const uint32_t* vbase;
  const uint32_t* vthr;
  int k_nblocks, v_nblocks;
  uint32_t k_word0, v_word0;
  int B, L, KH, G, D, bkv, tps, n_splits;
  int causal, window;
  float scale;
  uint32_t seed;
  int wprl2, words_log2;
};

// Split rows of one (batch row, KV head) of a contiguous ring leaf, from
// ring slot t0, addressed through the leaf's block (or page) tables at
// words_log2 granularity: leaf word word0 + (b * L + slot) * wps + kvh * Dw
// + c.  Half h: 0 = K, 1 = V (selects, not indexed arrays, keep the
// fields in registers).
struct RingAddr {
  const uint32_t *k, *v, *kbase, *vbase, *kthr, *vthr;
  int k_nblocks, v_nblocks;
  uint32_t k_word0, v_word0;
  int lg2, b, L, KH, Dw, kvh, t0;

  __device__ __forceinline__ const uint32_t* row(int h, int r) const {
    return (h ? v : k) + (((size_t)b * L + t0 + r) * KH + kvh) * Dw;
  }
  __device__ __forceinline__ int slot(int r) const { return t0 + r; }
  __device__ __forceinline__ void lookup(int h, int r, int c, uint32_t& wid,
                                         fm::Thr& t) const {
    const uint32_t wps = (uint32_t)(KH * Dw);
    const uint32_t off = (h ? v_word0 : k_word0) +
                         (uint32_t)(b * L + t0 + r) * wps +
                         (uint32_t)(kvh * Dw + c);
    const uint32_t j = off >> lg2;
    const uint32_t rem = off & ((1u << lg2) - 1u);
    if (j < (uint32_t)(h ? v_nblocks : k_nblocks)) {
      const uint32_t* thr = (h ? vthr : kthr) + (size_t)j * fm::NUM_THR_COLS;
      wid = __ldg((h ? vbase : kbase) + j) + rem;
#pragma unroll
      for (int i = 0; i < fm::NUM_THR_COLS; ++i) t.c[i] = __ldg(thr + i);
    } else {  // outside the table: zero base and thresholds, like the reference
      wid = rem;
      t = fm::zero_thr();
    }
  }
};

template <int PACK, int METHOD, bool INJECT>
__global__ void __launch_bounds__(THREADS, 2) faulty_decode_kernel(Params p) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t planes[2 * fm::PLANES];
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int H = p.KH * p.G;
  const dt::Smem sh = dt::carve<PACK>(smem, p.G, p.D, p.bkv, p.tps);
  const int tile0 = split * p.tps;
  const int nt = min(p.tps, p.L / p.bkv - tile0);
  const int t0 = tile0 * p.bkv, rows = nt * p.bkv;
  if (INJECT && METHOD == fm::METHOD_BITWISE) fm::fill_plane_inners(planes, p.seed);
  const fm::Streams s = fm::make_streams(p.seed);
  const int q_pos = p.q_pos[b];
  const int clean = ((q_pos % p.L) + p.L) % p.L;  // floor mod
  dt::stage_query(sh, p.q + ((size_t)b * H + kvh * p.G) * sh.Dw);
  for (int r = threadIdx.x; r < rows; r += THREADS)
    dt::cp_async4(sh.pos + r, p.pos + (size_t)b * p.L + t0 + r);
  if (INJECT && METHOD == fm::METHOD_BITWISE) __syncthreads();  // planes
  const RingAddr a{p.k,         p.v,         p.kbase,      p.vbase,
                   p.kthr,      p.vthr,      p.k_nblocks,  p.v_nblocks,
                   p.k_word0,   p.v_word0,   p.words_log2, b,
                   p.L,         p.KH,        sh.Dw,        kvh,
                   t0};
  dt::load_split<METHOD, INJECT, false>(a, sh, rows, clean, s, planes,
                                        p.wprl2);
  dt::cp_async_wait_all();
  __syncthreads();
  dt::scores<PACK>(sh, rows, p.scale, q_pos, p.causal, p.window);
  __syncthreads();
  dt::fold(sh, nt);
  __syncthreads();
  const int pf = dt::partial_floats(p.G, p.D);
  float* parts = p.part + ((size_t)b * p.KH + kvh) * p.n_splits * pf;
  dt::write_partial<PACK>(sh, nt, parts + (size_t)split * pf);
  if (dt::last_block(p.tickets + b * p.KH + kvh, p.n_splits))
    dt::merge<PACK>(sh, parts, p.n_splits, p.out,
                    (size_t)b * H + kvh * p.G);
}

template <int PACK, int METHOD, bool INJECT>
int launch(const Params& p, cudaStream_t st) {
  const size_t bytes = dt::smem_bytes(p.G, p.D, p.bkv, p.tps, PACK);
  auto kern = faulty_decode_kernel<PACK, METHOD, INJECT>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(p.KH, p.B, p.n_splits), dim3(THREADS), bytes, st>>>(p);
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
    const void* q, const void* k, const void* v, const void* pos,
    const void* q_pos, void* out, void* part, void* tickets,
    const void* kbase, const void* kthr, int k_nblocks, const void* vbase,
    const void* vthr, int v_nblocks, unsigned int k_word0,
    unsigned int v_word0, int B, int L, int KH, int G, int D, int bkv,
    int tps, int n_splits, int causal, int window, float scale,
    unsigned int seed, int wprl2,
    int words_log2, int method, int inject, int elem_bytes, void* stream) {
  if (B <= 0 || KH <= 0 || G <= 0 || bkv <= 0 || L % bkv || tps <= 0 ||
      n_splits != (L / bkv + tps - 1) / tps ||
      (D / (elem_bytes == 2 ? 2 : 1)) % 4) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = (const uint32_t*)q;
  p.k = (const uint32_t*)k;
  p.v = (const uint32_t*)v;
  p.pos = (const int32_t*)pos;
  p.q_pos = (const int32_t*)q_pos;
  p.out = out;
  p.part = (float*)part;
  p.tickets = (int*)tickets;
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
  p.tps = tps;
  p.n_splits = n_splits;
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
