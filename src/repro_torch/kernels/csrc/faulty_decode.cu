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
// over tiles of bkv slots, with the reference's tile semantics.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fault_masks.cuh"

namespace {

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

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

// NaN-propagating max, like jnp.maximum / torch.maximum.
__device__ __forceinline__ float maxnan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <int PACK>
__device__ __forceinline__ float word_elem(const uint32_t* row, int d) {
  if (PACK == 2) {
    const uint32_t w = row[d >> 1];
    return __uint_as_float((d & 1) ? (w & 0xFFFF0000u) : (w << 16));
  }
  return __uint_as_float(row[d]);
}

__device__ __forceinline__ void lookup(const uint32_t* base_tab,
                                       const uint32_t* thr_tab, int nblocks,
                                       uint32_t off, int lg2, uint32_t& wid,
                                       fm::Thr& t) {
  const uint32_t j = off >> lg2;
  const uint32_t rem = off & ((1u << lg2) - 1u);
  if (j < (uint32_t)nblocks) {
    wid = __ldg(base_tab + j) + rem;
#pragma unroll
    for (int c = 0; c < fm::NUM_THR_COLS; ++c)
      t.c[c] = __ldg(thr_tab + (size_t)j * fm::NUM_THR_COLS + c);
  } else {  // outside the table: zero base and thresholds, like the reference
    wid = rem;
    t = fm::zero_thr();
  }
}

// Corrupts 4 leaf-consecutive words starting at leaf word `off` (a
// multiple of 4, so the group never straddles a table entry: one lookup).
template <int METHOD>
__device__ __forceinline__ void corrupt4(uint4& x, uint32_t off,
                                         const uint32_t* base_tab,
                                         const uint32_t* thr_tab,
                                         int nblocks, const Params& p,
                                         const fm::Streams& s,
                                         const uint32_t* planes) {
  uint32_t wid;
  fm::Thr t;
  lookup(base_tab, thr_tab, nblocks, off, p.words_log2, wid, t);
  if (METHOD == fm::METHOD_ECC) {
    int corrected, uncorrectable;
    fm::ecc_codeword(x.x, x.y, wid, s, t, p.wprl2, corrected, uncorrectable);
    fm::ecc_codeword(x.z, x.w, wid + 2u, s, t, p.wprl2, corrected,
                     uncorrectable);
  } else {
    x.x = fm::apply_masks<METHOD>(x.x, wid + 0u, s, planes, t, p.wprl2);
    x.y = fm::apply_masks<METHOD>(x.y, wid + 1u, s, planes, t, p.wprl2);
    x.z = fm::apply_masks<METHOD>(x.z, wid + 2u, s, planes, t, p.wprl2);
    x.w = fm::apply_masks<METHOD>(x.w, wid + 3u, s, planes, t, p.wprl2);
  }
}

// Loads one (bkv, Dw) tile of this (b, kv head) into shared memory,
// corrupting it on the way unless INJECT is false.  Rows are read as
// 16-byte groups of 4 words; UNROLL groups per thread are in flight
// before any is processed, so the loads overlap.  Needs Dw % 4 == 0.
template <int METHOD, bool INJECT>
__device__ __forceinline__ void load_tile(
    const uint32_t* __restrict__ src, uint32_t* dst, int dst_stride,
    const uint32_t* base_tab, const uint32_t* thr_tab, int nblocks,
    uint32_t word0, const Params& p, int b, int kvh, int t0, int Dw,
    const fm::Streams& s, const uint32_t* planes) {
  constexpr int UNROLL = 4;
  const uint32_t wps = (uint32_t)(p.KH * Dw);
  const int per_row = Dw / 4, n = p.bkv * per_row;
  for (int i0 = threadIdx.x; i0 < n; i0 += THREADS * UNROLL) {
    uint4 x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < n) {
        const int r = i / per_row, c = 4 * (i % per_row);
        const size_t row = ((size_t)b * p.L + t0 + r) * p.KH + kvh;
        x[u] = *reinterpret_cast<const uint4*>(src + row * Dw + c);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i >= n) break;
      const int r = i / per_row, c = 4 * (i % per_row), slot = t0 + r;
      if (INJECT && slot != p.clean_slot) {
        const uint32_t off = word0 + (uint32_t)(b * p.L + slot) * wps +
                             (uint32_t)(kvh * Dw + c);
        corrupt4<METHOD>(x[u], off, base_tab, thr_tab, nblocks, p, s,
                         planes);
      }
      uint32_t* d = dst + r * dst_stride + c;
      d[0] = x[u].x;
      d[1] = x[u].y;
      d[2] = x[u].z;
      d[3] = x[u].w;
    }
  }
}

template <int PACK, int METHOD, bool INJECT>
__global__ void __launch_bounds__(THREADS) faulty_decode_kernel(Params p) {
  extern __shared__ float smem[];
  __shared__ uint32_t planes[2 * fm::PLANES];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = p.G, D = p.D, bkv = p.bkv, H = p.KH * p.G;
  const int Dw = D / PACK, Ds = Dw + 1;  // words per head row, padded stride
  float* sq = smem;                      // (G, D) scaled query
  float* sacc = sq + G * D;              // (G, D) accumulator
  float* ss = sacc + G * D;              // (G, bkv) scores / probabilities
  float* sm = ss + G * bkv;              // (G,) running max
  float* sl = sm + G;                    // (G,) running denominator
  float* scorr = sl + G;                 // (G,) this tile's rescale
  int* spos = reinterpret_cast<int*>(scorr + G);            // (bkv,)
  uint32_t* sk = reinterpret_cast<uint32_t*>(spos + bkv);   // (bkv, Ds)
  uint32_t* sv = sk + bkv * Ds;                             // (bkv, Ds)

  if (INJECT && METHOD == fm::METHOD_BITWISE) fm::fill_plane_inners(planes, p.seed);
  const fm::Streams s = fm::make_streams(p.seed);
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    const uint32_t* qrow = p.q + ((size_t)b * H + kvh * G + g) * Dw;
    sq[i] = word_elem<PACK>(qrow, d) * p.scale;
    sacc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += THREADS) {
    sm[g] = NEG_INF;
    sl[g] = 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t0 = 0; t0 < p.L; t0 += bkv) {
    load_tile<METHOD, INJECT>(p.k, sk, Ds, p.kbase, p.kthr, p.k_nblocks,
                              p.k_word0, p, b, kvh, t0, Dw, s, planes);
    load_tile<METHOD, INJECT>(p.v, sv, Ds, p.vbase, p.vthr, p.v_nblocks,
                              p.v_word0, p, b, kvh, t0, Dw, s, planes);
    for (int r = threadIdx.x; r < bkv; r += THREADS)
      spos[r] = p.pos[(size_t)b * p.L + t0 + r];
    __syncthreads();

    for (int i = threadIdx.x; i < G * bkv; i += THREADS) {
      const int g = i / bkv, r = i % bkv;
      const uint32_t* krow = sk + r * Ds;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc += sq[g * D + d] * word_elem<PACK>(krow, d);
      // int32 wrap-around like the reference's int32 subtraction
      const int delta = (int)((uint32_t)p.q_pos - (uint32_t)spos[r]);
      float mask = 0.f;
      if (p.causal && delta < 0) mask = NEG_INF;
      if (p.window > 0 && delta >= p.window) mask = NEG_INF;
      if (spos[r] < 0) mask = NEG_INF;
      ss[i] = acc + mask;
    }
    __syncthreads();

    for (int g = warp; g < G; g += THREADS / 32) {
      float mx = -INFINITY;
      for (int r = lane; r < bkv; r += 32) mx = maxnan(mx, ss[g * bkv + r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = maxnan(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
      const float m_prev = sm[g];
      const float m_new = maxnan(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < bkv; r += 32) {
        const float e = expf(ss[g * bkv + r] - m_new);
        ss[g * bkv + r] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xFFFFFFFFu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        scorr[g] = corr;
        sl[g] = sl[g] * corr + sum;
        sm[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < G * D; i += THREADS) {
      const int g = i / D, d = i % D;
      float acc = 0.f;
      for (int r = 0; r < bkv; ++r)
        acc += ss[g * bkv + r] * word_elem<PACK>(sv + r * Ds, d);
      sacc[i] = sacc[i] * scorr[g] + acc;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    const float o = sacc[i] / maxnan(sl[g], 1e-30f);
    const size_t idx = ((size_t)b * H + kvh * G + g) * D + d;
    if (PACK == 2)
      reinterpret_cast<__nv_bfloat16*>(p.out)[idx] = __float2bfloat16_rn(o);
    else
      reinterpret_cast<float*>(p.out)[idx] = o;
  }
}

template <int PACK, int METHOD, bool INJECT>
int launch(const Params& p, cudaStream_t st) {
  const int Dw = p.D / PACK;
  const size_t floats = 2 * (size_t)p.G * p.D + (size_t)p.G * p.bkv +
                        3 * (size_t)p.G + p.bkv;
  const size_t bytes = 4 * (floats + 2 * (size_t)p.bkv * (Dw + 1));
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
