// The per-tile body of the port's faulty decode-attention kernels.
//
// K3 (faulty_decode.cu, contiguous ring cache) and K4 (paged_decode.cu,
// page pool) both include this header, so a tile of K/V goes through the
// same instructions in both: the 16-byte loads with read-path corruption
// (fault_masks.cuh), the scores, the NaN-propagating max, the additive
// -1e30 masks, the online-softmax rescale and the PV product.  The two
// kernels differ only in how a tile's rows are addressed (an Addr policy:
// a ring slice through leaf block tables, or one pool page through its
// page tables), which is what makes paged == contiguous on bits when the
// contiguous tile is one page long.
//
// One CUDA block handles one (batch row or serving slot, KV head): the G
// query heads of the group share every loaded word.  Shared memory layout
// (floats unless noted): q (G, D) scaled, acc (G, D), scores (G, bkv),
// m (G), l (G), rescale (G), pos (bkv) int, K tile (bkv, Dw + 1) words,
// V tile (bkv, Dw + 1) words -- head rows padded by one word against bank
// conflicts.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fault_masks.cuh"

namespace dt {

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

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

// Bytes of dynamic shared memory of one block (the wrapper mirrors this).
__host__ __forceinline__ size_t smem_bytes(int G, int D, int bkv, int pack) {
  const int Dw = D / pack;
  const size_t floats = 2 * (size_t)G * D + (size_t)G * bkv + 3 * (size_t)G +
                        bkv;
  return 4 * (floats + 2 * (size_t)bkv * (Dw + 1));
}

struct Smem {
  float* q;
  float* acc;
  float* s;
  float* m;
  float* l;
  float* corr;
  int* pos;
  uint32_t* k;
  uint32_t* v;
  int G, D, bkv, Dw, Ds;
};

template <int PACK>
__device__ __forceinline__ Smem carve(float* base, int G, int D, int bkv) {
  Smem sh;
  sh.G = G;
  sh.D = D;
  sh.bkv = bkv;
  sh.Dw = D / PACK;
  sh.Ds = sh.Dw + 1;
  sh.q = base;
  sh.acc = sh.q + G * D;
  sh.s = sh.acc + G * D;
  sh.m = sh.s + G * bkv;
  sh.l = sh.m + G;
  sh.corr = sh.l + G;
  sh.pos = reinterpret_cast<int*>(sh.corr + G);
  sh.k = reinterpret_cast<uint32_t*>(sh.pos + bkv);
  sh.v = sh.k + bkv * sh.Ds;
  return sh;
}

// q rows of the group (G consecutive heads of Dw words) -> scaled f32 in
// shared memory; accumulators reset.  Ends with a barrier.
template <int PACK>
__device__ __forceinline__ void init_query(const Smem& sh, const uint32_t* q,
                                           float scale) {
  for (int i = threadIdx.x; i < sh.G * sh.D; i += THREADS) {
    const int g = i / sh.D, d = i % sh.D;
    sh.q[i] = word_elem<PACK>(q + g * sh.Dw, d) * scale;
    sh.acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < sh.G; g += THREADS) {
    sh.m[g] = NEG_INF;
    sh.l[g] = 0.f;
  }
  __syncthreads();
}

// Corrupts 4 consecutive words whose first physical id is wid (one table
// row t; an ECC group is two codewords).  COUNT adds the corrected
// codewords to `corrected`.
template <int METHOD, bool COUNT>
__device__ __forceinline__ void corrupt4(uint4& x, uint32_t wid,
                                         const fm::Thr& t,
                                         const fm::Streams& s,
                                         const uint32_t* planes, int wprl2,
                                         int& corrected) {
  if (METHOD == fm::METHOD_ECC) {
    int c0, u0, c1, u1;
    fm::ecc_codeword(x.x, x.y, wid, s, t, wprl2, c0, u0);
    fm::ecc_codeword(x.z, x.w, wid + 2u, s, t, wprl2, c1, u1);
    if (COUNT) corrected += c0 + c1;
  } else {
    x.x = fm::apply_masks<METHOD>(x.x, wid + 0u, s, planes, t, wprl2);
    x.y = fm::apply_masks<METHOD>(x.y, wid + 1u, s, planes, t, wprl2);
    x.z = fm::apply_masks<METHOD>(x.z, wid + 2u, s, planes, t, wprl2);
    x.w = fm::apply_masks<METHOD>(x.w, wid + 3u, s, planes, t, wprl2);
  }
}

// Loads the (bkv, Dw) tile of one KV head into shared memory, corrupting
// it on the way unless INJECT is false; the tile row whose ring slot is
// clean_slot keeps its stored value (store buffer).  Rows are read as
// 16-byte groups of 4 words; UNROLL groups per thread are in flight
// before any is processed.  Addr supplies, for tile row r and word c of
// the head row: the source pointer of the head row, the ring slot, and
// the physical word id + threshold row of word c (a multiple of 4, so a
// group never straddles a table entry: one lookup per group).
template <int METHOD, bool INJECT, bool COUNT, class Addr>
__device__ __forceinline__ void load_tile(const Addr& a, uint32_t* dst,
                                          const Smem& sh, int clean_slot,
                                          const fm::Streams& s,
                                          const uint32_t* planes, int wprl2,
                                          int& corrected) {
  constexpr int UNROLL = 4;
  const int per_row = sh.Dw / 4, n = sh.bkv * per_row;
  for (int i0 = threadIdx.x; i0 < n; i0 += THREADS * UNROLL) {
    uint4 x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < n) {
        const int r = i / per_row, c = 4 * (i % per_row);
        x[u] = *reinterpret_cast<const uint4*>(a.row(r) + c);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i >= n) break;
      const int r = i / per_row, c = 4 * (i % per_row);
      if (INJECT && a.slot(r) != clean_slot) {
        uint32_t wid;
        fm::Thr t;
        a.lookup(r, c, wid, t);
        corrupt4<METHOD, COUNT>(x[u], wid, t, s, planes, wprl2, corrected);
      }
      uint32_t* d = dst + r * sh.Ds + c;
      d[0] = x[u].x;
      d[1] = x[u].y;
      d[2] = x[u].z;
      d[3] = x[u].w;
    }
  }
}

// One online-softmax step over the staged tile (K, V and pos in shared
// memory, barrier passed): scores with the causal / window / empty-slot
// masks added as -1e30, the running max and denominator, the rescale and
// the PV product.  Ends with a barrier.
template <int PACK>
__device__ __forceinline__ void tile_update(const Smem& sh, int q_pos,
                                            int causal, int window) {
  const int G = sh.G, D = sh.D, bkv = sh.bkv;
  for (int i = threadIdx.x; i < G * bkv; i += THREADS) {
    const int g = i / bkv, r = i % bkv;
    const uint32_t* krow = sh.k + r * sh.Ds;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc += sh.q[g * D + d] * word_elem<PACK>(krow, d);
    // int32 wrap-around like the reference's int32 subtraction
    const int delta = (int)((uint32_t)q_pos - (uint32_t)sh.pos[r]);
    float mask = 0.f;
    if (causal && delta < 0) mask = NEG_INF;
    if (window > 0 && delta >= window) mask = NEG_INF;
    if (sh.pos[r] < 0) mask = NEG_INF;
    sh.s[i] = acc + mask;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += THREADS / 32) {
    float mx = -INFINITY;
    for (int r = lane; r < bkv; r += 32) mx = maxnan(mx, sh.s[g * bkv + r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = maxnan(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
    const float m_prev = sh.m[g];
    const float m_new = maxnan(m_prev, mx);
    float sum = 0.f;
    for (int r = lane; r < bkv; r += 32) {
      const float e = expf(sh.s[g * bkv + r] - m_new);
      sh.s[g * bkv + r] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xFFFFFFFFu, sum, o);
    if (lane == 0) {
      const float corr = expf(m_prev - m_new);
      sh.corr[g] = corr;
      sh.l[g] = sh.l[g] * corr + sum;
      sh.m[g] = m_new;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float acc = 0.f;
    for (int r = 0; r < bkv; ++r)
      acc += sh.s[g * bkv + r] * word_elem<PACK>(sh.v + r * sh.Ds, d);
    sh.acc[i] = sh.acc[i] * sh.corr[g] + acc;
  }
  __syncthreads();
}

// acc / max(l, 1e-30) -> the group's G output rows (bf16 or f32).
template <int PACK>
__device__ __forceinline__ void finish(const Smem& sh, void* out,
                                       size_t row0) {
  for (int i = threadIdx.x; i < sh.G * sh.D; i += THREADS) {
    const int g = i / sh.D;
    const float o = sh.acc[i] / maxnan(sh.l[g], 1e-30f);
    const size_t idx = row0 * sh.D + i;
    if (PACK == 2)
      reinterpret_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(o);
    else
      reinterpret_cast<float*>(out)[idx] = o;
  }
}

}  // namespace dt
