// The split-ring body of the port's faulty decode-attention kernels.
//
// K3 (faulty_decode.cu, contiguous ring cache) and K4 (paged_decode.cu,
// page pool) both include this header, so a split of the ring goes
// through the same instructions in both: the 16-byte loads with read-path
// corruption (fault_masks.cuh), the scores, the NaN-propagating max, the
// additive -1e30 masks, the online-softmax fold tile by tile, the PV
// product, the partial (m, l, acc) and the merge of the partials.  The two
// kernels differ only in how a split's rows are addressed (an Addr policy:
// a ring slice through leaf block tables, or pool pages through their page
// tables), which is what makes paged == contiguous on bits when the
// contiguous tile is one page long.
//
// Grid: one block per (KV head, batch row or serving slot, split).  A
// split is a run of whole tiles of the ring; how many tiles, and how many
// splits, comes from faulty.py::decode_splits, a function of the ring
// length and the tile only, so a row's bits never depend on the batch.
// A block
//   1. loads its whole split (K and V) at once, as 16-byte groups of 4
//      words with UNROLL groups per thread in flight, corrupting each group
//      in registers with one table lookup (without injection, as cp.async
//      copies straight into shared memory); the query words and the
//      split's positions are cp.async copies in flight beside them;
//   2. computes every score of the split, LANES lanes per (query head,
//      slot) dot product reading 16 bytes at a time, reduced by a fixed
//      xor-shuffle order;
//   3. folds the split's tiles into an online softmax (m, l) in f32 with
//      the tile semantics of the reference -- each tile's max and sum are
//      taken in parallel, the running max and denominator then scanned
//      over the tiles in order -- and the PV product into acc (acc = acc *
//      corr_t + P_t V_t, tile by tile), and writes (m, l, acc) to the
//      partials scratch;
//   4. takes a ticket; the last block of a (row, KV head) to finish resets
//      the ticket and merges the partials in split order 0..n-1 (never in
//      arrival order): m = maxnan over the splits, acc and l summed with
//      weights exp(m_i - m), output = acc / max(l, 1e-30).
//
// Shared memory, in 4-byte units: K rows (ns, Dw) and V rows (ns, Dw) of
// the split (16-byte groups: every access pattern below is free of bank
// conflicts without padding), q (G, Dw) words as stored, p (G, ns) scores
// then probabilities, m (G), l (G), and per (query head, tile) the tile
// max then running max (tm), the tile sum (ts) and the rescale factor
// (corr), pos (ns), pid (tps) pool pages, cnt (tps) corrected codewords
// per tile.  The merge reuses the K/V rows for the staged partials.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fault_masks.cuh"

namespace dt {

constexpr int THREADS = 256;
constexpr int LANES = 8;
constexpr int UNROLL = 8;
constexpr float NEG_INF = -1e30f;

// NaN-propagating max, like jnp.maximum / torch.maximum.
__device__ __forceinline__ float maxnan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// Bytes of dynamic shared memory of one block whose split holds up to tps
// tiles of T slots (faulty.py::smem_bytes mirrors this).
__host__ __forceinline__ size_t smem_bytes(int G, int D, int T, int tps,
                                           int pack) {
  const size_t ns = (size_t)T * tps, dw = D / pack;
  return 4 * (2 * ns * dw + (size_t)G * dw + (size_t)G * ns + 2 * (size_t)G +
              3 * (size_t)G * tps + ns + 2 * (size_t)tps);
}

// Floats of one split's partial -- m (G), l (G), acc (G, D) -- padded to
// 16 bytes, so each partial can be staged with 16-byte copies
// (faulty.py::partial_floats mirrors this).
__host__ __device__ __forceinline__ int partial_floats(int G, int D) {
  return (G * (D + 2) + 3) & ~3;
}

struct Smem {
  uint32_t* k;
  uint32_t* v;
  uint32_t* q;
  float* p;
  float* m;
  float* l;
  float* tm;
  float* ts;
  float* corr;
  int* pos;
  int* pid;
  int* cnt;
  int G, D, Dw, T, tps, ns;
};

template <int PACK>
__device__ __forceinline__ Smem carve(uint32_t* base, int G, int D, int T,
                                      int tps) {
  Smem sh;
  sh.G = G;
  sh.D = D;
  sh.Dw = D / PACK;
  sh.T = T;
  sh.tps = tps;
  sh.ns = T * tps;
  sh.k = base;
  sh.v = sh.k + sh.ns * sh.Dw;
  sh.q = sh.v + sh.ns * sh.Dw;
  sh.p = reinterpret_cast<float*>(sh.q + G * sh.Dw);
  sh.m = sh.p + G * sh.ns;
  sh.l = sh.m + G;
  sh.tm = sh.l + G;
  sh.ts = sh.tm + G * tps;
  sh.corr = sh.ts + G * tps;
  sh.pos = reinterpret_cast<int*>(sh.corr + G * tps);
  sh.pid = sh.pos + sh.ns;
  sh.cnt = sh.pid + tps;
  return sh;
}

// 16- and 4-byte global -> shared copies in flight (cp.async), and the
// wait for all of this thread's copies.
__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the copy of the group's query words (G consecutive heads of Dw
// words, as stored: the scores scale them) into shared memory and resets
// the per-tile counts.  The copies land at the caller's cp_async_wait_all
// and barrier.
__device__ __forceinline__ void stage_query(const Smem& sh, const uint32_t* q) {
  for (int i = threadIdx.x; i < sh.G * sh.Dw; i += THREADS)
    cp_async4(sh.q + i, q + i);
  for (int t = threadIdx.x; t < sh.tps; t += THREADS) sh.cnt[t] = 0;
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

// Loads the split's `rows` K and V head rows of one KV head into shared
// memory, corrupting them on the way unless INJECT is false; the row whose
// ring slot is clean_slot keeps its stored value (store buffer).  K and V
// share one index space.  Without injection every group is a cp.async
// straight into shared memory, all in flight at once (they land at the
// caller's cp_async_wait_all); with injection UNROLL 16-byte groups per
// thread are in flight in registers before any is processed.  Addr
// supplies, for half h (0 = K, 1 = V), split row r and word c of the head
// row: the source pointer of the head row, the ring slot, and the physical
// word id + threshold row of word c (a multiple of 4, so a group never
// straddles a table entry: one lookup per group).
// COUNT adds each group's corrected codewords to its tile's cnt entry.
template <int METHOD, bool INJECT, bool COUNT, class Addr>
__device__ __forceinline__ void load_split(const Addr& a, const Smem& sh,
                                           int rows, int clean_slot,
                                           const fm::Streams& s,
                                           const uint32_t* planes,
                                           int wprl2) {
  const int per_row = sh.Dw / 4, n = rows * per_row;
  if (!INJECT) {
    for (int i = threadIdx.x; i < 2 * n; i += THREADS) {
      const int h = i >= n, j = i - h * n;
      const int r = j / per_row, c = 4 * (j % per_row);
      cp_async16((h ? sh.v : sh.k) + r * sh.Dw + c, a.row(h, r) + c);
    }
    return;
  }
  for (int i0 = threadIdx.x; i0 < 2 * n; i0 += THREADS * UNROLL) {
    uint4 x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < 2 * n) {
        const int h = i >= n, j = i - h * n;
        const int r = j / per_row, c = 4 * (j % per_row);
        x[u] = __ldg(reinterpret_cast<const uint4*>(a.row(h, r) + c));
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i >= 2 * n) break;
      const int h = i >= n, j = i - h * n;
      const int r = j / per_row, c = 4 * (j % per_row);
      if (a.slot(r) != clean_slot) {
        uint32_t wid;
        fm::Thr t;
        a.lookup(h, r, c, wid, t);
        int corrected = 0;
        corrupt4<METHOD, COUNT>(x[u], wid, t, s, planes, wprl2, corrected);
        if (COUNT && corrected) atomicAdd(sh.cnt + r / sh.T, corrected);
      }
      *reinterpret_cast<uint4*>((h ? sh.v : sh.k) + r * sh.Dw + c) = x[u];
    }
  }
}

// Every score of the split (q, K and pos staged, barrier passed): (q *
// scale) . k over LANES lanes per (query head, split row), each lane
// reading 16-byte groups of words (lane l: words 4l + 4 LANES j) into two
// accumulators (even and odd elements), then an xor-shuffle reduction in a
// fixed order; the causal / window / empty-slot masks added as -1e30.
// p[g][r] receives the score.
template <int PACK>
__device__ __forceinline__ void scores(const Smem& sh, int rows, float scale,
                                       int q_pos, int causal, int window) {
  const int lane = threadIdx.x % LANES, grp = threadIdx.x / LANES;
  // the loops are uniform across the block, so every lane shuffles
  for (int g = 0; g < sh.G; ++g) {
    const uint4* qg = reinterpret_cast<const uint4*>(sh.q + g * sh.Dw);
    for (int r0 = 0; r0 < rows; r0 += THREADS / LANES) {
      const int r = r0 + grp;
      float a0 = 0.f, a1 = 0.f;
      if (r < rows) {
        const uint4* krow = reinterpret_cast<const uint4*>(sh.k + r * sh.Dw);
        for (int c = lane; c < sh.Dw / 4; c += LANES) {
          const uint4 x = krow[c], y = qg[c];
          if (PACK == 2) {
            a0 = fmaf(bf16_lo(y.x) * scale, bf16_lo(x.x), a0);
            a1 = fmaf(bf16_hi(y.x) * scale, bf16_hi(x.x), a1);
            a0 = fmaf(bf16_lo(y.y) * scale, bf16_lo(x.y), a0);
            a1 = fmaf(bf16_hi(y.y) * scale, bf16_hi(x.y), a1);
            a0 = fmaf(bf16_lo(y.z) * scale, bf16_lo(x.z), a0);
            a1 = fmaf(bf16_hi(y.z) * scale, bf16_hi(x.z), a1);
            a0 = fmaf(bf16_lo(y.w) * scale, bf16_lo(x.w), a0);
            a1 = fmaf(bf16_hi(y.w) * scale, bf16_hi(x.w), a1);
          } else {
            a0 = fmaf(__uint_as_float(y.x) * scale, __uint_as_float(x.x), a0);
            a1 = fmaf(__uint_as_float(y.y) * scale, __uint_as_float(x.y), a1);
            a0 = fmaf(__uint_as_float(y.z) * scale, __uint_as_float(x.z), a0);
            a1 = fmaf(__uint_as_float(y.w) * scale, __uint_as_float(x.w), a1);
          }
        }
      }
      float acc = a0 + a1;
#pragma unroll
      for (int o = LANES / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xFFFFFFFFu, acc, o, LANES);
      if (r < rows && lane == 0) {
        const int pos = sh.pos[r];
        // int32 wrap-around like the reference's int32 subtraction
        const int delta = (int)((uint32_t)q_pos - (uint32_t)pos);
        float mask = 0.f;
        if (causal && delta < 0) mask = NEG_INF;
        if (window > 0 && delta >= window) mask = NEG_INF;
        if (pos < 0) mask = NEG_INF;
        sh.p[g * sh.ns + r] = acc + mask;
      }
    }
  }
}

// For every (query head, tile): the tile max (NaN propagating) of p or,
// with SUM, first p = exp(p - m_t) in place (m_t: the running max in tm)
// and then the tile sum of p, into out.  A segment of seg lanes (the
// tile's rows rounded up to a power of two, at most a warp) per (query
// head, tile), each lane folding rows lane, lane + seg, ..., then an
// xor-shuffle reduction in a fixed order.
template <bool SUM>
__device__ __forceinline__ void tile_reduce(const Smem& sh, int nt,
                                            float* out) {
  int seg = 1;
  while (seg < sh.T && seg < 32) seg *= 2;
  const int lane = threadIdx.x % seg, per_warp = 32 / seg;
  const int n = sh.G * nt, stride = (THREADS / 32) * per_warp;
  // uniform across each warp, so every lane shuffles
  for (int i0 = (threadIdx.x / 32) * per_warp; i0 < n; i0 += stride) {
    const int i = i0 + (threadIdx.x % 32) / seg;
    float x = SUM ? 0.f : -INFINITY;
    if (i < n) {
      float* pt = sh.p + (i / nt) * sh.ns + (i % nt) * sh.T;
      const float m_t = SUM ? sh.tm[(i / nt) * sh.tps + i % nt] : 0.f;
      for (int r = lane; r < sh.T; r += seg) {
        if (SUM) {
          const float e = expf(pt[r] - m_t);
          pt[r] = e;
          x += e;
        } else {
          x = maxnan(x, pt[r]);
        }
      }
    }
    for (int o = seg / 2; o > 0; o >>= 1) {
      const float y = __shfl_xor_sync(0xFFFFFFFFu, x, o);
      x = SUM ? x + y : maxnan(x, y);
    }
    if (i < n && lane == 0) out[(i / nt) * sh.tps + i % nt] = x;
  }
}

// The online softmax over the split's nt tiles, as the reference walks its
// tiles: m_t = maxnan(m_{t-1}, max of tile t) from m_{-1} = -1e30, p =
// exp(s - m_t) in place, corr_t = exp(m_{t-1} - m_t), l_t = l_{t-1} corr_t
// + sum of tile t.  The tile maxima and sums are taken in parallel, the
// running max as a prefix max over the tiles (one warp per query head, a
// lane per tile); only the denominator's scan runs per query head.  Leaves
// m, l and corr in shared memory.  Starts after the scores' barrier; the
// caller synchronises after it.
__device__ __forceinline__ void fold(const Smem& sh, int nt) {
  tile_reduce<false>(sh, nt, sh.tm);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < sh.G; g += THREADS / 32) {
    float* tm = sh.tm + g * sh.tps;
    float carry = NEG_INF;
    for (int t0 = 0; t0 < nt; t0 += 32) {
      const int t = t0 + lane;
      float x = t < nt ? tm[t] : -INFINITY;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xFFFFFFFFu, x, o);
        if (lane >= o) x = maxnan(y, x);
      }
      const float m_t = maxnan(carry, x);
      float m_prev = __shfl_up_sync(0xFFFFFFFFu, m_t, 1);
      if (lane == 0) m_prev = carry;
      if (t < nt) {
        sh.corr[g * sh.tps + t] = expf(m_prev - m_t);
        tm[t] = m_t;
      }
      carry = __shfl_sync(0xFFFFFFFFu, m_t, 31);
    }
    if (lane == 0) sh.m[g] = carry;
  }
  __syncthreads();
  tile_reduce<true>(sh, nt, sh.ts);
  __syncthreads();
  for (int g = threadIdx.x; g < sh.G; g += THREADS) {
    float l = 0.f;
    for (int t = 0; t < nt; ++t)
      l = fmaf(l, sh.corr[g * sh.tps + t], sh.ts[g * sh.tps + t]);
    sh.l[g] = l;
  }
}

// The split's partial (m, l, acc) -> part (partial_floats(G, D) floats):
// acc folds the tiles in order, acc = acc * corr_t + sum_r p_r v_r, one
// thread per (query head, V word), i.e. PACK elements that share each
// loaded word.  Needs fold's m, l (barrier passed).
template <int PACK>
__device__ __forceinline__ void write_partial(const Smem& sh, int nt,
                                              float* part) {
  for (int g = threadIdx.x; g < sh.G; g += THREADS) {
    part[g] = sh.m[g];
    part[sh.G + g] = sh.l[g];
  }
  float* acc_out = part + 2 * sh.G;
  for (int i = threadIdx.x; i < sh.G * sh.Dw; i += THREADS) {
    const int g = i / sh.Dw, w = i % sh.Dw;
    const float* pg = sh.p + g * sh.ns;
    const float* cg = sh.corr + g * sh.tps;
    float a0 = 0.f, a1 = 0.f;
    for (int t = 0; t < nt; ++t) {
      float v0 = 0.f, v1 = 0.f;
      for (int r = t * sh.T; r < (t + 1) * sh.T; ++r) {
        const uint32_t x = sh.v[r * sh.Dw + w];
        if (PACK == 2) {
          v0 = fmaf(pg[r], bf16_lo(x), v0);
          v1 = fmaf(pg[r], bf16_hi(x), v1);
        } else {
          v0 = fmaf(pg[r], __uint_as_float(x), v0);
        }
      }
      a0 = fmaf(a0, cg[t], v0);
      if (PACK == 2) a1 = fmaf(a1, cg[t], v1);
    }
    acc_out[g * sh.D + PACK * w] = a0;
    if (PACK == 2) acc_out[g * sh.D + 2 * w + 1] = a1;
  }
}

// After every thread wrote its part of the partial: true in the one block
// of a (row, KV head) that finishes last, which resets the ticket for the
// next launch.  The fences order the partials before the ticket.
__device__ __forceinline__ bool last_block(int* ticket, int n_splits) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int got = atomicAdd(ticket, 1);
    is_last = got == n_splits - 1;
    if (is_last) {
      *ticket = 0;
      __threadfence();
    }
  }
  __syncthreads();
  return is_last;
}

// Merges the n_splits partials of one (row, KV head) in split order and
// writes the group's G output rows (bf16 or f32) at output row row0.  The
// partials are staged in the block's K/V rows when they fit (16-byte
// copies past L1, all in flight at once), else read from L2 in place;
// the arithmetic is the same either way.  One thread per (query head,
// PACK adjacent elements).
template <int PACK>
__device__ __forceinline__ void merge(const Smem& sh, const float* parts,
                                      int n_splits, void* out, size_t row0) {
  const int G = sh.G, D = sh.D, pf = partial_floats(G, D);
  const bool staged = n_splits * pf <= 2 * sh.ns * sh.Dw;
  const float* src = parts;
  if (staged) {
    float* dst = reinterpret_cast<float*>(sh.k);
    for (int i = threadIdx.x; i < n_splits * pf / 4; i += THREADS)
      cp_async16(reinterpret_cast<uint32_t*>(dst) + 4 * i,
                 reinterpret_cast<const uint32_t*>(parts) + 4 * i);
    cp_async_wait_all();
    __syncthreads();
    src = dst;
  }
  auto ld = [&](int idx) { return staged ? src[idx] : __ldcg(src + idx); };
  for (int i = threadIdx.x; i < G * (D / PACK); i += THREADS) {
    const int g = i / (D / PACK), d0 = PACK * (i % (D / PACK));
    float m = ld(g);
    for (int k = 1; k < n_splits; ++k) m = maxnan(m, ld(k * pf + g));
    float a0 = 0.f, a1 = 0.f, l = 0.f;
    for (int k = 0; k < n_splits; ++k) {
      const int base = k * pf;
      const float w = expf(ld(base + g) - m);
      a0 = fmaf(ld(base + 2 * G + g * D + d0), w, a0);
      if (PACK == 2) a1 = fmaf(ld(base + 2 * G + g * D + d0 + 1), w, a1);
      l = fmaf(ld(base + G + g), w, l);
    }
    const float den = maxnan(l, 1e-30f);
    const size_t idx = row0 * D + g * D + d0;
    if (PACK == 2) {
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out) + idx;
      o[0] = __float2bfloat16_rn(a0 / den);
      o[1] = __float2bfloat16_rn(a1 / den);
    } else {
      reinterpret_cast<float*>(out)[idx] = a0 / den;
    }
  }
}

}  // namespace dt
