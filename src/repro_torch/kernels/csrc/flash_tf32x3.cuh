// K7, the float32 tensor-core variant: forward flash attention for prefill
// in float32 on the TF32 tensor cores, every product split in three
// (3xTF32).
//
// Replaces, with flash_prefill.cu's other variants, the TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (flash_attention.py:74, pallas_call at :85) for float32 q/k/v with
// head_dim up to 256 (flash_attention.py::pick_variant).  It computes what
// the Pallas body and the SIMT variant compute: scores (q * scale) . k with
// the additive -1e30 masks (j > i under causal, i - j >= window for
// window > 0, j >= sk) on every visited tile, an online softmax (m, l, acc)
// and out = acc / max(l, 1e-30); head h reads KV head h / G; key tiles
// outside a 64-row q tile's band are skipped (flash_prefill.cu says why
// that is exact on finite K/V), and a row whose band is empty is written
// as 0.
//
// What bounds it on the H100: operations.  The two products take 4 * D
// flops per (query, key) pair in the band: 3.44e10 at the f32 check's
// shape (4, 16, 1024, 256) causal, 0.513 ms on the float32 CUDA cores
// (67 TFLOP/s), where the SIMT variant runs them at 23 % of that.  One
// TF32 product (10 mantissa bits) cannot hold the float32 gate of 1e-5;
// three can: x = big + small with big = rna(x) and small = rna(x - big),
// rna being cvt.rna.tf32.f32 (round to nearest, ties away, at 10 mantissa
// bits), and x . y = small.big + big.small + big.big (the dropped
// small.small is ~2^-22 of it), three times the flops at the TF32 rate
// (494.7 TFLOP/s dense): 0.209 ms.  The design:
//   * Warp-level mma.sync m16n8k8 (tf32 in, float32 accumulators),
//     FA2-style: a block owns 64 query rows, 16 per warp, and walks their
//     band in tiles of 32 keys.  tf32 wgmma would need a K-major B from
//     shared memory for P V, but V is D-contiguous (MN-major) and neither
//     wgmma nor TMA transposes 32-bit elements.
//   * Splits: K and V are split once per tile as the block stages them
//     (big and small words side by side in shared memory), q (scaled,
//     float32 in shared memory) as each warp loads its A fragments, P in
//     registers; the products run small.big, big.small, big.big, in that
//     order.  rna is two integer operations on finite x (ptxas makes the
//     cvt an infinity test, the same add and a select).  Splitting K and V
//     at every fragment load instead (a cp.async ring of raw tiles) ran
//     1.5-2x slower: the splits are the scarce issue slots.
//   * Accumulators: the tensor cores' float32 sums across many mma lose
//     more than the dropped small.small (adding it changed nothing; with
//     one accumulator for all three products the mean error against a
//     float64 reference was 11x the SIMT variant's at the f32 check's
//     shape, measured on the card).  S keeps its cross products in a
//     second accumulator, added once at the end of the tile: closer to
//     float64 and faster (more independent mma chains).  O has no room for
//     a second accumulator at D = 256.
//   * Fragment layouts without shuffles: the m16n8k8 accumulator gives a
//     thread key columns 2t and 2t+1 of S, the tf32 A fragment wants k
//     positions t and t+4.  The product's k positions are permuted instead:
//     position t is key (or head column) 2t of its group of 8, position t+4
//     key 2t+1.  So S's accumulator is P's A fragment as it stands, and
//     every A and B fragment is one 8-byte load: q and K rows hold head
//     columns 2t, 2t+1 side by side, and V is stored pair-interleaved (keys
//     2t and 2t+1 of a column side by side).  Row strides are padded so
//     that those loads meet no bank conflict.
//   * Resources: at D = 256 the q tile and the split K and V tiles take
//     197 KB of shared memory and O 128 registers a thread, so an SM holds
//     one block.  With 4 warps (one per scheduler) the kernel was bound by
//     the latency of each warp's chain of shared-memory loads, splits and
//     mma (1.25 ms at the f32 check's shape on the card).  So the block has
//     8 warps: the two warps of a 16-row group take the first and the
//     second 16 keys of every tile, each with its own (m, l, O) and no
//     more registers, and merge through shared memory at the end (m =
//     max(m0, m1), O = O0 e^(m0 - m) + O1 e^(m1 - m), likewise l); 1.07 ms,
//     and closer to float64, each O summing half as many mma.  Also: masks
//     only on tiles that straddle the diagonal, the window's edge or sk; O
//     rescaled only when a row max of the warp moved (a factor of 1
//     changes no bit); K/V loaded in batches of whole rows, every load of
//     a batch before its first split.  Unrolling the head-column loop
//     fully, rotating more accumulators or larger load batches ran out of
//     registers and was slower.
//   * Grid: heads vary fastest, so the query heads that read one KV head
//     run together and find its K/V tiles in L2; q tiles are issued last
//     first, the heaviest under a causal mask.
//   * Row invariance: a row's bits depend on its q tile's key band, K/V and
//     sk only -- never on B, the number of q tiles or padding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_tf32x3 {

constexpr int BQ = 64;        // query rows per block, 16 per warp group
constexpr int BKV = 32;       // keys per tile
// warps that share a 16-row group, each taking 32 / KS keys of every tile
constexpr int KS = 2;
constexpr int WARPS = 4 * KS;
constexpr int THREADS = WARPS * 32;
constexpr int JW = BKV / 8 / KS;   // key groups of 8 a warp takes per tile
constexpr int MAX_D = 256;
constexpr float NEG_INF = -1e30f;
constexpr uint32_t TF32_MASK = 0xffffe000u;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  int B, H, G, KH, SQ, SK, sk, D, DP, nqt;
  int SD;   // row stride (words) of q and K in shared memory, 8 mod 16
  int SV;   // row stride (word pairs) of pair-interleaved V, 4 mod 16
  int causal, window;
  float scale;
};

// cvt.rna.tf32.f32 -- round to nearest, ties away from zero, at 10
// mantissa bits, low 13 bits cleared -- on finite x as two integer ops
// (ptxas turns the cvt into an infinity test, the same add and a select)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & TF32_MASK;
}

// x = big + small, both tf32 (the difference is exact in float32)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(__fsub_rn(x, __uint_as_float(big)));
}

__device__ __forceinline__ void split4(float4 x, uint4& big, uint4& small) {
  split(x.x, big.x, small.x);
  split(x.y, big.y, small.y);
  split(x.z, big.z, small.z);
  split(x.w, big.w, small.w);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32: small.big, big.small, big.big
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint2 bb,
                                     uint2 bs) {
  mma(d, as, bb.x, bb.y);
  mma(d, ab, bs.x, bs.y);
  mma(d, ab, bb.x, bb.y);
}

// Key tiles [lo, hi) that query rows [r0, r0 + BQ) need (mirrored by
// kernels/flash_attention/flash_attention.py::key_band).
__device__ __forceinline__ void key_band(const Params& p, int r0, int& lo,
                                         int& hi) {
  hi = (p.sk + BKV - 1) / BKV;
  if (p.causal) hi = min(hi, (r0 + BQ - 1) / BKV + 1);
  lo = p.window > 0 ? max(0, r0 - p.window + 1) / BKV : 0;
}

// Whether any (row, key) of rows [r0, r0 + BQ) x keys [k0, k0 + BKV) is
// masked (flash_attention.py::tile_needs_mask); other tiles skip the masks
// (adding 0 changes no bit).
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int r0,
                                                int k0) {
  return (p.causal && k0 + BKV - 1 > r0) ||
         (p.window > 0 && r0 + BQ - 1 - k0 >= p.window) || k0 + BKV > p.sk;
}

// Shared memory: q [BQ][SD] float32 (times the scale); K big and small
// [BKV][SD]; V big and small [BKV / 2][SV][2] (element (key, col) at
// ((key / 2) * SV + col) * 2 + key % 2).
struct Smem {
  float* q;
  uint32_t* kb;
  uint32_t* ks;
  uint32_t* vb;
  uint32_t* vs;
};

__device__ __forceinline__ Smem carve(float* base, const Params& p) {
  Smem s;
  s.q = base;
  s.kb = reinterpret_cast<uint32_t*>(s.q + BQ * p.SD);
  s.ks = s.kb + BKV * p.SD;
  s.vb = s.ks + BKV * p.SD;
  s.vs = s.vb + BKV * p.SV;
  return s;
}

inline size_t smem_bytes(int SD, int SV) {
  return sizeof(float) * ((size_t)(BQ + 2 * BKV) * SD + (size_t)2 * BKV * SV);
}

// Columns [D, DP) of every row stay zero: they add nothing to the scores
// and their output columns are not stored.
__device__ void zero_pad_columns(const Smem& s, const Params& p) {
  const int pad = p.DP - p.D;
  if (pad == 0) return;
  for (int i = threadIdx.x; i < BQ * pad; i += THREADS)
    s.q[(i / pad) * p.SD + p.D + i % pad] = 0.f;
  for (int i = threadIdx.x; i < BKV * pad; i += THREADS) {
    const int row = i / pad, col = p.D + i % pad;
    s.kb[row * p.SD + col] = s.ks[row * p.SD + col] = 0u;
    const int vi = ((row >> 1) * p.SV + col) * 2 + (row & 1);
    s.vb[vi] = s.vs[vi] = 0u;
  }
}

// q rows [q0, q0 + BQ) of one head, times the scale; warp w takes rows w,
// w + 4, ..., its lanes the row's 16-byte column groups.
__device__ void load_q(const Smem& s, const Params& p, const float* qg,
                       int warp, int lane) {
#pragma unroll 4
  for (int row = warp; row < BQ; row += WARPS) {
    const float* src = qg + (size_t)row * p.D;
    float* dst = s.q + row * p.SD;
    if (p.D % 4 == 0) {
      for (int c = lane; c < p.D / 4; c += 32) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(src) + c);
        *reinterpret_cast<float4*>(dst + 4 * c) = make_float4(
            __fmul_rn(x.x, p.scale), __fmul_rn(x.y, p.scale),
            __fmul_rn(x.z, p.scale), __fmul_rn(x.w, p.scale));
      }
    } else {
      for (int c = lane; c < p.D; c += 32)
        dst[c] = __fmul_rn(__ldg(src + c), p.scale);
    }
  }
}

// K rows (and half as many V row pairs) a warp loads in one batch: larger
// batches spilled O's registers
constexpr int LOAD_BATCH = 2;

// One tile of BKV keys of K and V into shared memory, split into big and
// small words.  Warp w takes K rows w, w + 4, ... and V row pairs w,
// w + 4, ...; its lanes take 16-byte column groups (two each at most, D <=
// 256).  Loads go in batches of LOAD_BATCH rows, every load of a batch
// issued before its first split (a batch is 8 registers a row).
__device__ void load_kv(const Smem& s, const Params& p, const float* kg,
                        const float* vg, int warp, int lane) {
  constexpr int KR = BKV / WARPS;        // K rows per warp
  constexpr int VP = BKV / 2 / WARPS;    // V row pairs per warp
  constexpr int VB = LOAD_BATCH / 2;     // V row pairs per batch
  if (p.D % 4 == 0) {
    const int c4 = p.D / 4;
#pragma unroll 1
    for (int r0 = 0; r0 < KR; r0 += LOAD_BATCH) {
      float4 x[LOAD_BATCH][2];
#pragma unroll
      for (int rr = 0; rr < LOAD_BATCH; ++rr)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int c = lane + 32 * cc;
          if (c < c4) {
            x[rr][cc] = __ldg(reinterpret_cast<const float4*>(
                kg + (size_t)(warp + WARPS * (r0 + rr)) * p.D) + c);
          }
        }
#pragma unroll
      for (int rr = 0; rr < LOAD_BATCH; ++rr)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int c = lane + 32 * cc;
          if (c < c4) {
            uint4 big, small;
            split4(x[rr][cc], big, small);
            const int o = (warp + WARPS * (r0 + rr)) * p.SD + 4 * c;
            *reinterpret_cast<uint4*>(&s.kb[o]) = big;
            *reinterpret_cast<uint4*>(&s.ks[o]) = small;
          }
        }
    }
#pragma unroll 1
    for (int p0 = 0; p0 < VP; p0 += VB) {
      float4 y[VB][2][2];
#pragma unroll
      for (int pp = 0; pp < VB; ++pp)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int c = lane + 32 * cc;
            if (c < c4) {
              y[pp][e][cc] = __ldg(reinterpret_cast<const float4*>(
                  vg + (size_t)(2 * (warp + WARPS * (p0 + pp)) + e) * p.D) +
                  c);
            }
          }
#pragma unroll
      for (int pp = 0; pp < VB; ++pp)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int c = lane + 32 * cc;
          if (c < c4) {
            // keys 2 pr and 2 pr + 1 of columns 4c .. 4c + 3, interleaved
            const float4 r0 = y[pp][0][cc], r1 = y[pp][1][cc];
            uint4 b0, s0, b1, s1;
            split4(make_float4(r0.x, r1.x, r0.y, r1.y), b0, s0);
            split4(make_float4(r0.z, r1.z, r0.w, r1.w), b1, s1);
            const int o = ((warp + WARPS * (p0 + pp)) * p.SV + 4 * c) * 2;
            *reinterpret_cast<uint4*>(&s.vb[o]) = b0;
            *reinterpret_cast<uint4*>(&s.vb[o + 4]) = b1;
            *reinterpret_cast<uint4*>(&s.vs[o]) = s0;
            *reinterpret_cast<uint4*>(&s.vs[o + 4]) = s1;
          }
        }
    }
  } else {
    for (int row = warp; row < BKV; row += WARPS) {
      for (int c = lane; c < p.D; c += 32) {
        uint32_t big, small;
        split(__ldg(kg + (size_t)row * p.D + c), big, small);
        s.kb[row * p.SD + c] = big;
        s.ks[row * p.SD + c] = small;
        split(__ldg(vg + (size_t)row * p.D + c), big, small);
        const int vi = ((row >> 1) * p.SV + c) * 2 + (row & 1);
        s.vb[vi] = big;
        s.vs[vi] = small;
      }
    }
  }
}

// NT: 8-column groups of O a thread's accumulators hold (DP / 8 of them
// are live).
template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
    flash_tf32x3_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), p);
  const int bh = blockIdx.x % (p.B * p.H);
  const int qt = p.nqt - 1 - blockIdx.x / (p.B * p.H);
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * BQ;
  const float* qg = p.q + ((size_t)bh * p.SQ + q0) * p.D;
  const size_t kv0 = ((size_t)b * p.KH + h / p.G) * p.SK * p.D;
  const float* kg = p.k + kv0;
  const float* vg = p.v + kv0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int nt_live = p.DP / 8;
  // this warp's 16 rows and its share of each tile's keys: key groups
  // j0 .. j0 + JW - 1; this thread's rows ra (g) and ra + 8
  const int wr = (warp % 4) * 16;
  const int j0 = (warp / 4) * JW;
  const int ra = q0 + wr + g;

  zero_pad_columns(s, p);
  load_q(s, p, qg, warp, lane);

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  int kt_lo, kt_hi;
  key_band(p, q0, kt_lo, kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();      // the previous tile's readers are done
    load_kv(s, p, kg + (size_t)k0 * p.D, vg + (size_t)k0 * p.D, warp, lane);
    __syncthreads();

    // S = (q * scale) K^T over this warp's 16 rows and its keys: big.big
    // in S, small.big and big.small in lo, added at the end
    float S[JW][4], lo[JW][4];
#pragma unroll
    for (int j = 0; j < JW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[j][e] = lo[j][e] = 0.f;
    const float* qa = s.q + (wr + g) * p.SD + 2 * t;
    const uint32_t* kb = s.kb + (8 * j0 + g) * p.SD + 2 * t;
    const uint32_t* ks = s.ks + (8 * j0 + g) * p.SD + 2 * t;
    for (int kk = 0; kk < nt_live; ++kk) {
      const int c = kk * 8;
      const float2 x0 = *reinterpret_cast<const float2*>(qa + c);
      const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * p.SD + c);
      uint32_t ab[4], as[4];
      split(x0.x, ab[0], as[0]);   // (row g, position t)
      split(x1.x, ab[1], as[1]);   // (row g + 8, t)
      split(x0.y, ab[2], as[2]);   // (row g, t + 4)
      split(x1.y, ab[3], as[3]);   // (row g + 8, t + 4)
#pragma unroll
      for (int j = 0; j < JW; ++j) {
        const int off = j * 8 * p.SD + c;
        const uint2 bb = *reinterpret_cast<const uint2*>(kb + off);
        const uint2 bs = *reinterpret_cast<const uint2*>(ks + off);
        mma(lo[j], as, bb.x, bb.y);
        mma(lo[j], ab, bs.x, bs.y);
        mma(S[j], ab, bb.x, bb.y);
      }
    }
#pragma unroll
    for (int j = 0; j < JW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[j][e] += lo[j][e];

    // masks (on tiles that need them) and the online softmax; S[j][e] is
    // row ra + 8 * (e / 2), key k0 + 8 (j0 + j) + 2 t + e % 2
    float mx[2] = {NEG_INF, NEG_INF};
    const bool masked = tile_needs_mask(p, q0, k0);
#pragma unroll
    for (int j = 0; j < JW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (masked) {
          const int kpos = k0 + 8 * (j0 + j) + 2 * t + (e & 1);
          const int delta = ra + 8 * (e >> 1) - kpos;
          float mask = 0.f;
          if (p.causal && delta < 0) mask = NEG_INF;
          if (p.window > 0 && delta >= p.window) mask = NEG_INF;
          if (kpos >= p.sk) mask = NEG_INF;
          S[j][e] += mask;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], S[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < JW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        S[j][e] = expf(S[j][e] - m[e >> 1]);
        sum[e >> 1] += S[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
    // O *= corr, unless no row max of the warp moved (a factor of 1 changes
    // no bit)
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
    }

    // O += P V: P's k positions t, t + 4 are keys 2t, 2t + 1 of each group
    // of 8, so S's accumulator is the A fragment; V's B fragment is the
    // key pair (2t, 2t + 1) of column 8 n + g, one 8-byte word pair
#pragma unroll
    for (int j = 0; j < JW; ++j) {
      uint32_t pb[4], ps[4];
      split(S[j][0], pb[0], ps[0]);   // (row g, key 2t)
      split(S[j][2], pb[1], ps[1]);   // (row g + 8, key 2t)
      split(S[j][1], pb[2], ps[2]);   // (row g, key 2t + 1)
      split(S[j][3], pb[3], ps[3]);   // (row g + 8, key 2t + 1)
      const int vrow = ((4 * (j0 + j) + t) * p.SV + g) * 2;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < nt_live) {
          mma3(o[n], pb, ps,
               *reinterpret_cast<const uint2*>(s.vb + vrow + n * 16),
               *reinterpret_cast<const uint2*>(s.vs + vrow + n * 16));
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {   // l over the row's four threads
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* og = p.out + ((size_t)bh * p.SQ + ra) * p.D;
  if constexpr (KS == 2) {
    // the second key half's (m, l, O) through shared memory (the K/V
    // tiles' space), merged into the first's: m = max(m0, m1),
    // O = O0 e^(m0 - m) + O1 e^(m1 - m), likewise l
    float* mo = reinterpret_cast<float*>(s.kb);
    float* mm = mo + BQ * p.DP;
    float* ml = mm + BQ;
    __syncthreads();
    if (j0 != 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < nt_live) {
          const int col = n * 8 + 2 * t;
          *reinterpret_cast<float2*>(&mo[(wr + g) * p.DP + col]) =
              make_float2(o[n][0], o[n][1]);
          *reinterpret_cast<float2*>(&mo[(wr + g + 8) * p.DP + col]) =
              make_float2(o[n][2], o[n][3]);
        }
      }
      if (t == 0) {
        mm[wr + g] = m[0];
        mm[wr + g + 8] = m[1];
        ml[wr + g] = l[0];
        ml[wr + g + 8] = l[1];
      }
    }
    __syncthreads();
    if (j0 != 0) return;
    float c0[2], c1[2], den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wr + g + 8 * r;
      const float m1 = mm[row];
      const float mx = fmaxf(m[r], m1);
      c0[r] = expf(m[r] - mx);
      c1[r] = expf(m1 - mx);
      den[r] = fmaxf(l[r] * c0[r] + ml[row] * c1[r], 1e-30f);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n < nt_live) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = n * 8 + 2 * t + (e & 1);
          const float o1 = mo[(wr + g + 8 * r) * p.DP + c];
          if (c < p.D) {
            og[(size_t)(8 * r) * p.D + c] =
                fmaf(o[n][e], c0[r], o1 * c1[r]) / den[r];
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n < nt_live) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);
          if (c < p.D) {
            og[(size_t)(8 * (e >> 1)) * p.D + c] =
                o[n][e] / fmaxf(l[e >> 1], 1e-30f);
          }
        }
      }
    }
  }
}

template <int NT>
int launch(const Params& p, cudaStream_t st) {
  const size_t bytes = smem_bytes(p.SD, p.SV);
  auto kern = flash_tf32x3_kernel<NT>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(p.B * p.H * p.nqt), dim3(THREADS), bytes, st>>>(p);
  return (int)cudaGetLastError();
}

// The variant's entry: float32, D <= 256, SQ % BQ == 0, SK % BKV == 0;
// cudaErrorInvalidValue for any other shape.
inline int dispatch(const void* q, const void* k, const void* v, void* out,
                    int B, int H, int KH, int SQ, int SK, int sk, int D,
                    int causal, int window, float scale, int elem_bytes,
                    cudaStream_t st) {
  if (elem_bytes != 4 || D <= 0 || D > MAX_D || SQ % BQ || SK % BKV)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(out);
  p.B = B;
  p.H = H;
  p.G = H / KH;
  p.KH = KH;
  p.SQ = SQ;
  p.SK = SK;
  p.sk = sk;
  p.D = D;
  p.DP = (D + 7) / 8 * 8;
  p.nqt = SQ / BQ;
  p.SD = p.DP % 16 == 8 ? p.DP : p.DP + 8;
  p.SV = p.DP % 16 == 0 ? p.DP + 4 : p.DP + 12;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  if (p.DP <= 32) return launch<4>(p, st);
  if (p.DP <= 128) return launch<16>(p, st);
  return launch<32>(p, st);
}

}  // namespace flash_tf32x3
