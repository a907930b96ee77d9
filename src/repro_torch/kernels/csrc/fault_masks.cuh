// Shared stuck-at fault mask math for every injection kernel of the port.
//
// One source of truth on the device: the arena bitflip kernel (K1), the
// arena ECC kernel (K2), the decode-attention kernels (K3, K4) and the
// per-segment injectors (K5, K6) all include this header, so read-path
// corruption inside attention applies exactly the bits the write path
// applies to the stored cache, and a segment equals the arena over the
// same words.  It is the CUDA form of the reference's mask builders
// (repro/core/hashing.py, repro/kernels/bitflip/ref.py,
// repro/kernels/ecc/ref.py) and of the port's plain PyTorch versions
// (repro_torch/kernels/bitflip/ref.py and repro_torch/kernels/ecc/ref.py),
// which the CPU tests hold bit-exact against the reference.
#pragma once
#include <stdint.h>

namespace fm {

constexpr uint32_t STREAM_WORD_01 = 0x9E3779B1u;
constexpr uint32_t STREAM_WORD_10 = 0x85EBCA77u;
constexpr uint32_t STREAM_BITPOS_01 = 0xC2B2AE3Du;
constexpr uint32_t STREAM_BITPOS_10 = 0x27D4EB2Fu;
constexpr uint32_t STREAM_ROW = 0x165667B1u;
constexpr uint32_t STREAM_BITPLANE = 0xD3A2646Cu;
constexpr uint32_t STREAM_PARITY = 0x94D049BBu;
constexpr int PLANES = 20;

// Threshold-table columns (repro_torch/core/faultmap.py).
constexpr int COL_Q01_WEAK = 0;
constexpr int COL_Q01_STRONG = 1;
constexpr int COL_Q10_WEAK = 2;
constexpr int COL_Q10_STRONG = 3;
constexpr int COL_WEAK_ROW_Q = 4;
constexpr int COL_T01_WEAK = 5;
constexpr int COL_T01_STRONG = 6;
constexpr int COL_T10_WEAK = 7;
constexpr int COL_T10_STRONG = 8;
constexpr int COL_PAR_Q_WEAK = 9;
constexpr int COL_PAR_Q_STRONG = 10;
constexpr int NUM_THR_COLS = 11;

// Injection methods (kernel template arguments).
constexpr int METHOD_WORD = 0;
constexpr int METHOD_BITWISE = 1;
constexpr int METHOD_ECC = 2;

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// hash_stream(seed, stream, counter) == mix32(counter ^ mix32(seed ^ stream));
// the inner value depends only on (seed, stream) and is computed once.
struct Streams {
  uint32_t row, w01, w10, p01, p10, par;
};

__device__ __forceinline__ Streams make_streams(uint32_t seed) {
  Streams s;
  s.row = mix32(seed ^ STREAM_ROW);
  s.w01 = mix32(seed ^ STREAM_WORD_01);
  s.w10 = mix32(seed ^ STREAM_WORD_10);
  s.p01 = mix32(seed ^ STREAM_BITPOS_01);
  s.p10 = mix32(seed ^ STREAM_BITPOS_10);
  s.par = mix32(seed ^ STREAM_PARITY);
  return s;
}

// Inner value of bit-plane j for direction dir (0: stuck-at-1, 1: stuck-at-0):
// plane seed mix32(seed ^ (2j + dir + 1)), stream STREAM_BITPLANE.
// Index i = 2 * j + dir.
__device__ __forceinline__ uint32_t plane_inner(uint32_t seed, int i) {
  uint32_t plane_seed = mix32(seed ^ (uint32_t)(i + 1));
  return mix32(plane_seed ^ STREAM_BITPLANE);
}

// Fills planes[0 .. 2*PLANES) in shared memory; call from every thread,
// then __syncthreads() before use.
__device__ __forceinline__ void fill_plane_inners(uint32_t* planes,
                                                  uint32_t seed) {
  for (int i = threadIdx.x; i < 2 * PLANES; i += blockDim.x)
    planes[i] = plane_inner(seed, i);
}

// One threshold-table row, held in registers.
struct Thr {
  uint32_t c[NUM_THR_COLS];
};

__device__ __forceinline__ Thr load_thr(const uint32_t* row) {
  Thr t;
#pragma unroll
  for (int i = 0; i < NUM_THR_COLS; ++i) t.c[i] = row[i];
  return t;
}

__device__ __forceinline__ Thr zero_thr() {
  Thr t;
#pragma unroll
  for (int i = 0; i < NUM_THR_COLS; ++i) t.c[i] = 0u;
  return t;
}

__device__ __forceinline__ bool weak_row(uint32_t wid, const Streams& s,
                                         const Thr& t, int wprl2) {
  return mix32((wid >> wprl2) ^ s.row) < t.c[COL_WEAK_ROW_Q];
}

// Word-hit fast path: a hit word gets one stuck bit at a hashed position.
__device__ __forceinline__ void word_masks(uint32_t wid, const Streams& s,
                                           const Thr& t, int wprl2,
                                           uint32_t& m01, uint32_t& m10) {
  const bool weak = weak_row(wid, s, t, wprl2);
  const uint32_t q01 = weak ? t.c[COL_Q01_WEAK] : t.c[COL_Q01_STRONG];
  const uint32_t q10 = weak ? t.c[COL_Q10_WEAK] : t.c[COL_Q10_STRONG];
  const bool hit01 = mix32(wid ^ s.w01) < q01;
  const bool hit10 = mix32(wid ^ s.w10) < q10;
  const uint32_t pos01 = mix32(wid ^ s.p01) & 31u;
  const uint32_t pos10 = mix32(wid ^ s.p10) & 31u;
  m01 = hit01 ? (1u << pos01) : 0u;
  m10 = hit10 ? (1u << pos10) : 0u;
}

// Bit-sliced per-lane compare: each lane's PLANES-bit uniform < t.
// inner points at this direction's plane inners with stride 2.
__device__ __forceinline__ uint32_t bitwise_lt(uint32_t wid,
                                               const uint32_t* inner,
                                               uint32_t t) {
  uint32_t lt = 0u, eq = 0xFFFFFFFFu;
#pragma unroll
  for (int j = PLANES - 1; j >= 0; --j) {
    const uint32_t tmask = 0u - ((t >> j) & 1u);
    const uint32_t b = mix32(wid ^ inner[2 * j]);
    lt |= eq & ~b & tmask;
    eq &= b ^ ~tmask;
  }
  return lt;
}

// Exact per-bit Bernoulli masks at PLANES-bit probability resolution.
__device__ __forceinline__ void bitwise_masks(uint32_t wid, const Streams& s,
                                              const uint32_t* planes,
                                              const Thr& t, int wprl2,
                                              uint32_t& m01, uint32_t& m10) {
  const bool weak = weak_row(wid, s, t, wprl2);
  m01 = bitwise_lt(wid, planes + 0,
                   weak ? t.c[COL_T01_WEAK] : t.c[COL_T01_STRONG]);
  m10 = bitwise_lt(wid, planes + 1,
                   weak ? t.c[COL_T10_WEAK] : t.c[COL_T10_STRONG]);
}

// (x | m01) & ~(m10 & ~m01): a doubly-selected bit sticks at 1.
template <int METHOD>
__device__ __forceinline__ uint32_t apply_masks(uint32_t x, uint32_t wid,
                                                const Streams& s,
                                                const uint32_t* planes,
                                                const Thr& t, int wprl2) {
  uint32_t m01, m10;
  if (METHOD == METHOD_BITWISE)
    bitwise_masks(wid, s, planes, t, wprl2, m01, m10);
  else
    word_masks(wid, s, t, wprl2, m01, m10);
  m10 &= ~m01;
  return (x | m01) & ~m10;
}

// SECDED(72,64) behavioural model on one codeword (two adjacent words at
// physical ids w0, w0 + 1, one table row): 0 faults -> unchanged, 1 fault
// (data or the one parity draw) -> corrected, >= 2 -> faulted data passes.
__device__ __forceinline__ void ecc_codeword(uint32_t& x0, uint32_t& x1,
                                             uint32_t w0, const Streams& s,
                                             const Thr& t, int wprl2,
                                             int& corrected,
                                             int& uncorrectable) {
  uint32_t a01, a10, b01, b10;
  word_masks(w0, s, t, wprl2, a01, a10);
  word_masks(w0 + 1u, s, t, wprl2, b01, b10);
  a10 &= ~a01;
  b10 &= ~b01;
  const uint32_t f0 = (x0 | a01) & ~a10;
  const uint32_t f1 = (x1 | b01) & ~b10;
  uint32_t count = __popc(f0 ^ x0) + __popc(f1 ^ x1);
  const bool weak = weak_row(w0, s, t, wprl2);
  const uint32_t q = weak ? t.c[COL_PAR_Q_WEAK] : t.c[COL_PAR_Q_STRONG];
  count += (mix32((w0 >> 1) ^ s.par) < q) ? 1u : 0u;
  corrected = count == 1u;
  uncorrectable = count >= 2u;
  if (uncorrectable) {
    x0 = f0;
    x1 = f1;
  }
}

}  // namespace fm
