// K7, the tensor-core variant: forward flash attention for prefill in bf16
// on Hopper's warpgroup MMA (wgmma), fed by a TMA ring, warp-specialised.
//
// Replaces, with flash_prefill.cu's SIMT variant, the TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (flash_attention.py:74, pallas_call at :85) for bf16 q/k/v whose head_dim
// is a multiple of 16 up to 256 (flash_attention.py::pick_variant).  It
// computes what the Pallas body computes: float32 scores with the additive
// -1e30 masks (j > i under causal, i - j >= window for window > 0, j >= sk),
// an online softmax (m, l, acc) and out = acc / max(l, 1e-30) in bf16; head
// h reads KV head h / G.
//
// What bounds it on the H100: operations.  The two products take 4 * D
// flops per (query, key) pair in the band -- 2.06e11 at recurrentgemma-9b's
// prefill cell, 0.209 ms at the bf16 tensor-core peak (989 TFLOP/s) against
// 0.05 ms for the bytes -- and the SIMT variant ran them on the float32 CUDA
// cores (67 TFLOP/s) from float32 copies in shared memory.  The design:
//   * Both products run on the tensor cores, accumulating in float32:
//     S = Q K^T as wgmma m64n64k16 with both operands in shared memory,
//     K-major; O += P V with P rounded to bf16 in registers (the S
//     accumulator's fragment is the A fragment's layout, so P never touches
//     shared memory) and V read from shared memory as a transposed
//     (MN-major) B -- one m64n256k16 per 16 keys at D = 256, m64n64k16 per
//     64 columns otherwise.
//   * Tiles: 128 query rows per block, two warpgroups of 64 rows, 64 keys
//     per tile.  The head dimension is cut into 64-column chunks of 128
//     bytes per row, the 128-byte swizzle's width; a partial last chunk is
//     zero-filled by the TMA (zero columns add nothing to the scores and
//     their output columns are not stored).  Shared memory at D = 256: the
//     q tile 64 KB and two stages of K (32 KB) and V (32 KB) -- 192 KB, one
//     block per SM.
//   * Registers: a thread holds 128 floats of O (64 x 256 per warpgroup),
//     32 of S and 16 words of P; the kernel takes 202 registers and does
//     not spill.  That is why the block has no producer warp: with 9 or 12
//     warps the register file (split over four sub-partitions) allows 168
//     registers a thread, and ptxas 12.9 compiled the consumers within
//     that even after setmaxnreg.inc -- they spilled and their wgmmas were
//     serialized (0.80-0.94 ms at the cell against 0.49 with 8 warps).
//   * Loads: TMA, one thread per load, into a two-stage ring of K/V tiles
//     with a "full" mbarrier per stage for K and for V (S can start before
//     V has landed).  Thread 0 loads Q and the first two tiles; after that
//     the last of the eight warps to finish with a stage (a shared-memory
//     counter) loads the tile two ahead into it.  The tensor maps are
//     encoded on the host at each call (cuTensorMapEncodeTiled through the
//     runtime's driver entry point, no -lcuda) and passed as
//     __grid_constant__ parameters.
//   * Softmax in float32 with exp2: log2(e) and the scale are one multiply
//     of the S accumulator.  The scale is applied after the product, not to
//     q when it is staged: q lands in shared memory by TMA untouched, and
//     the product of bf16 values summed in float32 and then scaled differs
//     from the plain version's (q * scale) . k only by rounding for any
//     scale (at the model's power-of-two 1/16 not even that), short of a
//     float32 overflow of q . k itself that prefill's finite activations do
//     not reach; chip_smoke.py's K7 gate holds the NaN/Inf pattern to the
//     plain version's.
//   * Masks are applied only on key tiles that straddle the diagonal, the
//     window's lower edge or sk; interior tiles skip them.  Each warpgroup
//     visits only the key tiles its own 64 rows need (the block loads the
//     union).  Tiles outside a row's band are skipped as in the SIMT
//     variant (flash_prefill.cu explains why that is exact on finite K/V),
//     and a row whose every key is masked is written as 0.
//   * Grid: heads vary fastest, so the query heads that read one KV head run
//     together and find its K/V tiles in L2; q tiles are issued last first,
//     the heaviest under a causal mask.
//   * Row invariance: a row's bits depend on its 64-row group's key tiles,
//     K/V and sk only -- never on B, the number of q tiles or padding; keys
//     are never split across blocks.  l is summed per thread in tile order
//     and across the row's four threads at the end, the same way for every
//     row.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_wgmma {

constexpr int BQ = 128;         // query rows per block
constexpr int BKV = 64;         // keys per tile
constexpr int GROUP_ROWS = 64;  // query rows per warpgroup
constexpr int STAGES = 2;
constexpr int THREADS = 256;    // two warpgroups
constexpr int CHUNK = 64;       // head columns per 128-byte swizzled row
constexpr int ROW_BYTES = 128;
constexpr int MAX_D = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

struct Params {
  int B, H, G, KH, SQ, SK, sk, D, nqt;
  int causal, window;
  float scale_log2;  // scale * log2(e)
};

// Shared-memory layout (byte offsets from a 1024-byte aligned base; the
// 128-byte swizzle repeats every 1024 bytes).  Each K or V tile is NCH
// chunks of 64 rows x 128 bytes; the q tile NCH chunks of 128 rows.
template <int NCH>
struct Layout {
  static constexpr int Q_CHUNK = BQ * ROW_BYTES;
  static constexpr int KV_CHUNK = BKV * ROW_BYTES;
  static constexpr int KV_TILE = NCH * KV_CHUNK;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + NCH * Q_CHUNK;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_TILE;
  // barriers q, full_k[STAGES] and full_v[STAGES]; counters released[STAGES]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 4 * STAGES +
                               1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  sbo: bytes between
// 8-row groups; lbo: K-major, unused (a k16 step stays inside one 128-byte
// row); MN-major, bytes between 64-column blocks of N.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous MMA's issue and wait.
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FLASH_WGMMA_D32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"
#define FLASH_WGMMA_OUT32(d)                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

// d (64 x 64, f32) = a (64 x 16) * b (16 x 64) + (accumulate ? d : 0); a
// and b bf16 in shared memory, both K-major.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FLASH_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += a (64 x 16, bf16 pairs in registers) * b (16 x 64,
// bf16 in shared memory, MN-major).
__device__ __forceinline__ void mma_rs_mn(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FLASH_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#define FLASH_WGMMA_D128                                                     \
  "{"                                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "  \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "  \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "  \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "  \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "  \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "  \
  "%127}"
#define FLASH_WGMMA_OUT128(d)                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),  \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),  \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),  \
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),  \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),  \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),  \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),  \
      "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),  \
      "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),  \
      "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),  \
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),  \
      "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),  \
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),  \
      "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),  \
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),  \
      "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),  \
      "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),  \
      "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),  \
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),  \
      "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d (64 x 256, f32) += a (64 x 16, bf16 pairs in registers) * b (16 x 256,
// bf16 in shared memory, MN-major, its 64-column blocks 8 KB apart).
__device__ __forceinline__ void mma_rs_mn256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " FLASH_WGMMA_D128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : FLASH_WGMMA_OUT128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef FLASH_WGMMA_D32
#undef FLASH_WGMMA_OUT32
#undef FLASH_WGMMA_D128
#undef FLASH_WGMMA_OUT128

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Key tiles [lo, hi) that query rows [r0, r0 + rows) need (mirrored by
// kernels/flash_attention/flash_attention.py::key_band).
__device__ __forceinline__ void key_band(const Params& p, int r0, int rows,
                                         int& lo, int& hi) {
  hi = (p.sk + BKV - 1) / BKV;
  if (p.causal) hi = min(hi, (r0 + rows - 1) / BKV + 1);
  lo = p.window > 0 ? max(0, r0 - p.window + 1) / BKV : 0;
}

// Whether any (row, key) of rows [r0, r0 + rows) x keys [k0, k0 + BKV) is
// masked (mirrored by flash_attention.py::tile_needs_mask).
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int r0,
                                                int rows, int k0) {
  return (p.causal && k0 + BKV - 1 > r0) ||
         (p.window > 0 && r0 + rows - 1 - k0 >= p.window) ||
         k0 + BKV > p.sk;
}

template <int NCH>
__global__ void __launch_bounds__(THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ out, const Params p) {
  using L = Layout<NCH>;
  extern __shared__ __align__(1024) uint8_t flash_wgmma_smem[];
  const uint32_t raw = smem_u32(flash_wgmma_smem);
  uint8_t* const aligned = flash_wgmma_smem + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t base = smem_u32(aligned);
  const uint32_t sQ = base + L::Q_OFF, sK = base + L::K_OFF,
                 sV = base + L::V_OFF;
  const uint32_t bar_q = base + L::BAR_OFF;
  auto full_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
  // per stage, the warps that have released it (8 per use)
  uint32_t* const released =
      reinterpret_cast<uint32_t*>(aligned + L::BAR_OFF + 8 * (1 + 2 * STAGES));

  // block -> (q tile, batch, head): heads fastest, the last q tile first
  const int idx = blockIdx.x;
  const int h = idx % p.H;
  const int b = (idx / p.H) % p.B;
  const int qt = p.nqt - 1 - idx / (p.H * p.B);
  const int q0 = qt * BQ;
  int lo, hi;
  key_band(p, q0, BQ, lo, hi);
  const int n_tiles = max(0, hi - lo);
  const int krow = (b * p.KH + h / p.G) * p.SK + lo * BKV;

  // K and V of the block's i-th key tile into stage i % STAGES
  auto load_tile = [&](int i) {
    const int s = i % STAGES;
    const int row = krow + i * BKV;
    mbar_expect_tx(full_k(s), L::KV_TILE);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      tma_load(sK + s * L::KV_TILE + c * L::KV_CHUNK, &tk, full_k(s),
               c * CHUNK, row);
    mbar_expect_tx(full_v(s), L::KV_TILE);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      tma_load(sV + s * L::KV_TILE + c * L::KV_CHUNK, &tv, full_v(s),
               c * CHUNK, row);
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, NCH * L::Q_CHUNK);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      tma_load(sQ + c * L::Q_CHUNK, &tq, bar_q, c * CHUNK,
               (b * p.H + h) * p.SQ + q0);
    for (int i = 0; i < STAGES && i < n_tiles; ++i) load_tile(i);
  }
  // Two warpgroups of 64 query rows each: per key tile, S = Q K^T on the
  // tensor cores, the online softmax in registers, then O += P V.
  const int cw = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int ct = tid % 128;
  const int warp = ct / 32, lane = ct % 32;
  const int r0 = q0 + cw * GROUP_ROWS;
  int my_lo, my_hi;
  key_band(p, r0, GROUP_ROWS, my_lo, my_hi);
  // this thread's rows of the accumulators: row_a and row_a + 8; columns
  // 8 * j + col_a and + 1 for j = 0..7
  const int row_a = r0 + 16 * warp + lane / 4;
  const int col_a = 2 * (lane % 4);

  float o[NCH][32];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const uint32_t q_base = sQ + cw * GROUP_ROWS * ROW_BYTES;
  mbar_wait(bar_q, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const uint32_t parity = (i / STAGES) & 1;
    const int kt = lo + i;
    const bool active = kt >= my_lo && kt < my_hi;
    const uint32_t k_base = sK + s * L::KV_TILE;
    const uint32_t v_base = sV + s * L::KV_TILE;

    float sc[32];
    mbar_wait(full_k(s), parity);
    if (active) {
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      pin(sc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int kk = 0; kk < CHUNK / 16; ++kk)
          mma_ss(sc,
                 sw128_desc(q_base + c * L::Q_CHUNK + kk * 32, 16, 1024),
                 sw128_desc(k_base + c * L::KV_CHUNK + kk * 32, 16, 1024),
                 (c | kk) != 0);
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);
    }
    mbar_wait(full_v(s), parity);
    if (active) {
      const int k0 = kt * BKV;
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] *= p.scale_log2;
      if (tile_needs_mask(p, r0, GROUP_ROWS, k0)) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int row = row_a + ((e & 2) ? 8 : 0);
          const int key = k0 + 8 * (e / 4) + col_a + (e & 1);
          const int delta = row - key;
          if ((p.causal && delta < 0) ||
              (p.window > 0 && delta >= p.window) || key >= p.sk)
            sc[e] += NEG_INF;
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mx = fmaxf(mx, sc[4 * j + 2 * r]);
          mx = fmaxf(mx, sc[4 * j + 2 * r + 1]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        corr[r] = fast_exp2(m[r] - mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sc[4 * j + 2 * r] = fast_exp2(sc[4 * j + 2 * r] - mx);
          sc[4 * j + 2 * r + 1] = fast_exp2(sc[4 * j + 2 * r + 1] - mx);
          sum += sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
        }
        l[r] = l[r] * corr[r] + sum;
        m[r] = mx;
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[c][e] *= corr[(e >> 1) & 1];
      // P as the A operand: k16 slice j holds S columns 16j..16j+15
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pa[j][0] = pack_bf16(sc[8 * j + 0], sc[8 * j + 1]);
        pa[j][1] = pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
        pa[j][2] = pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
        pa[j][3] = pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c) pin(o[c]);
      wgmma_fence();
      if constexpr (NCH == 4) {
        // the whole head in one m64n256k16 per 16 keys
#pragma unroll
        for (int j = 0; j < BKV / 16; ++j)
          mma_rs_mn256(reinterpret_cast<float(&)[128]>(o), pa[j],
                       sw128_desc(v_base + j * 16 * ROW_BYTES, L::KV_CHUNK,
                                  1024));
      } else {
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int j = 0; j < BKV / 16; ++j)
            mma_rs_mn(o[c], pa[j],
                      sw128_desc(v_base + c * L::KV_CHUNK +
                                     j * 16 * ROW_BYTES,
                                 L::KV_CHUNK, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NCH; ++c) pin(o[c]);
    }
    // The last of the eight warps to release the stage refills it with
    // the tile two ahead: every warp's products on it have completed.
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      const uint32_t n = atomicAdd(&released[s], 1u);
      if (n % WARPS == WARPS - 1 && i + STAGES < n_tiles) {
        __threadfence_block();
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        load_tile(i + STAGES);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* og = out + ((size_t)(b * p.H + h) * p.SQ) * p.D;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * CHUNK + 8 * j + col_a;
      if (col < p.D) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const __nv_bfloat162 v2 = __floats2bfloat162_rn(
              o[c][4 * j + 2 * r] / l[r], o[c][4 * j + 2 * r + 1] / l[r]);
          *reinterpret_cast<__nv_bfloat162*>(
              og + (size_t)(row_a + 8 * r) * p.D + col) = v2;
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A row-major (rows, D) bf16 matrix as 64-column x box_rows boxes, 128-byte
// swizzle; columns past D read as zero.
inline bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int D,
                   long long rows, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)CHUNK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NCH>
int launch(const void* q, const void* k, const void* v, void* out,
           const Params& p, cudaStream_t st) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, q, p.D, (long long)p.B * p.H * p.SQ, BQ) ||
      !encode(fn, &tk, k, p.D, (long long)p.B * p.KH * p.SK, BKV) ||
      !encode(fn, &tv, v, p.D, (long long)p.B * p.KH * p.SK, BKV))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_wgmma_kernel<NCH>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<NCH>::BYTES);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(p.B * p.H * p.nqt), dim3(THREADS), Layout<NCH>::BYTES, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), p);
  return (int)cudaGetLastError();
}

// The variant's entry: bf16, D % 16 == 0 and D <= 256, SQ % BQ == 0,
// SK % BKV == 0; cudaErrorInvalidValue for any other shape.
inline int dispatch(const void* q, const void* k, const void* v, void* out,
                    int B, int H, int KH, int SQ, int SK, int sk, int D,
                    int causal, int window, float scale, int elem_bytes,
                    cudaStream_t st) {
  if (elem_bytes != 2 || D <= 0 || D % 16 || D > MAX_D || SQ % BQ ||
      SK % BKV)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.B = B;
  p.H = H;
  p.G = H / KH;
  p.KH = KH;
  p.SQ = SQ;
  p.SK = SK;
  p.sk = sk;
  p.D = D;
  p.nqt = SQ / BQ;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * 1.4426950408889634f;
  switch ((D + CHUNK - 1) / CHUNK) {
    case 1: return launch<1>(q, k, v, out, p, st);
    case 2: return launch<2>(q, k, v, out, p, st);
    case 3: return launch<3>(q, k, v, out, p, st);
    default: return launch<4>(q, k, v, out, p, st);
  }
}

}  // namespace flash_wgmma
