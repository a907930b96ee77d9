// K7: forward flash attention for prefill (causal / window masks, GQA).
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas (pallas_call at flash_attention.py:85).  q is
// (B, H, SQ, D), k and v are (B, KH, SK, D), all contiguous, SQ a multiple
// of BQ and SK a multiple of BKV (kernels/flash_attention/ops.py pads);
// query row i and key j sit at positions i and j.  Head h reads KV head
// h / G.  Scores are float32 with the Pallas body's additive masks
// (-1e30 where j > i under causal, where i - j >= window for window > 0,
// and where j >= sk, the true key count), an online softmax (running max
// m, sum l, accumulator acc) and out = acc / max(l, 1e-30) in v's type.
//
// What bounds it on the H100: the two products, 4 * (query, key) pairs *
// D flops, run here on the float32 CUDA cores (67 TFLOP/s), far from the
// bf16 tensor cores (989 TFLOP/s) the bound is taken against; the bytes
// (q, k, v, out once each) are a small share.  Design, simple first: one
// block of 256 threads per (batch * head, tile of BQ = 64 query rows).
// The q tile is staged once in shared memory, transposed and scaled; K/V
// tiles of BKV = 64 keys stream through shared memory (K transposed, V
// row-major, both float32).  Each thread owns a 4 x 4 register tile of
// the scores and the matching 4 rows x up to 64 columns of acc, so every
// shared-memory load is a 16-byte vector feeding 4 or 16 fused
// multiply-adds; the row max and sum reduce across the 16 threads of a
// row with warp shuffles.  Global loads are 16 bytes a thread when a row
// fills whole 16-byte vectors, element by element otherwise (so any
// head_dim up to 256 runs, the reduced configs' 12 included).
//
// Tiles outside the band of a q tile (keys after its last row under
// causal, keys at least `window` before its first row, keys past sk) are
// skipped.  In the Pallas body such a tile scores -1e30 for every entry:
// before the band it adds finite garbage to acc and l that the first
// in-band tile multiplies by exp(-1e30 - m) = 0, after the band it adds
// exact zeros.  So on finite K/V, which is what prefill hands it (faults
// are written after prefill), skipping gives the same result.  A row
// whose every key is masked (only padded rows, cut off by ops.py) is
// written as 0 instead of the mean of V.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 256;
constexpr int MAX_D = 256;
constexpr int NI = MAX_D / 64;  // 16-byte column groups of acc per thread
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int H, G, SQ, SK, sk, D, DP;
  int causal, window;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16(x);
}

// VEC consecutive elements at p as floats (one 16-byte load when VEC
// elements fill 16 bytes).
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float* out) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f(p[i]);
  }
}

// rows [r0, r0 + 64) of a row-major (rows, D) matrix -> dst[d * 64 + row],
// times mul; neighbouring threads take neighbouring rows.
template <typename T, int VEC>
__device__ __forceinline__ void load_transposed(const T* __restrict__ src,
                                                float* dst, int D,
                                                float mul) {
  const int chunks = D / VEC;
  for (int c = threadIdx.x; c < 64 * chunks; c += THREADS) {
    const int row = c % 64, ch = c / 64;
    float x[VEC];
    load_vec<T, VEC>(src + (size_t)row * D + ch * VEC, x);
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[(ch * VEC + e) * 64 + row] = x[e] * mul;
  }
}

// rows [r0, r0 + 64) of a row-major (rows, D) matrix -> dst[row * DP + d];
// neighbouring threads take neighbouring column chunks.
template <typename T, int VEC>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          float* dst, int D, int DP) {
  const int chunks = D / VEC;
  for (int c = threadIdx.x; c < 64 * chunks; c += THREADS) {
    const int ch = c % chunks, row = c / chunks;
    float x[VEC];
    load_vec<T, VEC>(src + (size_t)row * D + ch * VEC, x);
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[row * DP + ch * VEC + e] = x[e];
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    flash_prefill_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = p.D, DP = p.DP;
  float* Qs = smem;                 // [D][BQ], q * scale
  float* Ks = Qs + D * BQ;          // [D][BKV]
  float* Vs = Ks + D * BKV;          // [BKV][DP], columns D..DP-1 zero
  float* Pt = Vs + BKV * DP;        // [BKV][BQ], probabilities

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kh = h / p.G;
  const int KH = p.H / p.G;
  const int q0 = blockIdx.x * BQ;
  const T* qg = static_cast<const T*>(p.q) + ((size_t)bh * p.SQ + q0) * D;
  const T* kg = static_cast<const T*>(p.k) + ((size_t)b * KH + kh) * p.SK * D;
  const T* vg = static_cast<const T*>(p.v) + ((size_t)b * KH + kh) * p.SK * D;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty*4.., keys tx*4..

  load_transposed<T, VEC>(qg, Qs, D, p.scale);
  for (int i = tid; i < BKV * (DP - D); i += THREADS) {
    Vs[(i / (DP - D)) * DP + D + i % (DP - D)] = 0.f;
  }

  float acc[4][NI][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][i][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.f;
  }

  // the band of key tiles this q tile needs
  int kt_end = (p.sk + BKV - 1) / BKV;
  if (p.causal) kt_end = min(kt_end, (q0 + BQ - 1) / BKV + 1);
  int kt_begin = 0;
  if (p.window > 0) kt_begin = max(0, q0 - p.window + 1) / BKV;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BKV;
    load_transposed<T, VEC>(kg + (size_t)k0 * D, Ks, D, 1.f);
    load_rows<T, VEC>(vg + (size_t)k0 * D, Vs, D, DP);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[d * BQ + ty * 4]);
      const float4 kv = *reinterpret_cast<const float4*>(&Ks[d * BKV + tx * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float kc[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
    }

    float corr[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + ty * 4 + a;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx * 4 + c;
        const int delta = qpos - kpos;
        float mask = 0.f;
        if (p.causal && delta < 0) mask = NEG_INF;
        if (p.window > 0 && delta >= p.window) mask = NEG_INF;
        if (kpos >= p.sk) mask = NEG_INF;
        s[a][c] += mask;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = expf(s[a][c] - m_new);
        sum += s[a][c];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      corr[a] = expf(m[a] - m_new);
      l[a] = l[a] * corr[a] + sum;
      m[a] = m_new;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + c) * BQ + ty * 4]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][i][c] *= corr[a];
    __syncthreads();

    for (int j = 0; j < BKV; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(&Pt[j * BQ + ty * 4]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int col = (i * 16 + tx) * 4;
        if (col < DP) {
          const float4 vv = *reinterpret_cast<const float4*>(&Vs[j * DP + col]);
          const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[a][i][c] = fmaf(pa[a], vc[c], acc[a][i][c]);
        }
      }
    }
    __syncthreads();
  }

  T* og = static_cast<T*>(p.out) + ((size_t)bh * p.SQ + q0) * D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float den = fmaxf(l[a], 1e-30f);
    const int row = ty * 4 + a;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int col = (i * 16 + tx) * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (col + c < D) from_f(acc[a][i][c] / den,
                                    og + (size_t)row * D + col + c);
      }
    }
  }
}

size_t smem_bytes(int D, int DP) {
  return sizeof(float) * ((size_t)D * BQ + (size_t)D * BKV +
                          (size_t)BKV * DP + (size_t)BKV * BQ);
}

template <typename T, int VEC>
int launch(const Params& p, int B, cudaStream_t st) {
  const size_t bytes = smem_bytes(p.D, p.DP);
  auto kern = flash_prefill_kernel<T, VEC>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(p.SQ / BQ, B * p.H), dim3(THREADS), bytes, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int B, cudaStream_t st) {
  constexpr int V16 = 16 / sizeof(T);
  if (p.D % V16 == 0) return launch<T, V16>(p, B, st);
  return launch<T, 1>(p, B, st);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  All pointers are
// device pointers, 16-byte aligned; the launch goes on `stream` and does
// not synchronise.  elem_bytes: 2 for bfloat16, 4 for float32.
extern "C" int launch_flash_prefill(const void* q, const void* k,
                                    const void* v, void* out, int B, int H,
                                    int KH, int SQ, int SK, int sk, int D,
                                    int causal, int window, float scale,
                                    int elem_bytes, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH || SQ <= 0 || SQ % BQ ||
      SK <= 0 || SK % BKV || sk <= 0 || sk > SK || D <= 0 || D > MAX_D) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.H = H;
  p.G = H / KH;
  p.SQ = SQ;
  p.SK = SK;
  p.sk = sk;
  p.D = D;
  p.DP = (D + 3) / 4 * 4;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 2) return dispatch<__nv_bfloat16>(p, B, st);
  if (elem_bytes == 4) return dispatch<float>(p, B, st);
  return (int)cudaErrorInvalidValue;
}
