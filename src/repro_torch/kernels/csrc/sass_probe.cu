// Instruction-count probes for the shared mask math (fault_masks.cuh).
//
// Not a kernel of the port: nothing launches these.  chip_smoke.py compiles
// this file to a cubin for sm_90a and counts the SASS instructions of each
// probe with cuobjdump, so the per-word operation counts behind the kernels'
// bounds can be set beside what the compiler really emits.  Each probe
// handles one word (one codeword for ECC) per thread in straight-line code;
// the copy probes do the same loads and stores without the masks, so a
// probe's count minus its copy's is the mask math of one word (codeword).
#include <stdint.h>

#include "fault_masks.cuh"

extern "C" __global__ void probe_copy(const uint32_t* __restrict__ x,
                                      uint32_t* __restrict__ out) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = x[i];
}

extern "C" __global__ void probe_word(const uint32_t* __restrict__ x,
                                      uint32_t* __restrict__ out,
                                      fm::Streams s, fm::Thr t, int wprl2) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = fm::apply_masks<fm::METHOD_WORD>(x[i], i, s, nullptr, t, wprl2);
}

extern "C" __global__ void probe_bitwise(const uint32_t* __restrict__ x,
                                         uint32_t* __restrict__ out,
                                         const uint32_t* __restrict__ planes,
                                         fm::Streams s, fm::Thr t, int wprl2) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = fm::apply_masks<fm::METHOD_BITWISE>(x[i], i, s, planes, t, wprl2);
}

extern "C" __global__ void probe_copy2(const uint2* __restrict__ x,
                                       uint2* __restrict__ out,
                                       int* __restrict__ corrected,
                                       int* __restrict__ uncorrectable) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = x[i];
  corrected[i] = (int)i;
  uncorrectable[i] = (int)i;
}

extern "C" __global__ void probe_ecc(const uint2* __restrict__ x,
                                     uint2* __restrict__ out,
                                     int* __restrict__ corrected,
                                     int* __restrict__ uncorrectable,
                                     fm::Streams s, fm::Thr t, int wprl2) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  uint2 v = x[i];
  int c, u;
  fm::ecc_codeword(v.x, v.y, 2u * i, s, t, wprl2, c, u);
  out[i] = v;
  corrected[i] = c;
  uncorrectable[i] = u;
}
