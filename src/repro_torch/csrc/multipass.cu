// The multi-pass wire pipeline for Hopper: four kernels, each one stage
// of the reference's multi-pass encode and decode, each bit-exact with
// its plain PyTorch version (repro_torch/kernels/quant_rr.py,
// bitpack.py, dequant_avg.py):
//
//   quant_rr     interval search + unbiased random rounding: (nb, d) f32
//                values + (nb, s) levels + (nb, d) uint32 words -> (nb, d)
//                int32 level indices;
//   pack         (nb, d) int32 indices -> (nb, nw) uint32 words;
//   unpack       (nb, nw) uint32 words -> (nb, d) int32 indices;
//   dequant_avg  level lookup + mean over L workers: (L, nb, d) int32 +
//                (L, nb, s) f32 -> (nb, d) f32.
//
// Replaces: the Pallas TPU kernels src/repro/kernels/quant_rr.py:
//   quant_rr (pl.pallas_call at line 74; body _quant_rr_kernel),
//   bitpack.py: pack (line 46; _pack_kernel) and unpack (line 65;
//   _unpack_kernel), dequant_avg.py: dequant_avg (line 50;
//   _dequant_avg_kernel).
//
// What bounds them on an H100: bytes; each does a few integer or float
// operations per element. At the training path's shape (66,058 buckets of
// 2048, 135,286,784 slots) quant_rr reads values and rounding words and
// writes indices, 4 B each: 1.62 GB, 0.485 ms at 3.35 TB/s. pack at 4 bits
// reads the 541 MB of indices and writes 67.6 MB of words, 0.182 ms;
// unpack the reverse. dequant_avg reads L index tensors and L level
// tables and writes one f32 tensor: 0.324 ms at L = 1, 0.811 ms at L = 4.
//
// Design: one block per bucket row, so no thread divides by d. quant_rr
// keeps the row's level table (s <= 17) in shared memory and rounds with
// round_index (round.cuh), the round stage of encode_fused.cu, so the
// multi-pass and fused encodes make the same decisions by construction.
// pack gives each thread whole output words: it shift-adds the
// epw = 32 / BITS indices of a word in a register (BITS is a template
// parameter, so the lanes unroll), the ragged tail packing index 0 and
// the top 2 bits of a 3- or 5-bit word staying 0; the fields are disjoint
// for indices below 2^BITS, and otherwise the sum wraps mod 2^32 as the
// reference's uint32 sum does. unpack gives each thread one output index
// (consecutive threads on consecutive int32 stores). dequant_avg gives
// each thread one (row, column): it accumulates acc = fma(val, f32(1/L),
// acc) for l = 0..L-1 from acc = +0, val = the level the index names, or
// 0 for an index outside [0, s) as the reference's one-hot sum gives.
// That is the Pallas kernel's `out += val * (1/L)` in its order, with the
// multiply and add rounded once, as XLA contracts them; starting from +0
// also gives its +0 for a level of -0. The file is built with
// -fmad=false: no other multiply-add is fused.
#include <cuda_runtime.h>
#include <stdint.h>

#include "round.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void quant_rr_kernel(const float* __restrict__ v,
                                const float* __restrict__ levels,
                                const uint32_t* __restrict__ rbits,
                                int32_t* __restrict__ out, int d, int s) {
  __shared__ float lv[repro::kMaxLevels];
  const int row = blockIdx.x;
  if (threadIdx.x < s) lv[threadIdx.x] = levels[(size_t)row * s + threadIdx.x];
  __syncthreads();

  const size_t base = (size_t)row * d;
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    const size_t i = base + col;
    out[i] = (int32_t)repro::round_index(v[i], lv, s, repro::kRR, false, 0.0f,
                                         rbits[i]);
  }
}

template <int BITS>
__global__ void pack_kernel(const int32_t* __restrict__ idx,
                            uint32_t* __restrict__ out, int d, int nw) {
  constexpr int kEpw = 32 / BITS;
  const int row = blockIdx.x;
  const int32_t* src = idx + (size_t)row * d;
  for (int w = threadIdx.x; w < nw; w += blockDim.x) {
    const int n = d - w * kEpw;  // lanes of this word inside the row
    uint32_t acc = 0;
#pragma unroll
    for (int e = 0; e < kEpw; ++e)
      if (e < n) acc += (uint32_t)src[w * kEpw + e] << (BITS * e);
    out[(size_t)row * nw + w] = acc;
  }
}

template <int BITS>
__global__ void unpack_kernel(const uint32_t* __restrict__ words,
                              int32_t* __restrict__ out, int d, int nw) {
  constexpr int kEpw = 32 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  const int row = blockIdx.x;
  const uint32_t* src = words + (size_t)row * nw;
  int32_t* dst = out + (size_t)row * d;
  for (int col = threadIdx.x; col < d; col += blockDim.x)
    dst[col] = (int32_t)((src[col / kEpw] >> (BITS * (col % kEpw))) & kMask);
}

__global__ void dequant_avg_kernel(const int32_t* __restrict__ idx,
                                   const float* __restrict__ levels,
                                   float* __restrict__ out, int L, int nb,
                                   int d, int s, float inv) {
  const int row = blockIdx.x;
  const size_t plane = (size_t)nb * d;  // one worker's index tensor
  const size_t base = (size_t)row * d;
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float acc = 0.0f;
    for (int l = 0; l < L; ++l) {
      const int32_t k = idx[(size_t)l * plane + base + col];
      const float val =
          (k >= 0 && k < s) ? __ldg(levels + ((size_t)l * nb + row) * s + k)
                            : 0.0f;
      acc = __fmaf_rn(val, inv, acc);
    }
    out[base + col] = acc;
  }
}

template <int BITS>
cudaError_t launch_pack(const int32_t* idx, uint32_t* out, int nb, int d,
                        int nw, cudaStream_t stream) {
  pack_kernel<BITS><<<nb, kThreads, 0, stream>>>(idx, out, d, nw);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_unpack(const uint32_t* words, int32_t* out, int nb, int d,
                          int nw, cudaStream_t stream) {
  unpack_kernel<BITS><<<nb, kThreads, 0, stream>>>(words, out, d, nw);
  return cudaGetLastError();
}

bool bad_words(int nb, int d, int nw, int bits) {
  return nb <= 0 || d <= 0 || bits < 1 || bits > 5 ||
         nw != (d + 32 / bits - 1) / (32 / bits);
}

}  // namespace

extern "C" {

// v, levels: float32; rbits: uint32; out: (nb, d) int32. Returns
// cudaGetLastError().
int repro_quant_rr(const void* v, const void* levels, const void* rbits,
                   void* out, int nb, int d, int s, void* stream) {
  if (nb <= 0 || d <= 0 || s < 2 || s > repro::kMaxLevels)
    return (int)cudaErrorInvalidValue;
  quant_rr_kernel<<<nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)v, (const float*)levels, (const uint32_t*)rbits,
      (int32_t*)out, d, s);
  return (int)cudaGetLastError();
}

// idx: (nb, d) int32; out: (nb, nw) uint32, nw = ceil(d / (32 / bits)).
int repro_pack(const void* idx, void* out, int nb, int d, int nw, int bits,
               void* stream) {
  if (bad_words(nb, d, nw, bits)) return (int)cudaErrorInvalidValue;
  const int32_t* i = (const int32_t*)idx;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bits) {
    case 1: return (int)launch_pack<1>(i, o, nb, d, nw, st);
    case 2: return (int)launch_pack<2>(i, o, nb, d, nw, st);
    case 3: return (int)launch_pack<3>(i, o, nb, d, nw, st);
    case 4: return (int)launch_pack<4>(i, o, nb, d, nw, st);
    default: return (int)launch_pack<5>(i, o, nb, d, nw, st);
  }
}

// words: (nb, nw) uint32; out: (nb, d) int32.
int repro_unpack(const void* words, void* out, int nb, int d, int nw,
                 int bits, void* stream) {
  if (bad_words(nb, d, nw, bits)) return (int)cudaErrorInvalidValue;
  const uint32_t* w = (const uint32_t*)words;
  int32_t* o = (int32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bits) {
    case 1: return (int)launch_unpack<1>(w, o, nb, d, nw, st);
    case 2: return (int)launch_unpack<2>(w, o, nb, d, nw, st);
    case 3: return (int)launch_unpack<3>(w, o, nb, d, nw, st);
    case 4: return (int)launch_unpack<4>(w, o, nb, d, nw, st);
    default: return (int)launch_unpack<5>(w, o, nb, d, nw, st);
  }
}

// idx: (L, nb, d) int32; levels: (L, nb, s) float32; out: (nb, d) float32
// mean. inv = float32(1 / L).
int repro_dequant_avg(const void* idx, const void* levels, void* out, int L,
                      int nb, int d, int s, float inv, void* stream) {
  if (L <= 0 || nb <= 0 || d <= 0 || s < 1) return (int)cudaErrorInvalidValue;
  dequant_avg_kernel<<<nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float*)levels, (float*)out, L, nb, d, s,
      inv);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
