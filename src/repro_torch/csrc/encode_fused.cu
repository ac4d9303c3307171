// Fused one-pass ENCODE for Hopper: clip -> interval search -> round ->
// mask -> uint32 bit-pack, bit-exact with the plain PyTorch version
// (repro_torch/kernels/fused_encode.py: encode_fused_plain) and with the
// reference; and QDQ, the same clip/round stage decoded in-register
// (qdq_fused_plain), the error-feedback residual path.
//
// Replaces: the Pallas TPU kernels src/repro/kernels/fused_encode.py:
//   encode_fused (pl.pallas_call at line 255; body _encode_kernel, stage
//   _clip_round, packer _pack_words) and qdq_fused (pl.pallas_call at
//   line 283; body _qdq_kernel).
//
// What bounds it on an H100: bytes. Per bucket row it reads d values and
// d rounding words (4 B each), the level table and limit, and writes
// ceil(d / epw) words; the arithmetic is a few compares per level. On the
// serving path (2R = 16..128 rows of d = 768) the whole call moves
// 0.1-0.8 MB, under a microsecond at 3.35 TB/s, so it is launch-bound.
// qdq reads the same and writes d floats per row: at the training path's
// shape (66,058 rows of 2048, with rounding words and mask) 1.76 GB, ~0.5
// ms at 3.35 TB/s.
//
// Design: one block per bucket row, the row's level table (s <= 17) in
// shared memory; both kernels share round_index (round.cuh, also used by
// multipass.cu's quant_rr), so their rounding decisions are the same by
// construction. Each encode thread produces
// whole output words: it rounds the
// epw = 32 / bits elements of a word and shift-adds them in a register,
// so no (nb, d) index tensor exists and the ragged tail word is zero-
// padded in the register. Exactness: the file is compiled with
// -fmad=false and without fast math, so the divide is IEEE round-to-
// nearest and no multiply-add is contracted; the uint32 -> float
// conversion rounds to nearest and the 2^-32 scale is exact. Every
// operation matches the plain version's float32 tensor op one for one.
#include <cuda_runtime.h>
#include <stdint.h>

#include "round.cuh"

namespace {

using repro::kBin;
using repro::kMaxLevels;
using repro::kRR;
using repro::kSign;
using repro::round_index;

constexpr int kThreads = 128;

__global__ void encode_fused_kernel(const float* __restrict__ v,
                                    const float* __restrict__ levels,
                                    const uint32_t* __restrict__ rbits,
                                    const uint8_t* __restrict__ mask,
                                    const float* __restrict__ lim,
                                    uint32_t* __restrict__ out, int d, int s,
                                    int bits, int mode) {
  __shared__ float lv[kMaxLevels];
  const int row = blockIdx.x;
  if (threadIdx.x < s) lv[threadIdx.x] = levels[(size_t)row * s + threadIdx.x];
  __syncthreads();

  const int epw = 32 / bits;
  const int nw = (d + epw - 1) / epw;
  const float L = lim ? lim[row] : 0.0f;
  const size_t base = (size_t)row * d;

  for (int w = threadIdx.x; w < nw; w += blockDim.x) {
    uint32_t acc = 0;
    for (int e = 0; e < epw; ++e) {
      const int col = w * epw + e;
      if (col >= d) break;  // ragged tail: padded with index 0
      const size_t i = base + col;
      if (mask && !mask[i]) continue;  // masked slot: index 0
      const uint32_t idx = round_index(v[i], lv, s, mode, lim != nullptr, L,
                                       mode == kRR ? rbits[i] : 0u);
      acc += idx << (bits * e);  // disjoint bit ranges: add == or
    }
    out[(size_t)row * nw + w] = acc;
  }
}

// qdq: the same clip/round stage, decoded in-register: out[i] = lv[idx],
// a masked slot decodes to lv[0]. One block per row, one element per
// thread per step (consecutive threads on consecutive elements).
__global__ void qdq_fused_kernel(const float* __restrict__ v,
                                 const float* __restrict__ levels,
                                 const uint32_t* __restrict__ rbits,
                                 const uint8_t* __restrict__ mask,
                                 const float* __restrict__ lim,
                                 float* __restrict__ out, int d, int s,
                                 int mode) {
  __shared__ float lv[kMaxLevels];
  const int row = blockIdx.x;
  if (threadIdx.x < s) lv[threadIdx.x] = levels[(size_t)row * s + threadIdx.x];
  __syncthreads();

  const float L = lim ? lim[row] : 0.0f;
  const size_t base = (size_t)row * d;
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    const size_t i = base + col;
    uint32_t idx = 0;
    if (!mask || mask[i])
      idx = round_index(v[i], lv, s, mode, lim != nullptr, L,
                        mode == kRR ? rbits[i] : 0u);
    out[i] = lv[idx];
  }
}

}  // namespace

extern "C" {

// v, levels, lim: float32; rbits: uint32 (null unless mode == rr);
// mask: bool bytes (null = every slot valid); lim: (nb,) (null = no clip);
// out: (nb, ceil(d / (32 / bits))) uint32. Returns cudaGetLastError().
int repro_encode_fused(const void* v, const void* levels, const void* rbits,
                       const void* mask, const void* lim, void* out, int nb,
                       int d, int s, int bits, int mode, void* stream) {
  if (nb <= 0 || d <= 0 || s < 2 || s > kMaxLevels || bits < 1 || bits > 5 ||
      mode < kRR || mode > kSign || (mode == kRR && rbits == nullptr))
    return (int)cudaErrorInvalidValue;
  encode_fused_kernel<<<nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)v, (const float*)levels, (const uint32_t*)rbits,
      (const uint8_t*)mask, (const float*)lim, (uint32_t*)out, d, s, bits,
      mode);
  return (int)cudaGetLastError();
}

// Same inputs as repro_encode_fused; out: (nb, d) float32 decoded values.
int repro_qdq_fused(const void* v, const void* levels, const void* rbits,
                    const void* mask, const void* lim, void* out, int nb,
                    int d, int s, int mode, void* stream) {
  if (nb <= 0 || d <= 0 || s < 2 || s > kMaxLevels || mode < kRR ||
      mode > kSign || (mode == kRR && rbits == nullptr))
    return (int)cudaErrorInvalidValue;
  qdq_fused_kernel<<<nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)v, (const float*)levels, (const uint32_t*)rbits,
      (const uint8_t*)mask, (const float*)lim, (float*)out, d, s, mode);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
