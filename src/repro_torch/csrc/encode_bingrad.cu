// BinGrad-b for Hopper: the fully fused ENCODE (b0 search, conditional-mean
// levels, threshold at their midpoint, 1-bit pack) and the single PASS
// (conditional sums and counts at a given b0, plus the assignment v >= b0).
// Plain PyTorch versions: repro_torch/kernels/fused_bingrad.py
// (encode_bingrad_fused_plain) and repro_torch/kernels/bingrad.py
// (bingrad_pass_plain).
//
// Replaces: the Pallas TPU kernels src/repro/kernels/fused_bingrad.py:
//   encode_bingrad_fused (pl.pallas_call at line 102; body
//   _bingrad_encode_kernel) and src/repro/kernels/bingrad.py: bingrad_pass
//   (pl.pallas_call at line 52; body _bingrad_kernel).
//
// What bounds them on an H100: bytes. The encode reads each value (4 B)
// and mask byte once and writes d/8 bytes of words and 8 bytes of levels
// per row; its arithmetic is a few adds and compares per element and
// pass. At the training path's shape (66,058 rows of 2048, masked) that
// is ~0.69 GB, ~0.21 ms at 3.35 TB/s; on the serving path (16-128 rows of
// 768, no mask) it is launch-bound. The pass reads the same and writes an
// int32 per element: ~1.2 GB, ~0.36 ms.
//
// Design: one block per bucket row, consecutive threads on consecutive
// elements (coalesced loads), the row kept in registers across the
// encode's passes (8 values a thread: d <= 8 * blockDim <= 8192), so the
// values are read from device memory once although the fit sweeps them
// 2 + lloyd_iters times. Each sweep ends in a block reduction: warp
// shuffles, then one warp over the per-warp partials in shared memory.
// The pack needs no shifting: with element e at bit e % 32 of word e / 32,
// one warp's __ballot_sync over 32 consecutive elements IS the wire word
// (blockDim is a multiple of 32, so every warp covers one whole word;
// lanes past d and masked lanes vote 0). mask == nullptr means every slot
// is valid. The file is compiled with -fmad=false; the divisions, adds
// and the midpoint are the IEEE round-to-nearest intrinsics the reference
// formulas name: b0 = sum / max(cnt, 1), thr = 0.5 * (bm + bp). The row
// sums add in another order than the plain version's, so the levels are
// float-close to it, and bit-equal where every partial sum is exact; the
// words are the exact threshold of the kernel's own levels.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kItems = 8;           // row values a thread keeps in registers
constexpr int kMaxThreads = 1024;   // so d <= kItems * kMaxThreads
constexpr int kPassThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Sum each of x[0..N) over the block; every thread gets the totals. red
// holds 32 * N floats. blockDim.x is a multiple of 32.
template <int N>
__device__ __forceinline__ void block_sum(float (&x)[N], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x[k] = __fadd_rn(x[k], __shfl_xor_sync(kFull, x[k], off));
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) red[warp * N + k] = x[k];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float y = lane < nwarps ? red[lane * N + k] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        y = __fadd_rn(y, __shfl_xor_sync(kFull, y, off));
      if (lane == 0) red[32 * N + k] = y;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = red[32 * N + k];
  __syncthreads();  // red is reused by the next reduction
}

// Eq. (17)'s conditional means of the valid values below / above b0, an
// empty side collapsing to the other side's mean (fused_bingrad.py:59-61).
__device__ __forceinline__ void cond_means(const float (&x)[kItems],
                                           const bool (&ok)[kItems],
                                           float b0, float* red, float& bm,
                                           float& bp) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // sum_lo, cnt_lo, sum_hi, cnt_hi
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (!ok[i]) continue;
    if (x[i] < b0) {
      s[0] = __fadd_rn(s[0], x[i]);
      s[1] = __fadd_rn(s[1], 1.0f);
    } else if (x[i] >= b0) {
      s[2] = __fadd_rn(s[2], x[i]);
      s[3] = __fadd_rn(s[3], 1.0f);
    }
  }
  block_sum<4>(s, red);
  bm = __fdiv_rn(s[0], fmaxf(s[1], 1.0f));
  bp = __fdiv_rn(s[2], fmaxf(s[3], 1.0f));
  if (!(s[1] > 0.0f)) bm = bp;
  if (!(s[3] > 0.0f)) bp = bm;
}

__global__ void encode_bingrad_kernel(const float* __restrict__ v,
                                      const uint8_t* __restrict__ mask,
                                      const float* __restrict__ lim,
                                      uint32_t* __restrict__ words,
                                      float* __restrict__ levels, int d,
                                      int lloyd_iters) {
  __shared__ float red[32 * 4 + 4];
  const int row = blockIdx.x, nt = blockDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = (size_t)row * d;
  const int nw = (d + 31) / 32;
  const float L = lim ? lim[row] : 0.0f;

  float x[kItems];
  bool ok[kItems];
  float s[2] = {0.0f, 0.0f};  // sum, count of the valid values
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int col = i * nt + threadIdx.x;
    float xv = 0.0f;
    if (col < d) {
      xv = v[base + col];
      if (lim) xv = fminf(L, fmaxf(-L, xv));
    }
    x[i] = xv;
    ok[i] = col < d && (!mask || mask[base + col]);
    if (ok[i]) {
      s[0] = __fadd_rn(s[0], xv);
      s[1] = __fadd_rn(s[1], 1.0f);
    }
  }
  block_sum<2>(s, red);
  float b0 = __fdiv_rn(s[0], fmaxf(s[1], 1.0f));  // paper: b0 = mean(G)
  float bm, bp;
  cond_means(x, ok, b0, red, bm, bp);
  for (int it = 0; it < lloyd_iters; ++it) {
    b0 = __fmul_rn(0.5f, __fadd_rn(bm, bp));
    cond_means(x, ok, b0, red, bm, bp);
  }
  const float thr = __fmul_rn(0.5f, __fadd_rn(bm, bp));  // Eq. (17)

#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned word = __ballot_sync(kFull, ok[i] && x[i] >= thr);
    const int w = (i * nt >> 5) + warp;
    if (lane == 0 && w < nw) words[(size_t)row * nw + w] = word;
  }
  if (threadIdx.x == 0) {
    levels[2 * (size_t)row] = bm;
    levels[2 * (size_t)row + 1] = bp;
  }
}

__global__ void bingrad_pass_kernel(const float* __restrict__ v,
                                    const float* __restrict__ b0,
                                    const uint8_t* __restrict__ mask,
                                    int32_t* __restrict__ idx,
                                    float* __restrict__ part, int d) {
  __shared__ float red[32 * 4 + 4];
  const int row = blockIdx.x;
  const size_t base = (size_t)row * d;
  const float t = b0[row];
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // sum_lo, cnt_lo, sum_hi, cnt_hi
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    const size_t i = base + col;
    const float x = v[i];
    const bool ok = !mask || mask[i];
    const bool ge = x >= t;
    idx[i] = ok && ge ? 1 : 0;
    if (!ok) continue;
    if (ge) {
      s[2] = __fadd_rn(s[2], x);
      s[3] = __fadd_rn(s[3], 1.0f);
    } else {  // lo = (1 - (v >= b0)) * m, as the reference writes it
      s[0] = __fadd_rn(s[0], x);
      s[1] = __fadd_rn(s[1], 1.0f);
    }
  }
  block_sum<4>(s, red);
  if (threadIdx.x < 4) part[4 * (size_t)row + threadIdx.x] = s[threadIdx.x];
}

}  // namespace

extern "C" {

// v, lim: float32 (lim (nb,) or null = no clip); mask: bool bytes (null =
// every slot valid); words: (nb, ceil(d / 32)) uint32; levels: (nb, 2)
// float32. Returns cudaGetLastError().
int repro_encode_bingrad(const void* v, const void* mask, const void* lim,
                         void* words, void* levels, int nb, int d,
                         int lloyd_iters, void* stream) {
  if (nb <= 0 || d <= 0 || d > kItems * kMaxThreads || lloyd_iters < 0)
    return (int)cudaErrorInvalidValue;
  int threads = (d + kItems - 1) / kItems;
  threads = (threads + 31) / 32 * 32;
  encode_bingrad_kernel<<<nb, threads, 0, (cudaStream_t)stream>>>(
      (const float*)v, (const uint8_t*)mask, (const float*)lim,
      (uint32_t*)words, (float*)levels, d, lloyd_iters);
  return (int)cudaGetLastError();
}

// v: (nb, d) float32; b0: (nb,) float32; mask: bool bytes (null = every
// slot valid); idx: (nb, d) int32; part: (nb, 4) float32.
int repro_bingrad_pass(const void* v, const void* b0, const void* mask,
                       void* idx, void* part, int nb, int d, void* stream) {
  if (nb <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  bingrad_pass_kernel<<<nb, kPassThreads, 0, (cudaStream_t)stream>>>(
      (const float*)v, (const float*)b0, (const uint8_t*)mask, (int32_t*)idx,
      (float*)part, d);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
