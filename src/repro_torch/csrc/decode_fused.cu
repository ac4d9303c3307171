// Fused one-pass gradient DECODE for Hopper: shift-mask unpack -> level
// lookup [-> mean over the L workers], bit-exact with the plain PyTorch
// versions (repro_torch/kernels/ref.py: decode_fused_mean_ref,
// decode_fused_each_ref).
//
// Replaces: the Pallas TPU kernels src/repro/kernels/fused_decode.py:
//   decode_fused_mean (pl.pallas_call at line 84; body _decode_mean_kernel)
//   decode_fused_each (pl.pallas_call at line 107; body _decode_each_kernel)
//
// What bounds them on an H100: bytes. Per bucket row the mean reads L rows
// of nw packed words and L level tables and writes d floats; at the
// training path's shape (L = 1, nb = 66,058, d = 2048, 4 bits) that is
// 67.6 MB of words + 2.4 MB of levels read and 541 MB written, ~0.18 ms
// at 3.35 TB/s. The f32 output dominates: it is 8x the packed input (32x
// at 1 bit), so the stores decide the time.
//
// Design of the mean (the per-worker decode's layout, with a loop over
// the workers): a block takes R bucket rows, with their L level tables in
// shared memory, and its threads walk the block's (row, quad) pairs. For
// each of its 4 elements a thread accumulates over the workers in order,
// then writes the 4 floats with one 16-byte store, so a warp stores 512
// contiguous bytes. R = clamp(48 KB / (L * s * 4 B), 1, 8)
// (fused_decode.mean_rows, passed in): 8 rows at any realistic L, fewer
// as L grows, and one row whose tables need more than 48 KB of shared
// memory, for which the launch opts in.
//
// Design of the per-worker decode: the (L, nb) rows are one run of L * nb
// rows; a block takes kEachRows of them, with their level tables in shared
// memory, and its threads walk the block's (row, quad) pairs: thread i
// writes the 4 consecutive floats of one quad with one 16-byte store, so a
// warp stores 512 contiguous bytes. A thread reads the word that holds its
// 4 indices (two words where 3- and 5-bit words split a quad); neighbouring
// threads share a word through L1. A row whose start is not 16-byte
// aligned, and the tail of a row whose d is not a multiple of 4, are
// stored by the same threads with scalar stores.
//
// Both: the (L, nb, d) index tensor of the multi-pass path never exists.
// Shifts are logical: the int32 storage is read as uint32_t. At 3 and 5
// bits the top 2 bits of each word are unused; a ragged row's tail lanes
// are not written.
//
// Exactness: an index >= s decodes to 0, like the reference's one-hot
// sum, which equals the table entry by value (only a zero's sign can
// differ). The mean accumulates acc = __fmaf_rn(val, inv, acc), worker by
// worker l = 0..L-1, inv = f32(1/L): the Pallas kernel's `out += val *
// (1.0 / L)` in its order, with the multiply and the add rounded once, as
// XLA contracts them when the reference runs; so it is exact for any L.
// The file is built with -fmad=false: no other multiply-add is fused.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 17;
constexpr int kMeanThreads = 256;  // the mean: threads, and most rows per
constexpr int kMeanRows = 8;       // block (R, the caller's, 1..8)
constexpr int kEachThreads = 256;  // the per-worker decode: threads, and
constexpr int kEachRows = 8;       // rows per block
constexpr size_t kMaxSmem = 227 * 1024;  // a block's shared memory at most

// The 4 indices of quad e0 of a row (words w): a quad that straddles two
// words at 3 and 5 bits reads both.
template <int BITS>
__device__ __forceinline__ void quad_indices(const uint32_t* w, int e0,
                                             int nw, uint32_t (&idx)[4]) {
  constexpr int kEpw = 32 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  constexpr bool kOneWord = kEpw % 4 == 0;  // a quad never splits a word
  const int wa = e0 / kEpw;
  const uint32_t a = w[wa];
  uint32_t b = a;
  if (!kOneWord) {
    const int wb = min((e0 + 3) / kEpw, nw - 1);
    if (wb != wa) b = w[wb];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = e0 + u;
    const uint32_t word = (kOneWord || e / kEpw == wa) ? a : b;
    idx[u] = (word >> (BITS * (e % kEpw))) & kMask;
  }
}

// The 4 floats of a quad at o: one 16-byte store where the quad is whole
// and o aligned, else scalar stores of the elements inside the row.
__device__ __forceinline__ void store_quad(float* o, int e0, int d,
                                           const float (&v)[4]) {
  if (e0 + 4 <= d && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e0 + u < d) o[u] = v[u];
  }
}

template <int BITS>
__global__ void __launch_bounds__(kMeanThreads) decode_mean_kernel(
    const uint32_t* __restrict__ words, const float* __restrict__ levels,
    float* __restrict__ out, int L, int nb, int nw, int d, int s, int R,
    float inv) {
  extern __shared__ float lv[];  // [R][L][s]: the rows' level tables
  const int r0 = blockIdx.x * R;
  const int nr = min(R, nb - r0);
  const int per = L * s;  // one row's tables
  // worker l's tables of the block's rows are nr * s contiguous floats
  for (int i = threadIdx.x; i < L * nr * s; i += blockDim.x) {
    const int l = i / (nr * s), k = i - l * (nr * s);
    const int rr = k / s;
    lv[rr * per + l * s + (k - rr * s)] =
        levels[((size_t)l * nb + r0) * s + k];
  }
  __syncthreads();

  const int nq = (d + 3) / 4;  // quads per row
  const size_t plane = (size_t)nb * nw;  // one worker's words
  for (int i = threadIdx.x; i < nr * nq; i += blockDim.x) {
    const int rr = i / nq, e0 = 4 * (i - rr * nq);
    const size_t r = (size_t)(r0 + rr);
    const uint32_t* w = words + r * nw;
    const float* t = lv + rr * per;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int l = 0; l < L; ++l) {
      uint32_t idx[4];
      quad_indices<BITS>(w + l * plane, e0, nw, idx);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float val = idx[u] < (uint32_t)s ? t[l * s + idx[u]] : 0.0f;
        acc[u] = __fmaf_rn(val, inv, acc[u]);
      }
    }
    store_quad(out + r * d + e0, e0, d, acc);
  }
}

template <int BITS>
__global__ void __launch_bounds__(kEachThreads) decode_each_kernel(
    const uint32_t* __restrict__ words, const float* __restrict__ levels,
    float* __restrict__ out, int R, int nw, int d, int s) {
  __shared__ float lv[kEachRows * kMaxLevels];  // the rows' level tables
  const int r0 = blockIdx.x * kEachRows;
  const int nr = min(kEachRows, R - r0);
  for (int i = threadIdx.x; i < nr * s; i += blockDim.x) {
    const int rr = i / s;
    lv[rr * kMaxLevels + (i - rr * s)] = levels[(size_t)r0 * s + i];
  }
  __syncthreads();

  const int nq = (d + 3) / 4;  // quads per row
  for (int i = threadIdx.x; i < nr * nq; i += blockDim.x) {
    const int rr = i / nq, e0 = 4 * (i - rr * nq);
    const size_t r = (size_t)(r0 + rr);
    const float* t = lv + rr * kMaxLevels;
    uint32_t idx[4];
    quad_indices<BITS>(words + r * nw, e0, nw, idx);
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = idx[u] < (uint32_t)s ? t[idx[u]] : 0.0f;
    store_quad(out + r * d + e0, e0, d, v);
  }
}

template <int BITS>
cudaError_t launch_mean(const uint32_t* w, const float* lv, float* out,
                        int L, int nb, int nw, int d, int s, int R, float inv,
                        cudaStream_t stream) {
  const size_t smem = (size_t)R * L * s * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_mean_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  decode_mean_kernel<BITS><<<(nb + R - 1) / R, kMeanThreads, smem, stream>>>(
      w, lv, out, L, nb, nw, d, s, R, inv);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_each(const uint32_t* w, const float* lv, float* out,
                        int R, int nw, int d, int s, cudaStream_t stream) {
  decode_each_kernel<BITS>
      <<<(R + kEachRows - 1) / kEachRows, kEachThreads, 0, stream>>>(
          w, lv, out, R, nw, d, s);
  return cudaGetLastError();
}

bool bad_args(int L, int nb, int nw, int d, int s, int bits) {
  return L <= 0 || nb <= 0 || nw <= 0 || d <= 0 || s < 1 || s > kMaxLevels ||
         bits < 1 || bits > 5 || s > (1 << bits) ||
         nw != (d + 32 / bits - 1) / (32 / bits);
}

}  // namespace

extern "C" {

// words: (L, nb, nw) uint32; levels: (L, nb, s) float32; out: (nb, d)
// float32 mean. R: rows per block, 1..8, whose R * L * s level floats fit
// a block's shared memory; inv = float32(1 / L). Returns
// cudaGetLastError().
int repro_decode_fused_mean(const void* words, const void* levels, void* out,
                            int L, int nb, int nw, int d, int s, int bits,
                            int R, float inv, void* stream) {
  if (bad_args(L, nb, nw, d, s, bits) || R < 1 || R > kMeanRows ||
      (size_t)R * L * s * sizeof(float) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const uint32_t* w = (const uint32_t*)words;
  const float* lv = (const float*)levels;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bits) {
    case 1: return (int)launch_mean<1>(w, lv, o, L, nb, nw, d, s, R, inv, st);
    case 2: return (int)launch_mean<2>(w, lv, o, L, nb, nw, d, s, R, inv, st);
    case 3: return (int)launch_mean<3>(w, lv, o, L, nb, nw, d, s, R, inv, st);
    case 4: return (int)launch_mean<4>(w, lv, o, L, nb, nw, d, s, R, inv, st);
    default: return (int)launch_mean<5>(w, lv, o, L, nb, nw, d, s, R, inv, st);
  }
}

// words: (L, nb, nw) uint32; levels: (L, nb, s) float32; out: (L, nb, d)
// float32. L * nb must fit an int. Returns cudaGetLastError().
int repro_decode_fused_each(const void* words, const void* levels, void* out,
                            int L, int nb, int nw, int d, int s, int bits,
                            void* stream) {
  if (bad_args(L, nb, nw, d, s, bits) || (long long)L * nb > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int R = L * nb;
  const uint32_t* w = (const uint32_t*)words;
  const float* lv = (const float*)levels;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bits) {
    case 1: return (int)launch_each<1>(w, lv, o, R, nw, d, s, st);
    case 2: return (int)launch_each<2>(w, lv, o, R, nw, d, s, st);
    case 3: return (int)launch_each<3>(w, lv, o, R, nw, d, s, st);
    case 4: return (int)launch_each<4>(w, lv, o, R, nw, d, s, st);
    default: return (int)launch_each<5>(w, lv, o, R, nw, d, s, st);
  }
}

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
