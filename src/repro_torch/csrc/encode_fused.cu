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
// Design of the encode: the grid goes over (row, tile of words); a warp
// packs a tile of 32 consecutive words, one a lane, so that a warp's store
// is 128 contiguous bytes. It takes the tile's 32 * epw elements in epw
// steps, lane i on element 32 * step + i, so that the loads of v, rbits
// and mask coalesce; every load of the tile is issued before the first
// rounding, and the epw roundings of a lane are independent. The indices
// are combined into words across lanes: at 1 bit one ballot a step makes
// a word; at 2 and 4 bits each lane packs its own epw indices into one
// register, a transpose within each group of epw lanes (log2 epw
// __shfl_xor_sync stages) turns those into the group's words, and one
// shuffle hands word j to lane j; at 3 and 5 bits (epw 10 and 6, so a
// word straddles the steps) the tile's indices are staged as bytes in
// shared memory, then each lane packs its word. A ragged tail is padded
// with index 0 and a masked slot gives index 0. Blocks take 1 to 8 warps
// of a row (fused_encode.encode_grid, passed in: one warp a block until
// the card holds two blocks of eight per SM, so that the serving path's
// 16 rows spread over 48 blocks). The level table of a row: where its
// size is the scheme's s = 2^(bits-1) + 1 (2 at 1 bit), a compile-time
// count held in registers, read through the read-only cache together with
// the elements, so the rounding unrolls and a small grid pays one round
// trip to memory; any other s is read into shared memory. At 1 bit, where
// a lane rounds 32 elements, the rounding mode is a template parameter
// too (a kernel per mode), so that the roundings do not branch on it.
//
// qdq: one block per bucket row, the row's level table (s <= 17) in
// shared memory. Both kernels share round_index (round.cuh, also used by
// multipass.cu's quant_rr), called unchanged, so their rounding decisions
// are the same by construction, and no (nb, d) index tensor exists.
// Exactness: the file is compiled with
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

constexpr int kThreads = 128;  // qdq: threads per row
constexpr int kTileWords = 32;  // encode: words a warp packs, one a lane
constexpr int kMaxWarps = 8;    // encode: most warps a block
constexpr unsigned kFull = 0xffffffffu;

// The cells i of a word of 32 / bits cells of `bits` bits with i & h != 0.
__host__ __device__ constexpr uint32_t cell_mask(int bits, int h) {
  uint32_t m = 0;
  for (int i = 0; i < 32 / bits; ++i)
    if (i & h) m |= ((1u << bits) - 1u) << (bits * i);
  return m;
}

// s = S levels (a compile-time count, the table in registers) or, S = 0,
// any s (the table in shared memory); MODE: the rounding mode as a
// compile-time constant, or -1 to take `mode` at run time. tiles: blocks
// per row.
template <int BITS, int S, int MODE>
__global__ void __launch_bounds__(kMaxWarps * 32) encode_fused_kernel(
    const float* __restrict__ v, const float* __restrict__ levels,
    const uint32_t* __restrict__ rbits, const uint8_t* __restrict__ mask,
    const float* __restrict__ lim, uint32_t* __restrict__ out, int d, int s,
    int mode, int tiles) {
  constexpr int kEpw = 32 / BITS;
  constexpr bool kAligned = 32 % kEpw == 0;  // 1, 2, 4 bits: a step holds
                                             // whole words
  constexpr int kStaged = kAligned ? 1 : kTileWords * kEpw;  // a warp's
  __shared__ float lvs[S ? 1 : kMaxLevels];                  // bytes
  __shared__ uint8_t staged[kMaxWarps * kStaged];
  if (MODE >= 0) mode = MODE;
  const int row = blockIdx.x / tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = (d + kEpw - 1) / kEpw;
  // the warp's first word and element
  const int w0 = ((blockIdx.x - row * tiles) * (blockDim.x / 32) + warp) *
                 kTileWords;
  const int c0 = w0 * kEpw;
  const size_t base = (size_t)row * d;

  // every load of the tile at once; step i takes element c0 + 32 i + lane
  float x[kEpw];
  uint32_t rb[kEpw];
  bool ok[kEpw];  // inside the row and not masked
#pragma unroll
  for (int i = 0; i < kEpw; ++i) {
    const int col = c0 + 32 * i + lane;
    const bool in = col < d;
    x[i] = in ? v[base + col] : 0.0f;
    rb[i] = in && mode == kRR ? rbits[base + col] : 0u;
    ok[i] = in && (mask == nullptr || mask[base + col]);
  }
  const float L = lim ? lim[row] : 0.0f;
  float lt[S ? S : 1];
  const float* lv = lt;
  if constexpr (S > 0) {
#pragma unroll
    for (int j = 0; j < S; ++j) lt[j] = levels[(size_t)row * S + j];
  } else {
    if (threadIdx.x < s)
      lvs[threadIdx.x] = levels[(size_t)row * s + threadIdx.x];
    __syncthreads();
    lv = lvs;
  }
  if (w0 >= nw) return;  // a warp past the row's words (no barrier follows)

  uint32_t word = 0;  // this lane's word of the tile: w0 + lane
  uint8_t* st = staged + warp * kStaged;
#pragma unroll
  for (int i = 0; i < kEpw; ++i) {
    const uint32_t r = round_index(x[i], lv, S > 0 ? S : s, mode,
                                   lim != nullptr, L, rb[i]);
    const uint32_t idx = ok[i] ? r : 0u;  // ragged tail, masked: index 0
    if constexpr (BITS == 1) {
      const uint32_t w = __ballot_sync(kFull, idx != 0u);
      if (lane == i) word = w;
    } else if constexpr (kAligned) {
      word |= idx << (BITS * i);  // the lane's own steps, cell i
    } else {
      st[32 * i + lane] = (uint8_t)idx;
    }
  }
  if constexpr (kAligned && BITS > 1) {
    // Lane e of a group of epw lanes holds cell i = its step i's index;
    // the word of step i of the group is cell e of lane e. Transpose the
    // group's epw x epw cells (log2 epw stages: lanes e and e ^ h swap
    // their off-diagonal blocks), then lane g * epw + e holds tile word
    // e * BITS + g, and one shuffle hands word j to lane j.
#pragma unroll
    for (int h = kEpw / 2; h >= 1; h >>= 1) {
      const uint32_t m = cell_mask(BITS, h);
      const uint32_t p = __shfl_xor_sync(kFull, word, h);
      word = (lane & h) ? (word & m) | ((p >> (BITS * h)) & ~m)
                        : (word & ~m) | ((p << (BITS * h)) & m);
    }
    word = __shfl_sync(kFull, word, (lane % BITS) * kEpw + lane / BITS);
  }
  if constexpr (!kAligned) {
    __syncwarp();
#pragma unroll
    for (int e = 0; e < kEpw; ++e)
      word |= (uint32_t)st[lane * kEpw + e] << (BITS * e);
  }
  if (w0 + lane < nw) out[(size_t)row * nw + w0 + lane] = word;
}

template <int BITS>
int launch_encode(const float* v, const float* levels, const uint32_t* rbits,
                  const uint8_t* mask, const float* lim, uint32_t* out,
                  int nb, int d, int s, int mode, int warps,
                  cudaStream_t stream) {
  // the scheme's level count at this width: 2 at 1 bit, else 2^(bits-1) + 1
  constexpr int kS = BITS == 1 ? 2 : (1 << (BITS - 1)) + 1;
  const int nw = (d + 32 / BITS - 1) / (32 / BITS);
  const int tiles = ((nw + kTileWords - 1) / kTileWords + warps - 1) / warps;
  if ((long long)nb * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
#define REPRO_TILES(S, MODE)                                            \
  encode_fused_kernel<BITS, S, MODE><<<nb * tiles, warps * 32, 0, stream>>>( \
      v, levels, rbits, mask, lim, out, d, s, mode, tiles)
  if (s != kS)
    REPRO_TILES(0, -1);
  else if constexpr (BITS > 1)
    REPRO_TILES(kS, -1);
  else if (mode == kRR)
    REPRO_TILES(kS, kRR);
  else if (mode == kBin)
    REPRO_TILES(kS, kBin);
  else
    REPRO_TILES(kS, kSign);
#undef REPRO_TILES
  return (int)cudaGetLastError();
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
// out: (nb, ceil(d / (32 / bits))) uint32; warps: warps a block, 1..4.
// Returns cudaGetLastError().
int repro_encode_fused(const void* v, const void* levels, const void* rbits,
                       const void* mask, const void* lim, void* out, int nb,
                       int d, int s, int bits, int mode, int warps,
                       void* stream) {
  if (nb <= 0 || d <= 0 || s < 2 || s > kMaxLevels || bits < 1 || bits > 5 ||
      s > (1 << bits) || mode < kRR || mode > kSign ||
      (mode == kRR && rbits == nullptr) || warps < 1 || warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const float* fv = (const float*)v;
  const float* fl = (const float*)levels;
  const uint32_t* rb = (const uint32_t*)rbits;
  const uint8_t* m = (const uint8_t*)mask;
  const float* li = (const float*)lim;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_ENCODE(BITS) \
  launch_encode<BITS>(fv, fl, rb, m, li, o, nb, d, s, mode, warps, st)
  switch (bits) {
    case 1: return REPRO_ENCODE(1);
    case 2: return REPRO_ENCODE(2);
    case 3: return REPRO_ENCODE(3);
    case 4: return REPRO_ENCODE(4);
    default: return REPRO_ENCODE(5);
  }
#undef REPRO_ENCODE
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
