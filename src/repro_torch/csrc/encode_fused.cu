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
// shape (66,058 rows of 2048, with rounding words and mask) 1.76 GB, 0.525
// ms at 3.35 TB/s. In that time the card issues only about 115-130
// instructions an element, so qdq's interval search must not sweep every
// level (about 9 instructions a level an element).
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
// qdq: one block of 128 threads per bucket row; the level count (the
// schemes' 2, 3, 5, 9, 17, or any s), the mode, the clip and the mask
// are template parameters, so the element loop does not branch on them.
// A row whose d is a multiple of 4 (the training buffer's 2048) is read
// and written 16 bytes a thread at a time, 4 such units a thread in
// flight before the first rounding. In rr mode the interval search is a
// binary search of ceil(log2(s - 1)) steps over the ascending table (4
// at s = 17, the first two on registers) in place of round_index's sweep
// over all s levels, so the element's work barely grows with s; lo and hi
// come from one 8-byte read, and the decode is lo or hi. The block checks
// once per row that the table is non-decreasing and free of NaN (where
// the search and the sweep agree); a row that fails takes round_index.
// Both kernels clip as the reference does: a NaN value or limit
// stays NaN (and rounds to index 0). No (nb, d) index tensor exists.
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

// The reference's clip, jnp.clip(x, -L, L) = min(max(x, -L), L), where a
// NaN value or limit gives NaN (fminf / fmaxf alone would drop it). A NaN
// rounds to index 0 in every mode.
__device__ __forceinline__ float clip_nan(float x, float L) {
  const float y = fminf(L, fmaxf(-L, x));
  return x == x && L == L ? y : __fadd_rn(x, L);
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
    const uint32_t r =
        round_index(lim ? clip_nan(x[i], L) : x[i], lv, S > 0 ? S : s, mode,
                    false, 0.0f, rb[i]);
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

// ---------------------------------------------------------------------------
// qdq: the same clip/round stage, decoded in-register: out[i] = lv[idx], a
// masked slot decodes to lv[0].
// ---------------------------------------------------------------------------

constexpr int kQdqThreads = 128;  // threads a row (one block a row)
constexpr int kQdqBatch = 4;      // units a thread loads before it rounds
constexpr int kPairs = kMaxLevels - 1;

__host__ __device__ constexpr int ceil_log2(int n) {
  return n <= 1 ? 0 : 1 + ceil_log2((n + 1) / 2);
}

// What a thread keeps of its row: lv[0], lv[1] (the masked slot's level,
// bin and sign's two), the bin threshold, the levels of the first two
// search steps (lv[h], lv[h / 2], lv[3h / 2]; at s = 3 lv[2]) and the
// clip limit. pairs[j] = (lv[j], lv[j + 1]) in shared memory.
struct QdqRow {
  float lv0, lv1, thr, rh, rl, ru, L;
  const float2* pairs;
  int s;
};

// rr mode on a table that is non-decreasing and free of NaN. There the
// running selects of round_index end at lo = lv[k], hi = lv[k + 1] with
// k = clamp(#{j : lv[j] <= x} - 1, 0, s - 2), ties included (x = NaN:
// k = 0), and since lv[j] <= x holds on a prefix of j, k is the number
// of j in 1..s-2 where it holds: a branch-free binary search of
// ceil(log2(s - 1)) steps, the first two on registers, the rest on
// pairs[].x; then one 8-byte read gives lo and hi. S = 0 (any s): the
// table is padded with +inf to 16 pairs, 4 steps, k capped at s - 2
// (only x = +inf reaches the pad). The rounding after the search is
// round_index's term for term; idx = k + up, so lv[idx] is hi or lo.
template <int S>
__device__ __forceinline__ float qdq_rr(float x, uint32_t rb,
                                        const QdqRow& t) {
  float lo = t.lv0, hi = t.lv1;
  if constexpr (S == 3) {
    const bool ge = t.rh <= x;
    lo = ge ? t.lv1 : t.lv0;
    hi = ge ? t.ru : t.lv1;
  } else if constexpr (S != 2) {
    constexpr int kSteps = S ? ceil_log2(S - 1) : ceil_log2(kPairs);
    constexpr int h = 1 << (kSteps - 1);
    int k = t.rh <= x ? h : 0;
    k += (k ? t.ru : t.rl) <= x ? h / 2 : 0;
#pragma unroll
    for (int st = h / 4; st >= 1; st >>= 1)
      k += t.pairs[k + st].x <= x ? st : 0;
    if constexpr (S == 0) k = min(k, t.s - 2);
    const float2 p = t.pairs[k];
    lo = p.x;
    hi = p.y;
  }
  const float vc = fminf(fmaxf(x, lo), hi);
  const float width = __fsub_rn(hi, lo);
  const float p_up =
      width > 0.0f ? __fdiv_rn(__fsub_rn(vc, lo), width) : 0.0f;
  const float u = __fmul_rn(__uint2float_rn(rb),
                            2.3283064365386963e-10f);  // 2^-32
  return u < p_up ? hi : lo;
}

template <int S, int MODE, bool LIM>
__device__ __forceinline__ float qdq_one(float x, uint32_t rb,
                                         const QdqRow& t) {
  if constexpr (LIM) x = clip_nan(x, t.L);
  if constexpr (MODE == kRR) return qdq_rr<S>(x, rb, t);
  if constexpr (MODE == kBin) return x >= t.thr ? t.lv1 : t.lv0;
  return x >= 0.0f ? t.lv1 : t.lv0;
}

// A thread's batch of a row: units u0 + kQdqThreads * i + tid, i <
// kQdqBatch, each 4 elements (VEC) or one; every load issued before any
// value is used.
template <int MODE, bool MASK, bool VEC>
__device__ __forceinline__ void qdq_load(
    const float* __restrict__ v, const uint32_t* __restrict__ rbits,
    const uint8_t* __restrict__ mask, size_t base, int units, int u0,
    float (&x)[kQdqBatch * (VEC ? 4 : 1)],
    uint32_t (&r)[kQdqBatch * (VEC ? 4 : 1)], uint32_t (&m)[kQdqBatch]) {
#pragma unroll
  for (int i = 0; i < kQdqBatch; ++i) {
    const int u = u0 + kQdqThreads * i + threadIdx.x;
    if (u >= units) continue;
    if constexpr (VEC) {
      const float4 a = reinterpret_cast<const float4*>(v + base)[u];
      x[4 * i] = a.x, x[4 * i + 1] = a.y, x[4 * i + 2] = a.z,
      x[4 * i + 3] = a.w;
      if constexpr (MODE == kRR) {
        const uint4 b = reinterpret_cast<const uint4*>(rbits + base)[u];
        r[4 * i] = b.x, r[4 * i + 1] = b.y, r[4 * i + 2] = b.z,
        r[4 * i + 3] = b.w;
      }
      if constexpr (MASK)
        m[i] = reinterpret_cast<const uint32_t*>(mask + base)[u];
    } else {
      x[i] = v[base + u];
      if constexpr (MODE == kRR) r[i] = rbits[base + u];
      if constexpr (MASK) m[i] = mask[base + u];
    }
  }
}

// One row: VEC takes units of 4 elements (16-byte loads of v and rbits,
// a 4-byte load of the mask, a 16-byte store), else single elements. A
// thread loads kQdqBatch units (unit tid + kQdqThreads * i) before it
// rounds the first; the first batch is in flight while the row's table
// arrives. The table check (every pair lv[j] <= lv[j + 1], which also
// fails on a NaN) rides on the barrier that publishes the table; a row
// that fails it (rr only) takes round_index's running selects.
template <int S, int MODE, bool LIM, bool MASK, bool VEC>
__device__ __forceinline__ void qdq_row(
    const float* __restrict__ v, const float* __restrict__ levels,
    const uint32_t* __restrict__ rbits, const uint8_t* __restrict__ mask,
    const float* __restrict__ lim, float* __restrict__ out, int d, int s) {
  constexpr int W = VEC ? 4 : 1;
  constexpr int kN = kQdqBatch * W;
  __shared__ float lvs[kMaxLevels];
  __shared__ float2 pairs[kPairs];
  const int row = blockIdx.x, tid = threadIdx.x;
  const size_t base = (size_t)row * d;
  const int units = VEC ? d / 4 : d;
  const int ns = S ? S : s;

  float x[kN];
  uint32_t r[kN];
  uint32_t m[kQdqBatch];  // VEC: the unit's 4 mask bytes; else 1 byte
  qdq_load<MODE, MASK, VEC>(v, rbits, mask, base, units, 0, x, r, m);

  bool bad = false;
  if (tid < ns) {
    const float a = levels[(size_t)row * ns + tid];
    lvs[tid] = a;
    if (MODE == kRR && tid < ns - 1) {
      const float b = levels[(size_t)row * ns + tid + 1];
      pairs[tid] = make_float2(a, b);
      bad = !(a <= b);
    }
  }
  if (MODE == kRR && S == 0 && tid >= ns - 1 && tid < kPairs)
    pairs[tid] = make_float2(__int_as_float(0x7f800000),
                             __int_as_float(0x7f800000));  // +inf
  const float L = LIM ? lim[row] : 0.0f;
  if (__syncthreads_or(bad)) {
    for (int col = tid; col < d; col += kQdqThreads) {
      const size_t i = base + col;
      float o = lvs[0];
      if (!MASK || mask[i]) {
        const float xc = LIM ? clip_nan(v[i], L) : v[i];
        o = lvs[round_index(xc, lvs, ns, kRR, false, 0.0f, rbits[i])];
      }
      out[i] = o;
    }
    return;
  }

  QdqRow t;
  t.lv0 = lvs[0];
  t.lv1 = lvs[1];
  t.thr = __fmul_rn(0.5f, __fadd_rn(t.lv0, t.lv1));
  t.L = L;
  t.pairs = pairs;
  t.s = ns;
  t.rh = t.rl = t.ru = 0.0f;
  if constexpr (MODE == kRR && S == 3) {
    t.rh = lvs[1];
    t.ru = lvs[2];
  } else if constexpr (MODE == kRR && S != 2) {
    constexpr int kSteps = S ? ceil_log2(S - 1) : ceil_log2(kPairs);
    constexpr int h = 1 << (kSteps - 1);
    t.rh = pairs[h].x;
    t.rl = pairs[h / 2].x;
    t.ru = pairs[h + h / 2].x;
  }

  for (int u0 = 0;;) {
#pragma unroll
    for (int i = 0; i < kQdqBatch; ++i) {
      const int u = u0 + kQdqThreads * i + tid;
      if (u >= units) continue;
      float o[W];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        o[e] = qdq_one<S, MODE, LIM>(x[W * i + e], r[W * i + e], t);
        if constexpr (MASK)
          if (!((m[i] >> (8 * e)) & 0xffu)) o[e] = t.lv0;
      }
      if constexpr (VEC)
        reinterpret_cast<float4*>(out + base)[u] =
            make_float4(o[0], o[1], o[2], o[3]);
      else
        out[base + u] = o[0];
    }
    u0 += kQdqThreads * kQdqBatch;
    if (u0 >= units) break;
    qdq_load<MODE, MASK, VEC>(v, rbits, mask, base, units, u0, x, r, m);
  }
}

// One block of kQdqThreads per bucket row. S: the level count as a
// compile-time constant (the schemes' 2, 3, 5, 9, 17; 0 = any s <= 17);
// MODE, LIM (a clip limit), MASK: compile-time too, so the element loop
// does not branch on them. vec: rows of a multiple of 4 elements at
// 16-byte aligned addresses (the training buffer's 2048) take 16-byte
// accesses, other rows single ones.
template <int S, int MODE, bool LIM, bool MASK>
__global__ void __launch_bounds__(kQdqThreads) qdq_fused_kernel(
    const float* __restrict__ v, const float* __restrict__ levels,
    const uint32_t* __restrict__ rbits, const uint8_t* __restrict__ mask,
    const float* __restrict__ lim, float* __restrict__ out, int d, int s,
    bool vec) {
  if (vec)
    qdq_row<S, MODE, LIM, MASK, true>(v, levels, rbits, mask, lim, out, d,
                                      s);
  else
    qdq_row<S, MODE, LIM, MASK, false>(v, levels, rbits, mask, lim, out, d,
                                       s);
}

template <int MODE, bool LIM, bool MASK>
void launch_qdq(const float* v, const float* levels, const uint32_t* rbits,
                const uint8_t* mask, const float* lim, float* out, int nb,
                int d, int s, bool vec, cudaStream_t stream) {
#define REPRO_QDQ(S)                                                       \
  qdq_fused_kernel<S, MODE, LIM, MASK><<<nb, kQdqThreads, 0, stream>>>(    \
      v, levels, rbits, mask, lim, out, d, s, vec)
  if constexpr (MODE != kRR) {
    REPRO_QDQ(0);
  } else {
    switch (s) {
      case 2: REPRO_QDQ(2); break;
      case 3: REPRO_QDQ(3); break;
      case 5: REPRO_QDQ(5); break;
      case 9: REPRO_QDQ(9); break;
      case 17: REPRO_QDQ(17); break;
      default: REPRO_QDQ(0);
    }
  }
#undef REPRO_QDQ
}

template <int MODE>
void launch_qdq_mode(const float* v, const float* levels,
                     const uint32_t* rbits, const uint8_t* mask,
                     const float* lim, float* out, int nb, int d, int s,
                     bool vec, cudaStream_t st) {
  if (lim && mask)
    launch_qdq<MODE, true, true>(v, levels, rbits, mask, lim, out, nb, d, s,
                                 vec, st);
  else if (lim)
    launch_qdq<MODE, true, false>(v, levels, rbits, mask, lim, out, nb, d,
                                  s, vec, st);
  else if (mask)
    launch_qdq<MODE, false, true>(v, levels, rbits, mask, lim, out, nb, d,
                                  s, vec, st);
  else
    launch_qdq<MODE, false, false>(v, levels, rbits, mask, lim, out, nb, d,
                                   s, vec, st);
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
  const float* fv = (const float*)v;
  const float* fl = (const float*)levels;
  const uint32_t* rb = mode == kRR ? (const uint32_t*)rbits : nullptr;
  const uint8_t* m = (const uint8_t*)mask;
  const float* li = (const float*)lim;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  auto aligned = [](const void* p, uintptr_t n) {
    return p == nullptr || (uintptr_t)p % n == 0;
  };
  const bool vec = d % 4 == 0 && aligned(v, 16) && aligned(out, 16) &&
                   aligned(rb, 16) && aligned(mask, 4);
  if (mode == kRR)
    launch_qdq_mode<kRR>(fv, fl, rb, m, li, o, nb, d, s, vec, st);
  else if (mode == kBin)
    launch_qdq_mode<kBin>(fv, fl, rb, m, li, o, nb, d, s, vec, st);
  else
    launch_qdq_mode<kSign>(fv, fl, rb, m, li, o, nb, d, s, vec, st);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
