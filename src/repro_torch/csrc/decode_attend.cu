// Fused dequant-attention over a bit-packed KV context, for Hopper.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/fused_kv.py:
//   decode_attend (pl.pallas_call at line 70, body ref.kv_attend_block at
//   src/repro/kernels/ref.py:154), the serving engine's attention.
//
// Inputs: q (B, T, H, hd) f32; kw, vw (B, C, nw) uint32 words holding
// 32 / bits level indices each (element e of a token's row in word e / epw
// at shift bits * (e % epw)); klv, vlv (B, C, s) f32 per-token level
// tables; mask (B, T, C) bool. Output (B, T, H, hd) f32. GQA: query head h
// reads KV head h / g, g = H / KV. Masked scores are -2e38 (not -inf), so
// a fully masked row averages the C positions uniformly, as the
// reference's softmax does.
//
// What bounds it on an H100: bytes, and below them the latency of a few
// dependent loads. At decode (B 8, C 512, d 768, 4-bit words) the K and V
// words and tables of the admitted positions are ~1.8 MB a layer, about
// 0.55 us at 3.35 TB/s; the f32 arithmetic is ~13 MFLOP. A masked position
// adds exactly 0 (its weight exp(-2e38 - m) is 0 in f32 once m is a real
// score, and a masked-only prefix is scaled by corr = 0), so only tiles
// that some row admits need any work.
//
// Design: the TPU kernel decodes a sequence's whole context into VMEM; at
// C = 512, d = 768 that is 1.5 MB each for K and V, far over the 227 KB of
// shared memory. Here a block takes up to kRows query rows (t, head) of
// one (sequence, KV head) and one of S contiguous splits of the context's
// 32-token tiles; the S blocks of a (sequence, KV head, row group) form a
// thread-block cluster (flash-decoding in one launch).
//   1. Skip. The block first scans its rows' masks: the first and last
//      admitted position bound its tiles, and a tile that none of its
//      rows admits (a warp ballot over the tile's mask bytes) is skipped.
//      A block with a fully masked row walks every tile, since that row
//      averages all C positions.
//   2. Warps take the split's tiles in turn (tile lo + warp, + kWarps, ...)
//      and each carries every row of the block, so no warp idles at
//      T·g < 4. At these sizes the kernel is a chain of latencies, so a
//      tile costs one round trip to memory: lane c loads token c's K and
//      V words of the head slice and its two level tables into the warp's
//      shared memory together with the tile's mask bytes, then decodes its
//      K row on the fly into each row's score (a streaming (online)
//      softmax in f32), and lane l accumulates output dims l, l + 32, ...
//      from the V words over the tile's positions. BITS is a template
//      parameter and both loops are unrolled, so element e's word and
//      shift are fixed at compile time and the lookups overlap. No block
//      barrier inside the loop; dequantized values never touch device
//      memory.
//   3. Merge. Each warp's (m, l, acc) per row goes to shared memory and is
//      merged within the block; the S blocks' partials are then merged
//      through distributed shared memory (m* = max m_i, l* = sum l_i
//      e^(m_i - m*), out = sum acc_i e^(m_i - m*) / l*), each block
//      writing a slice of the rows' outputs.
// S is the caller's (fused_kv.split_count: enough blocks to fill the card,
// at most 8, the portable cluster size). Simple still: no tensor cores (the
// decode shape has too few rows), no TMA.
//
// Head dims: the kernel is built for a padded head dim HDP in {32, 64,
// 128, 256}, the least that holds the true hd (1..256), which it takes at
// run time. A lane's dims lane + 32 k >= hd look up no level and store
// nothing; the rows' queries are zero past hd, so the score loop, which
// runs in whole unrolled runs, adds exactly 0 there. At 1, 2 and 4 bits a
// head slice that starts inside a word (hd not a multiple of 32 / bits)
// has its K words shifted into place as they are staged, so each
// element's word and shift stay compile-time constants; at hd = HDP the
// code is that of a kernel built for hd alone. HDP 256 needs ~70 KB of
// shared memory a block, so its launch opts in above the 48 KB default.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;      // context tokens per tile (= warp width)
constexpr int kWarps = 4;      // warps per block
constexpr int kRows = 4;       // query rows per block
constexpr int kMaxLevels = 17;
constexpr int kMaxSplits = 8;  // portable cluster size
constexpr int kMaxHeadDim = 256;
constexpr float kMasked = -2.0e38f;
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory of one block, in 4-byte units: the rows' queries,
// then per warp its tile's K and V words (token c's head slice at c * kWs,
// kWs odd so that lanes' rows fall in distinct banks) and level tables
// (token c's at c * kMaxLevels), then the block's merged partial (m[kRows],
// l[kRows], acc[kRows][HDP]). After the loop a warp's words hold its own
// partial in the same layout. Sized for the padded head dim HDP; entries
// past hd are never written or read.
template <int HDP>
struct Smem {
  // words of one token's head slice at most: up to HDP elements at 5 bits
  // (6 a word; more a word at fewer bits), not aligned to a word
  static constexpr int kSlice = (HDP - 1) / 6 + 2;
  static constexpr int kWs = kSlice | 1;
  static constexpr int kQ = kRows * HDP;
  static constexpr int kWords = kTile * kWs;
  static constexpr int kLv = kTile * kMaxLevels;
  static constexpr int kWarp = 2 * kWords + 2 * kLv;
  static constexpr int kPart = 2 * kRows + kRows * HDP;
  static constexpr size_t kBytes =
      sizeof(float) * (kQ + kWarps * kWarp + kPart);
  static_assert(kPart <= kWarp, "a warp's partial must fit its tile");
  static_assert(kBytes <= 227 * 1024, "over a block's shared memory");
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Weight of a partial with running max mi against the merged max mx; a
// partial that saw no tile has mi = -inf and weighs 0.
__device__ __forceinline__ float rescale(float mi, float mx) {
  return mi == -INFINITY ? 0.0f : expf(mi - mx);
}

// acc += p V over a tile's positions, every position in turn, unrolled:
// one some row weighs adds p * v, any other (its words maybe never
// loaded) adds exactly 0, and so does a dim past hd (its index is held
// against a limit of 0, so it reads no level; its word offset stays
// inside the staged slice).
template <int HDP, int BITS>
__device__ __forceinline__ void pv_tile(
    const uint32_t* vst, const float* lv, const float (&p)[kRows],
    unsigned live, const bool (&dim)[HDP / 32], const int (&wo)[HDP / 32],
    const int (&sh)[HDP / 32], int na, int s,
    float (&acc)[kRows][HDP / 32]) {
  constexpr int kPerLane = HDP / 32;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  constexpr int kWs = Smem<HDP>::kWs;
  // fully unrolled runs (shorter past hd 64, so that registers do not
  // spill)
  constexpr int kPvRun = HDP > 64 ? 8 : kTile;
#pragma unroll 1
  for (int c0v = 0; c0v < kTile; c0v += kPvRun) {
#pragma unroll
    for (int cv = 0; cv < kPvRun; ++cv) {
      const int c = c0v + cv;
      const bool w = (live >> c) & 1u;
      float pc[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        pc[rr] = __shfl_sync(kFull, p[rr], c);
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const uint32_t vc = (vst[c * kWs + wo[k]] >> sh[k]) & kMask;
        const float val =
            w && vc < (dim[k] ? (uint32_t)s : 0u) ? lv[c * kMaxLevels + vc]
                                                  : 0.0f;
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr)
          if (rr < na) acc[rr][k] += pc[rr] * val;
      }
    }
  }
}

template <int HDP, int BITS>
__global__ void __launch_bounds__(kWarps * 32) decode_attend_kernel(
    const float* __restrict__ q, const uint32_t* __restrict__ kw,
    const float* __restrict__ klv, const uint32_t* __restrict__ vw,
    const float* __restrict__ vlv, const uint8_t* __restrict__ mask,
    float* __restrict__ out, int T, int H, int KV, int hd, int C, int nw,
    int s, float scale, float softcap, int S) {
  constexpr int kPerLane = HDP / 32;
  constexpr int kEpw = 32 / BITS;  // indices a word
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  // fully unrolled runs of the score loop (shorter past hd 64, so that
  // registers do not spill)
  constexpr int kDotRun = HDP < 64 ? HDP : 64;
  using L = Smem<HDP>;
  constexpr int kWs = L::kWs;
  extern __shared__ float smem[];
  __shared__ int s_first, s_last;

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x % S;  // = cluster.block_rank()
  const int r0 = (blockIdx.x / S) * kRows;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int g = H / KV;
  const int na = min(kRows, T * g - r0);  // active rows of this block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float* qs = smem;  // [kRows][HDP], zero past hd
  float* wbase = smem + L::kQ + warp * L::kWarp;
  uint32_t* kst = reinterpret_cast<uint32_t*>(wbase);  // [kTile][kWs]
  uint32_t* vst = kst + L::kWords;
  float* lk = wbase + 2 * L::kWords;  // [kTile][kMaxLevels]
  float* lv = lk + L::kLv;
  float* part = smem + L::kQ + kWarps * L::kWarp;

  if (threadIdx.x == 0) {
    s_first = C;
    s_last = -1;
  }
  for (int i = threadIdx.x; i < na * HDP; i += blockDim.x) {
    const int rr = i / HDP, j = i % HDP, r = r0 + rr;
    qs[i] = j < hd ? q[(((size_t)b * T + r / g) * H + kvh * g + r % g) * hd
                       + j]
                   : 0.0f;
  }
  const size_t mrow0 = (size_t)b * T;  // mask row of (b, t): mrow0 + t
  // 1. the rows' admitted span, and whether some row admits nothing
  bool any_empty = false;
  int first = C, last = -1;
  for (int rr = 0; rr < na; ++rr) {
    const int t = (r0 + rr) / g;
    if (rr > 0 && t == (r0 + rr - 1) / g) continue;  // same mask row
    const uint8_t* mr = mask + (mrow0 + t) * C;
    bool seen = false;
#pragma unroll 4
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      if (mr[c]) {
        seen = true;
        first = min(first, c);
        last = max(last, c);
      }
    }
    if (!__syncthreads_or(seen)) any_empty = true;  // uniform in the block
  }
  if (first < C) atomicMin(&s_first, first);
  if (last >= 0) atomicMax(&s_last, last);
  __syncthreads();

  const int n_tiles = (C + kTile - 1) / kTile;
  const int per = (n_tiles + S - 1) / S;
  int lo = split * per, hi = min(n_tiles, lo + per);
  if (!any_empty) {
    lo = max(lo, s_first / kTile);
    hi = min(hi, s_last / kTile + 1);
  }

  const size_t ctx = (size_t)b * C;  // first context row of sequence b
  const uint8_t* mrow[kRows];
  const int e0 = kvh * hd;                        // the head slice's first
  const int w0 = e0 / kEpw;                       // element and word,
  const int nwh = (e0 + hd - 1) / kEpw - w0 + 1;  // its words,
  const int at0 = e0 % kEpw;  // and its first element's lane in word w0
  // K element j of the head sits at staged element kat0 + j: words of 1, 2
  // and 4 bits are shifted into place (by kShift bits) as they are staged
  constexpr bool kPow2 = (kEpw & (kEpw - 1)) == 0;
  const int kat0 = kPow2 ? 0 : at0;
  const int kShift = kPow2 ? BITS * at0 : 0;
  // this lane's dims lane + 32 k: inside hd, slice word, shift
  bool dim[kPerLane];
  int wo[kPerLane], sh[kPerLane];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr)
    mrow[rr] = mask + (mrow0 + (r0 + min(rr, na - 1)) / g) * C;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    dim[k] = lane + 32 * k < hd;
    const int e = e0 + (dim[k] ? lane + 32 * k : 0);
    wo[k] = e / kEpw - w0;
    sh[k] = BITS * (e % kEpw);
  }
  float m[kRows], l[kRows], acc[kRows][kPerLane];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.0f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) acc[rr][k] = 0.0f;
  }

  // 2. this warp's tiles of the split
  for (int tile = lo + warp; tile < hi; tile += kWarps) {
    const int c0 = tile * kTile, cc = c0 + lane;
    const bool in = cc < C;  // past the context end: excluded entirely
    // lane c loads token c's words and levels with the tile's mask bytes:
    // one round trip (a skipped tile wastes only its loads)
    if (in) {
      const size_t row = ctx + cc;
      const uint32_t* kr = kw + row * nw + w0;
      const uint32_t* vr = vw + row * nw + w0;
      if (kShift == 0) {
#pragma unroll
        for (int w = 0; w < L::kSlice; ++w) {
          if (w < nwh) {
            kst[lane * kWs + w] = kr[w];
            vst[lane * kWs + w] = vr[w];
          }
        }
      } else {
#pragma unroll
        for (int w = 0; w < L::kSlice; ++w) {
          if (w < nwh) {
            kst[lane * kWs + w] = __funnelshift_r(
                kr[w], w + 1 < nwh ? kr[w + 1] : 0u, kShift);
            vst[lane * kWs + w] = vr[w];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxLevels; ++j) {
        if (j < s) {
          lk[lane * kMaxLevels + j] = klv[row * s + j];
          lv[lane * kMaxLevels + j] = vlv[row * s + j];
        }
      }
    }
    bool adm[kRows];
    bool any = false;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      adm[rr] = rr < na && in && mrow[rr][cc];
      any |= adm[rr];
    }
    if (!any_empty && !__any_sync(kFull, any)) continue;
    __syncwarp();

    float dot[kRows];  // lane c: its token's K row, decoded on the fly
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) dot[rr] = 0.0f;
    if (in) {
      const uint32_t* kr = kst + lane * kWs;
      const float* lt = lk + lane * kMaxLevels;
      // whole unrolled runs over hd; the queries are zero past hd, so the
      // rest of the last run adds exactly 0 (its lookups stay inside the
      // staged words and name loaded levels)
#pragma unroll 1
      for (int j0 = 0; j0 < (HDP <= kDotRun ? HDP : hd); j0 += kDotRun) {
#pragma unroll
        for (int jj = 0; jj < kDotRun; ++jj) {
          const int j = j0 + jj, e = kat0 + j;
          const uint32_t kc = (kr[e / kEpw] >> (BITS * (e % kEpw))) & kMask;
          const float kval = kc < (uint32_t)s ? lt[kc] : 0.0f;
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr)
            if (rr < na) dot[rr] += qs[rr * HDP + j] * kval;
        }
      }
    }
    float p[kRows];
    unsigned live = 0;  // positions that some row weighs
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      p[rr] = 0.0f;
      if (rr >= na) continue;
      float sc = -INFINITY;
      if (in) {
        sc = dot[rr] * scale;
        if (softcap != 0.0f) sc = tanhf(sc / softcap) * softcap;
        if (!adm[rr]) sc = kMasked;
      }
      const float m_new = fmaxf(m[rr], warp_max(sc));  // lane 0 is in range
      p[rr] = in ? expf(sc - m_new) : 0.0f;
      const float corr = expf(m[rr] - m_new);  // 0 on the first tile
      l[rr] = l[rr] * corr + warp_sum(p[rr]);
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) acc[rr][k] *= corr;
      m[rr] = m_new;
      live |= __ballot_sync(kFull, p[rr] != 0.0f);
    }
    pv_tile<HDP, BITS>(vst, lv, p, live, dim, wo, sh, na, s, acc);
    __syncwarp();  // the next tile overwrites this one's tables
  }

  // 3a. merge the warps' partials within the block
  float* wp = wbase;  // this warp's partial, over its tile
  if (lane == 0) {
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      wp[rr] = m[rr];
      wp[kRows + rr] = l[rr];
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    if (rr >= na) continue;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k)
      if (dim[k]) wp[2 * kRows + rr * HDP + lane + 32 * k] = acc[rr][k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < na * HDP; i += blockDim.x) {
    const int rr = i / HDP;
    if (i % HDP >= hd) continue;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, smem[L::kQ + w * L::kWarp + rr]);
    float ls = 0.0f, as = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float* pw = smem + L::kQ + w * L::kWarp;
      const float f = rescale(pw[rr], mx);
      ls += pw[kRows + rr] * f;
      as += pw[2 * kRows + i] * f;
    }
    part[2 * kRows + i] = as;
    if (i % HDP == 0) {
      part[rr] = mx;
      part[kRows + rr] = ls;
    }
  }
  // 3b. merge the S splits through distributed shared memory; block
  // `split` writes elements split * blockDim + tid, + S * blockDim, ...
  cluster.sync();
  for (int i = split * blockDim.x + threadIdx.x; i < na * HDP;
       i += S * blockDim.x) {
    const int rr = i / HDP, j = i % HDP, r = r0 + rr;
    if (j >= hd) continue;
    float mx = -INFINITY;
    for (int x = 0; x < S; ++x)
      mx = fmaxf(mx, cluster.map_shared_rank(part, x)[rr]);
    float ls = 0.0f, as = 0.0f;
    for (int x = 0; x < S; ++x) {
      const float* px = cluster.map_shared_rank(part, x);
      const float f = rescale(px[rr], mx);
      ls += px[kRows + rr] * f;
      as += px[2 * kRows + i] * f;
    }
    out[(((size_t)b * T + r / g) * H + kvh * g + r % g) * hd + j] = as / ls;
  }
  cluster.sync();  // keep this block's partial alive until all have read
}

template <int HDP, int BITS>
int launch(const void* q, const void* kw, const void* klv, const void* vw,
           const void* vlv, const void* mask, void* out, int B, int T, int H,
           int KV, int hd, int C, int nw, int s, float scale, float softcap,
           int S, cudaStream_t stream) {
  constexpr size_t kSmem = Smem<HDP>::kBytes;
  if (kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attend_kernel<HDP, BITS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e != cudaSuccess) return (int)e;
  }
  const int groups = (T * (H / KV) + kRows - 1) / kRows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * S, KV, B);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_attend_kernel<HDP, BITS>, (const float*)q,
      (const uint32_t*)kw, (const float*)klv, (const uint32_t*)vw,
      (const float*)vlv, (const uint8_t*)mask, (float*)out, T, H, KV, hd, C,
      nw, s, scale, softcap, S);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// S: context splits per (sequence, KV head, row group), the cluster size,
// 1..8. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for shapes the kernel does not take: hd must lie in 1..256).
int repro_decode_attend(const void* q, const void* kw, const void* klv,
                        const void* vw, const void* vlv, const void* mask,
                        void* out, int B, int T, int H, int KV, int hd, int C,
                        int nw, int s, int bits, float scale, float softcap,
                        int S, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || C <= 0 || KV <= 0 || KV > 65535 ||
      H % KV != 0 || hd < 1 || hd > kMaxHeadDim || s < 1 ||
      s > kMaxLevels || bits < 1 || bits > 5 || S < 1 || S > kMaxSplits ||
      (long long)((T * (long long)(H / KV) + kRows - 1) / kRows) * S >
          0x7fffffffLL ||
      (long long)nw * (32 / bits) < (long long)KV * hd)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_ATTEND(HDP, BITS)                                        \
  launch<HDP, BITS>(q, kw, klv, vw, vlv, mask, out, B, T, H, KV, hd, C, \
                    nw, s, scale, softcap, S, st)
#define REPRO_ATTEND_BITS(HDP)          \
  switch (bits) {                       \
    case 1: return REPRO_ATTEND(HDP, 1); \
    case 2: return REPRO_ATTEND(HDP, 2); \
    case 3: return REPRO_ATTEND(HDP, 3); \
    case 4: return REPRO_ATTEND(HDP, 4); \
    default: return REPRO_ATTEND(HDP, 5); \
  }
  // the padded head dim: the least of 32, 64, 128, 256 that holds hd
  if (hd <= 32) REPRO_ATTEND_BITS(32)
  if (hd <= 64) REPRO_ATTEND_BITS(64)
  if (hd <= 128) REPRO_ATTEND_BITS(128)
  REPRO_ATTEND_BITS(256)
#undef REPRO_ATTEND_BITS
#undef REPRO_ATTEND
}

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
