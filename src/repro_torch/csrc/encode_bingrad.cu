// BinGrad-b for Hopper: the fully fused ENCODE (b0 search, conditional-mean
// levels, threshold at their midpoint, 1-bit pack) and the single PASS
// (conditional sums and counts at a given b0, plus the assignment v >= b0).
// Plain PyTorch versions: repro_torch/kernels/fused_bingrad.py
// (encode_bingrad_fused_plain; kernel_order_levels repeats the encode's
// additions in its order) and repro_torch/kernels/bingrad.py
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
// sweep. At the training path's shape (66,058 rows of 2048, masked) that
// is ~0.69 GB, ~0.21 ms at 3.35 TB/s; on the serving path (16-128 rows of
// 768, no mask) it is a chain of latencies. The pass reads the same and
// writes an int32 per element: ~1.2 GB, ~0.36 ms.
//
// The encode's order of additions, on every path: that of a block of
// nt = 32 * ceil(ceil(d / 8) / 32) threads, thread t = 32 j + l summing
// its terms at columns i * nt + t in order of i, each warp j adding its 32
// lanes by the xor tree 16, 8, 4, 2, 1, and the nt / 32 warp totals,
// zero-padded to 32, going through the same tree. The terms are the
// reference's v * m, v * lo and v * hi of every slot (fused_bingrad.py:
// 47-58): a value left out of a sum adds v * 0, a zero that leaves the sum
// as it was (a partial starts at +0 and never becomes -0) for a finite v,
// and NaN for a NaN or an infinity, as in the reference. Counts are exact
// integers. The levels are the same bits on every path and in
// kernel_order_levels (fused_bingrad.py, plain PyTorch).
//
// Warp paths (d <= 2048: both main paths' widths): a warp per row and no
// block barrier. Lane l holds columns l + 32 k, k = i * NW + j (NW =
// nt / 32), in registers: 64 values and 64 mask bits at d = 2048, so the
// fit's 2 + lloyd_iters sweeps read registers and a Lloyd sweep costs
// arithmetic only: for a row of finite values one compare, two predicated
// adds and a count an element, the masked slots (zeros) taken back out of
// the counts afterwards. Lane l keeps one partial per (quantity, j); a
// butterfly reduce-scatter does the lane trees of all (quantity, j)
// slots at once (9 and 16 shuffles for one and two quantities, not 5 a
// slot; every index a compile-time constant, so the slots stay in
// registers), and the tree over j is three more xor shuffles. Rows are
// strided over a persistent grid (three blocks of up to four warps an
// SM); each warp stages its next row in 40 nt + 128 bytes of shared
// memory while it fits this one, so it always has a row's bytes in
// flight: by two 1-D bulk copies (TMA) on an mbarrier where d is a
// multiple of 16 and the tensors start on 16 bytes, else by 4-byte
// cp.async copies of the values and of the aligned words around the
// row's mask bytes. Small nb gets one warp a block, so each row has an SM
// of its own. The plan (path, warps a block, grid, shared bytes) is
// computed in Python (fused_bingrad.launch_plan) and checked here.
//
// Block path (2048 < d <= 8192, or mask bytes off a 4-byte boundary; no
// main path): one block per row, 8 values a thread in registers, each
// sweep ending in a block reduction (warp shuffles, then one warp over
// the per-warp partials in shared memory).
//
// On every path the pack needs no shifting: with element e at bit e % 32
// of word e / 32, a __ballot_sync over 32 consecutive columns IS the wire
// word (lanes past d and masked lanes vote 0). mask == nullptr means
// every slot is valid. The file is compiled with -fmad=false; the
// divisions, adds and the midpoint are the IEEE round-to-nearest
// intrinsics the reference formulas name: b0 = sum / max(cnt, 1),
// thr = 0.5 * (bm + bp). The row sums add in another order than the plain
// version's, so the levels are float-close to it, and bit-equal where
// every partial sum is exact; the words are the exact threshold of the
// kernel's own levels.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kItems = 8;           // row values a block thread keeps
constexpr int kMaxThreads = 1024;   // so d <= kItems * kMaxThreads
constexpr int kWarpMaxNW = 8;       // warp path: d <= kItems * 32 * 8
constexpr int kWarpMaxWarps = 4;    // warps a block on the warp paths
constexpr int kPassThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

enum Path { kPathBlock = 0, kPathBulk = 1, kPathAsync = 2 };

// The reference's clip, jnp.clip(x, -L, L) = min(max(x, -L), L), where a
// NaN value or limit gives NaN (fminf / fmaxf would drop it; the .NaN
// forms of PTX min / max keep it).
__device__ __forceinline__ float clip(float x, float L) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(y) : "f"(x), "f"(-L));
  asm("min.NaN.f32 %0, %1, %2;\n" : "=f"(y) : "f"(y), "f"(L));
  return y;
}

// The reference's term v * sel of a row sum: v where sel, else v * 0, which
// is a zero (adding it leaves a partial as it was: a partial starts at +0
// and never becomes -0) for a finite v and NaN for a NaN or infinite one.
__device__ __forceinline__ float term(bool sel, float v) {
  return sel ? v : __fmul_rn(v, 0.0f);
}

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
  for (int i = 0; i < kItems; ++i) {  // x[i] = 0 past d
    const bool lo = ok[i] && x[i] < b0, hi = ok[i] && x[i] >= b0;
    s[0] = __fadd_rn(s[0], term(lo, x[i]));
    s[2] = __fadd_rn(s[2], term(hi, x[i]));
    if (lo) s[1] = __fadd_rn(s[1], 1.0f);
    if (hi) s[3] = __fadd_rn(s[3], 1.0f);
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
      if (lim) xv = clip(xv, L);
    }
    x[i] = xv;
    ok[i] = col < d && (!mask || mask[base + col]);
    s[0] = __fadd_rn(s[0], term(ok[i], xv));
    if (ok[i]) s[1] = __fadd_rn(s[1], 1.0f);
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

// ---------------------------------------------------------------------------
// warp path
// ---------------------------------------------------------------------------

// Row totals of NQ quantities from a lane's partials p[q][j] (its sum over
// i of column i * 32 NW + 32 j + lane), in the block path's order: each
// (q, j) over the lanes by the xor tree 16, 8, 4, 2, 1, then the per-j
// totals, zero-padded to 32, by the same tree. The reduce-scatter halves
// the slots q * 8 + j a lane holds at each level (its own partial plus
// the partner's, as the tree adds them) until one is left, which is slot
// lane >> SH; the tree over j is then lanes xor 4, 2, 1 (<< SH), its
// levels 16 and 8 adding only the zero padding.
// One level (lane distance OFF) of the reduce-scatter over N slots, then
// the levels below it; every index is a compile-time constant, so the
// slots stay in registers.
template <int N, int OFF>
__device__ __forceinline__ void reduce_scatter(float (&s)[N], int lane) {
  if constexpr (OFF > 0) {
    constexpr int half = (N * OFF) >> 5;  // slots a lane keeps after it
    if constexpr (half >= 1) {
      const bool up = lane & OFF;
#pragma unroll
      for (int k = 0; k < half; ++k) {
        const float keep = up ? s[k + half] : s[k];
        const float send = up ? s[k] : s[k + half];
        s[k] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, OFF));
      }
    } else {
      s[0] = __fadd_rn(s[0], __shfl_xor_sync(kFull, s[0], OFF));
    }
    reduce_scatter<N, OFF / 2>(s, lane);
  }
}

template <int NW, int NQ>
__device__ __forceinline__ void warp_sum(const float (&p)[NQ][NW],
                                         float (&tot)[NQ]) {
  static_assert(NQ == 1 || NQ == 2 || NQ == 4, "slots must split evenly");
  constexpr int N = 8 * NQ;
  constexpr int SH = NQ == 4 ? 0 : NQ == 2 ? 1 : 2;
  const int lane = threadIdx.x & 31;
  float s[N];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[8 * q + j] = j < NW ? p[q][j % NW] : 0.0f;
  reduce_scatter<N, 16>(s, lane);
  // levels 16 and 8 of the tree over j meet only zero lanes (j < NW <= 8)
  float t = __fadd_rn(__fadd_rn(s[0], 0.0f), 0.0f);
#pragma unroll
  for (int off = 4 << SH; off >= 1 << SH; off >>= 1)
    t = __fadd_rn(t, __shfl_xor_sync(kFull, t, off));
#pragma unroll
  for (int q = 0; q < NQ; ++q) tot[q] = __shfl_sync(kFull, t, (8 * q) << SH);
}

template <int K>
__device__ __forceinline__ bool bit(const unsigned (&b)[(K + 31) / 32],
                                    int k) {
  return (b[k >> 5] >> (k & 31)) & 1u;
}

// cond_means for a warp's row in registers (K = 8 NW columns a lane, bit k
// of ok the validity of column lane + 32 k). The exact sweep tests each
// slot's validity and both comparisons, as the block path does, and adds
// the reference's terms v * lo and v * hi of every slot; it serves rows
// with a NaN or an infinity among their values or at b0.
template <int NW>
__device__ __forceinline__ void warp_cond_means_exact(
    const float (&x)[kItems * NW], const unsigned (&ok)[(kItems * NW + 31) / 32],
    float b0, float& bm, float& bp) {
  constexpr int K = kItems * NW;
  float p[2][NW];  // sum below b0, sum at or above b0, per j
  unsigned nlo = 0, nhi = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) p[0][j] = p[1][j] = 0.0f;
#pragma unroll
  for (int i = 0; i < kItems; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int k = i * NW + j;
      const bool lo = bit<K>(ok, k) && x[k] < b0;
      const bool hi = bit<K>(ok, k) && x[k] >= b0;
      p[0][j] = __fadd_rn(p[0][j], term(lo, x[k]));
      p[1][j] = __fadd_rn(p[1][j], term(hi, x[k]));
      nlo += lo;
      nhi += hi;
    }
  float s[2];
  warp_sum<NW, 2>(p, s);
  const float clo = (float)__reduce_add_sync(kFull, nlo);
  const float chi = (float)__reduce_add_sync(kFull, nhi);
  bm = __fdiv_rn(s[0], fmaxf(clo, 1.0f));
  bp = __fdiv_rn(s[1], fmaxf(chi, 1.0f));
  if (!(clo > 0.0f)) bm = bp;
  if (!(chi > 0.0f)) bp = bm;
}

// The same sweep for a row of finite values and a finite b0, where every
// slot is either below b0 or not: one comparison, two predicated adds and
// one count a slot, no validity test. A masked slot holds a zero, and
// adding a zero leaves a partial as it was, so the sums are the exact
// sweep's bits; the masked slots (n_inv of them) are taken back out of
// the side that 0 falls on.
template <int NW>
__device__ __forceinline__ void warp_cond_means_fast(
    const float (&x)[kItems * NW], float b0, unsigned n_inv, float& bm,
    float& bp) {
  constexpr int K = kItems * NW;
  float p[2][NW];
  unsigned nlo = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) p[0][j] = p[1][j] = 0.0f;
#pragma unroll
  for (int i = 0; i < kItems; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j)  // predicated, not two adds and selects
      asm("{\n .reg .pred lo;\n"
          " setp.lt.f32 lo, %3, %4;\n"
          " @lo add.rn.f32 %0, %0, %3;\n"
          " @!lo add.rn.f32 %1, %1, %3;\n"
          " @lo add.u32 %2, %2, 1;\n}\n"
          : "+f"(p[0][j]), "+f"(p[1][j]), "+r"(nlo)
          : "f"(x[i * NW + j]), "f"(b0));
  float s[2];
  warp_sum<NW, 2>(p, s);
  unsigned lo = __reduce_add_sync(kFull, nlo), hi = 32 * K - lo;
  if (0.0f < b0)
    lo -= n_inv;
  else
    hi -= n_inv;
  const float clo = (float)lo, chi = (float)hi;
  bm = __fdiv_rn(s[0], fmaxf(clo, 1.0f));
  bp = __fdiv_rn(s[1], fmaxf(chi, 1.0f));
  if (!(clo > 0.0f)) bm = bp;
  if (!(chi > 0.0f)) bp = bm;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// One lane: copy row `row`'s values (4 d bytes) and mask bytes (d) into
// the warp's stage with 1-D bulk copies (TMA), completing on `bar`. The
// stage was last read by the warp's lanes before a __syncwarp; the proxy
// fence orders those reads before the copy's writes.
__device__ __forceinline__ void stage_row(float* sv, uint8_t* sm,
                                          uint64_t* bar, const float* v,
                                          const uint8_t* mask, int row,
                                          int d) {
  const size_t base = (size_t)row * d;
  const uint32_t vb = 4u * d, mb = mask ? (uint32_t)d : 0u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(vb + mb) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(sv)), "l"(v + base), "r"(vb), "r"(smem_addr(bar))
      : "memory");
  if (mask)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(sm)), "l"(mask + base), "r"(mb),
           "r"(smem_addr(bar))
        : "memory");
}

// The fit, threshold and pack of one row held in a warp's registers: x[k]
// at column lane + 32 k (clipped, times 0 where masked, 0 past d) and its
// validity bit k of ok.
template <int NW>
__device__ __forceinline__ void fit_and_pack(
    const float (&x)[kItems * NW], const unsigned (&ok)[(kItems * NW + 31) / 32],
    uint32_t* __restrict__ words, float* __restrict__ levels, int row, int d,
    int lloyd_iters) {
  constexpr int K = kItems * NW;
  constexpr int KB = (K + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int nw = (d + 31) >> 5;
  float p[1][NW];
  unsigned n = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) p[0][j] = 0.0f;
#pragma unroll
  for (int i = 0; i < kItems; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j)  // a masked slot holds the term v * 0
      p[0][j] = __fadd_rn(p[0][j], x[i * NW + j]);
#pragma unroll
  for (int b = 0; b < KB; ++b) n += __popc(ok[b]);
  float sum[1];
  warp_sum<NW, 1>(p, sum);
  n = __reduce_add_sync(kFull, n);
  float b0 = __fdiv_rn(sum[0], fmaxf((float)n, 1.0f));  // paper: mean(G)
  // a NaN or an infinity in any slot makes the sum NaN or infinite
  const bool finite = fabsf(sum[0]) < INFINITY;
  const unsigned n_inv = 32 * K - n;
  float bm, bp;
  for (int it = 0;; ++it) {
    if (finite && fabsf(b0) < INFINITY)
      warp_cond_means_fast<NW>(x, b0, n_inv, bm, bp);
    else
      warp_cond_means_exact<NW>(x, ok, b0, bm, bp);
    if (it == lloyd_iters) break;
    b0 = __fmul_rn(0.5f, __fadd_rn(bm, bp));
  }
  const float thr = __fmul_rn(0.5f, __fadd_rn(bm, bp));  // Eq. (17)

  unsigned w[KB];
#pragma unroll
  for (int b = 0; b < KB; ++b) w[b] = 0u;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const unsigned word = __ballot_sync(kFull, bit<K>(ok, k) && x[k] >= thr);
    if (lane == (k & 31)) w[k >> 5] = word;
  }
#pragma unroll
  for (int b = 0; b < KB; ++b)
    if (32 * b + lane < nw) words[(size_t)row * nw + 32 * b + lane] = w[b];
  if (lane == 0) reinterpret_cast<float2*>(levels)[row] = make_float2(bm, bp);
}

// All lanes: copy row `row` into the stage with 4-byte asynchronous copies
// (cp.async), for rows a bulk copy cannot take: the values column by
// column; the mask bytes as the 4-byte words of the aligned window around
// the row, so that its byte c lands at sm[base % 4 + c], the last word of
// the tensor (nbytes of mask) cut at its end.
__device__ __forceinline__ void copy_row(float* sv, uint8_t* sm,
                                         const float* v,
                                         const uint8_t* mask, int row,
                                         int d, size_t nbytes) {
  const int lane = threadIdx.x & 31;
  const size_t base = (size_t)row * d;
  for (int col = lane; col < d; col += 32)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_addr(sv + col)), "l"(v + base + col)
                 : "memory");
  if (mask) {
    const size_t a = base & ~(size_t)3;
    const int nwords = (int)((base - a + d + 3) >> 2);
    for (int w = lane; w < nwords; w += 32) {
      const size_t at = a + 4 * (size_t)w;
      const uint32_t n = nbytes - at < 4 ? (uint32_t)(nbytes - at) : 4u;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(smem_addr(sm + 4 * w)), "l"(mask + at), "r"(n)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Warp paths: a warp per row, rows strided over the grid's warps. Each
// warp owns a stage of 40 nt + 128 bytes of dynamic shared memory (128
// bytes apart): the values of columns 0..8 nt (4 bytes each), then their
// mask bytes (and room for the 4-byte copies' window); the columns past d
// stay zero, and without a mask the mask bytes are 1 up to d. As soon as row r is in its registers, the warp starts copying its
// next row into the stage, which lands while r is fitted and packed: a
// warp always has a row's bytes in flight, and no block barrier is taken.
// BULK (d a multiple of 16, tensors on 16 bytes): lane 0 issues two 1-D
// bulk copies (TMA) completing on the warp's mbarrier, and the reads need
// no bounds. Else every lane issues 4-byte cp.async copies (copy_row).
template <int NW, bool BULK>
__global__ void __launch_bounds__(32 * kWarpMaxWarps, 3)
    encode_bingrad_warp_kernel(const float* __restrict__ v,
                               const uint8_t* __restrict__ mask,
                               const float* __restrict__ lim,
                               uint32_t* __restrict__ words,
                               float* __restrict__ levels, int nb, int d,
                               int lloyd_iters) {
  constexpr int K = kItems * NW;
  constexpr int KB = (K + 31) / 32;
  constexpr int C = 32 * K;  // columns of a stage
  extern __shared__ __align__(128) uint8_t stage[];
  __shared__ uint64_t bars[kWarpMaxWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = gridDim.x * (blockDim.x >> 5);
  float* sv = reinterpret_cast<float*>(stage + (size_t)warp * (5 * C + 128));
  uint8_t* sm = reinterpret_cast<uint8_t*>(sv + C);
  uint64_t* bar = &bars[warp];
  const size_t nbytes = (size_t)nb * d;
  for (int col = lane; col < C; col += 32) {
    if (col >= d) sv[col] = 0.0f;
    if (col >= d || !mask) sm[col] = col < d;
  }
  __syncwarp();
  int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if constexpr (BULK) {
    if (lane == 0) {
      mbar_init(bar);
      if (row < nb) stage_row(sv, sm, bar, v, mask, row, d);
    }
  } else if (row < nb) {
    copy_row(sv, sm, v, mask, row, d, nbytes);
  }
  __syncwarp();
  for (uint32_t parity = 0; row < nb; row += stride, parity ^= 1u) {
    float x[K];
    unsigned ok[KB];
    int off = 0;  // where the row's mask bytes start in the stage
    const float L = lim ? lim[row] : 0.0f;
    if constexpr (BULK) {
      mbar_wait(bar, parity);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncwarp();
      if (mask) off = (int)(((size_t)row * d) & 3);
    }
#pragma unroll
    for (int b = 0; b < KB; ++b) ok[b] = 0u;
#pragma unroll
    for (int k = 0; k < K; ++k) {  // past d: value 0 (and no bounds if BULK)
      const int col = 32 * k + lane;
      const bool m = (BULK || col < d) && sm[off + col];
      x[k] = sv[col];
      ok[k >> 5] |= (unsigned)m << (k & 31);
    }
    __syncwarp();
    if (row + stride < nb) {
      if constexpr (BULK) {
        if (lane == 0) stage_row(sv, sm, bar, v, mask, row + stride, d);
      } else {
        copy_row(sv, sm, v, mask, row + stride, d, nbytes);
      }
    }
    // the reference's terms v * m, clipped first (a NaN limit also turns
    // the zeros past d to NaN, in a row whose every value is NaN already)
    if (lim) {
#pragma unroll
      for (int k = 0; k < K; ++k) x[k] = term(bit<K>(ok, k), clip(x[k], L));
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) x[k] = term(bit<K>(ok, k), x[k]);
    }
    fit_and_pack<NW>(x, ok, words, levels, row, d, lloyd_iters);
  }
}

// smem <= 4 warps x (40 * 256 + 128) bytes: within the default 48 KB
template <int NW>
cudaError_t launch_warp(bool bulk, int grid, int warps, int smem,
                        cudaStream_t stream, const float* v,
                        const uint8_t* mask, const float* lim,
                        uint32_t* words, float* levels, int nb, int d,
                        int lloyd_iters) {
  if (bulk)
    encode_bingrad_warp_kernel<NW, true><<<grid, 32 * warps, smem, stream>>>(
        v, mask, lim, words, levels, nb, d, lloyd_iters);
  else
    encode_bingrad_warp_kernel<NW, false><<<grid, 32 * warps, smem, stream>>>(
        v, mask, lim, words, levels, nb, d, lloyd_iters);
  return cudaGetLastError();
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
    const bool hi = ok && x >= t;
    const bool lo = ok && !(x >= t);  // (1 - (v >= b0)) * m, as written
    idx[i] = hi ? 1 : 0;
    s[0] = __fadd_rn(s[0], term(lo, x));
    s[2] = __fadd_rn(s[2], term(hi, x));
    if (lo) s[1] = __fadd_rn(s[1], 1.0f);
    if (hi) s[3] = __fadd_rn(s[3], 1.0f);
  }
  block_sum<4>(s, red);
  if (threadIdx.x < 4) part[4 * (size_t)row + threadIdx.x] = s[threadIdx.x];
}

}  // namespace

extern "C" {

// v, lim: float32 (lim (nb,) or null = no clip); mask: bool bytes (null =
// every slot valid); words: (nb, ceil(d / 32)) uint32; levels: (nb, 2)
// float32. path / warps / grid / smem: the launch plan of
// fused_bingrad.launch_plan (smem: dynamic shared bytes, 40 nt + 128 a warp
// on the warp paths, 0 on the block path); a plan that does not fit d or
// the tensors' alignment is refused. Returns
// cudaGetLastError().
int repro_encode_bingrad(const void* v, const void* mask, const void* lim,
                         void* words, void* levels, int nb, int d,
                         int lloyd_iters, int path, int warps, int grid,
                         int smem, void* stream) {
  if (nb <= 0 || d <= 0 || d > kItems * kMaxThreads || lloyd_iters < 0 ||
      grid <= 0)
    return (int)cudaErrorInvalidValue;
  // the block path's threads; nt / 32 is the warp paths' NW
  const int nt = ((d + kItems - 1) / kItems + 31) / 32 * 32;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* fv = (const float*)v;
  const uint8_t* m = (const uint8_t*)mask;
  const float* fl = (const float*)lim;
  uint32_t* w = (uint32_t*)words;
  float* lv = (float*)levels;
  if (path == kPathBlock) {
    if (warps != nt / 32 || grid != nb || smem != 0)
      return (int)cudaErrorInvalidValue;
    encode_bingrad_kernel<<<nb, nt, 0, s>>>(fv, m, fl, w, lv, d,
                                            lloyd_iters);
    return (int)cudaGetLastError();
  }
  const bool bulk = path == kPathBulk;
  const uintptr_t align = (uintptr_t)v | (uintptr_t)mask;
  if ((!bulk && path != kPathAsync) || nt / 32 > kWarpMaxNW || warps < 1 ||
      warps > kWarpMaxWarps || smem != (40 * nt + 128) * warps ||
      align % (bulk ? 16 : 4) != 0 || (bulk && d % 16 != 0))
    return (int)cudaErrorInvalidValue;
  switch (nt / 32) {
#define REPRO_WARP_CASE(NW)                                                \
  case NW:                                                                 \
    return (int)launch_warp<NW>(bulk, grid, warps, smem, s, fv, m, fl, w,  \
                                lv, nb, d, lloyd_iters);
    REPRO_WARP_CASE(1) REPRO_WARP_CASE(2) REPRO_WARP_CASE(3)
    REPRO_WARP_CASE(4) REPRO_WARP_CASE(5) REPRO_WARP_CASE(6)
    REPRO_WARP_CASE(7)
#undef REPRO_WARP_CASE
    default:
      return (int)launch_warp<8>(bulk, grid, warps, smem, s, fv, m, fl, w,
                                 lv, nb, d, lloyd_iters);
  }
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
