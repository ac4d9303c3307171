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
// What bounds it on an H100: bytes. Each sequence's packed context is
// read once per KV head group; at decode (B 8, C 512, d 768, 4-bit words)
// K and V words and tables of a full context are ~3.4 MB a layer, about
// 1 us at 3.35 TB/s, while the f32 arithmetic is ~13 MFLOP. A masked
// position adds exactly 0, so the function needs only the rows up to each
// sequence's last admitted position; this kernel still walks every tile.
//
// Design: the TPU kernel decodes a sequence's whole context into VMEM; at
// C = 512, d = 768 that is 1.5 MB each for K and V, far over the 227 KB of
// shared memory. Here the grid is (sequence, KV head, query tile); a block
// walks the context in tiles of 32 tokens, unpacks and level-decodes the
// tile's K and V slices for its KV head into shared memory, and each warp
// carries one query row (t, head) with a streaming (online) softmax in
// f32: lane l scores token l of the tile, the running max / sum rescale
// the accumulator, and lane l owns output dims l, l + 32, ... Dequantized
// values never touch device memory. Simple first: no tensor cores, no
// TMA, and every query tile of a (sequence, KV head) decodes the context
// again.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;      // context tokens per tile (= warp width)
constexpr int kWarps = 4;      // query rows per block
constexpr int kMaxLevels = 17;
constexpr float kMasked = -2.0e38f;

template <int HD>
__global__ void decode_attend_kernel(
    const float* __restrict__ q, const uint32_t* __restrict__ kw,
    const float* __restrict__ klv, const uint32_t* __restrict__ vw,
    const float* __restrict__ vlv, const uint8_t* __restrict__ mask,
    float* __restrict__ out, int T, int H, int KV, int C, int nw, int s,
    int bits, float scale, float softcap) {
  constexpr int kPerLane = HD / 32;
  __shared__ float ks[kTile][HD + 1];  // +1: lanes read rows, no conflicts
  __shared__ float vs[kTile][HD];
  __shared__ float qs[kWarps][HD];
  __shared__ float lk[kTile][kMaxLevels];
  __shared__ float lvv[kTile][kMaxLevels];

  const int b = blockIdx.x, kvh = blockIdx.y;
  const int g = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.z * kWarps + warp;  // query row (t, head in group)
  const bool active = r < T * g;
  const int t = active ? r / g : 0;
  const int h = kvh * g + (active ? r % g : 0);
  const size_t qoff = (((size_t)b * T + t) * H + h) * HD;
  if (active)
    for (int j = lane; j < HD; j += 32) qs[warp][j] = q[qoff + j];

  const int epw = 32 / bits;
  const uint32_t cmask = (1u << bits) - 1u;
  const size_t ctx = (size_t)b * C;  // first context row of sequence b
  const uint8_t* mrow = mask + ((size_t)b * T + t) * C;

  float m = -INFINITY, l = 0.0f;
  float acc[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) acc[k] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kTile * s; i += blockDim.x) {
      const int c = i / s, j = i % s;
      const bool in = c0 + c < C;
      lk[c][j] = in ? klv[(ctx + c0 + c) * s + j] : 0.0f;
      lvv[c][j] = in ? vlv[(ctx + c0 + c) * s + j] : 0.0f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * HD; i += blockDim.x) {
      const int c = i / HD, j = i % HD;
      float kval = 0.0f, vval = 0.0f;
      if (c0 + c < C) {
        const int e = kvh * HD + j;  // element of the token's d-row
        const size_t wi = (ctx + c0 + c) * nw + e / epw;
        const int sh = bits * (e % epw);
        const uint32_t kc = (kw[wi] >> sh) & cmask;
        const uint32_t vc = (vw[wi] >> sh) & cmask;
        kval = kc < (uint32_t)s ? lk[c][kc] : 0.0f;
        vval = vc < (uint32_t)s ? lvv[c][vc] : 0.0f;
      }
      ks[c][j] = kval;
      vs[c][j] = vval;
    }
    __syncthreads();
    if (!active) continue;

    const int cc = c0 + lane;
    float sc = -INFINITY;  // past the context end: excluded entirely
    if (cc < C) {
      float dot = 0.0f;
#pragma unroll 16
      for (int j = 0; j < HD; ++j) dot += qs[warp][j] * ks[lane][j];
      sc = dot * scale;
      if (softcap != 0.0f) sc = tanhf(sc / softcap) * softcap;
      if (!mrow[cc]) sc = kMasked;
    }
    float tmax = sc;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const float m_new = fmaxf(m, tmax);  // finite: lane 0 is in range
    const float p = cc < C ? expf(sc - m_new) : 0.0f;
    const float corr = expf(m - m_new);  // 0 on the first tile
    float psum = p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * corr + psum;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) acc[k] *= corr;
    for (int c = 0; c < kTile; ++c) {
      const float pc = __shfl_sync(0xffffffffu, p, c);
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) acc[k] += pc * vs[c][lane + 32 * k];
    }
    m = m_new;
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) out[qoff + lane + 32 * k] = acc[k] / l;
  }
}

template <int HD>
int launch(const void* q, const void* kw, const void* klv, const void* vw,
           const void* vlv, const void* mask, void* out, int B, int T, int H,
           int KV, int C, int nw, int s, int bits, float scale, float softcap,
           cudaStream_t stream) {
  const int rows = T * (H / KV);
  dim3 grid(B, KV, (rows + kWarps - 1) / kWarps);
  decode_attend_kernel<HD><<<grid, kWarps * 32, 0, stream>>>(
      (const float*)q, (const uint32_t*)kw, (const float*)klv,
      (const uint32_t*)vw, (const float*)vlv, (const uint8_t*)mask,
      (float*)out, T, H, KV, C, nw, s, bits, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// shapes the kernel does not take: hd must be 32, 64 or 128).
int repro_decode_attend(const void* q, const void* kw, const void* klv,
                        const void* vw, const void* vlv, const void* mask,
                        void* out, int B, int T, int H, int KV, int hd, int C,
                        int nw, int s, int bits, float scale, float softcap,
                        void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || KV <= 0 || H % KV != 0 || s < 1 ||
      s > kMaxLevels || bits < 1 || bits > 5 ||
      (long long)nw * (32 / bits) < (long long)KV * hd)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 32:
      return launch<32>(q, kw, klv, vw, vlv, mask, out, B, T, H, KV, C, nw,
                        s, bits, scale, softcap, st);
    case 64:
      return launch<64>(q, kw, klv, vw, vlv, mask, out, B, T, H, KV, C, nw,
                        s, bits, scale, softcap, st);
    case 128:
      return launch<128>(q, kw, klv, vw, vlv, mask, out, B, T, H, KV, C, nw,
                         s, bits, scale, softcap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
