// The round stage shared by the encode kernels (encode_fused.cu: encode,
// qdq) and the multi-pass quant_rr kernel (multipass.cu): one element's
// clip -> interval search -> rounding decision, in the reference's
// float32 arithmetic. Included by each source that uses it;
// build.library_path hashes every csrc/*.cuh into each library's name, so
// an edit here rebuilds them all.
//
// Exactness: the sources that include this header are compiled with
// -fmad=false and without fast math, so every operation below rounds as
// the plain PyTorch version's float32 tensor op does (the divide is IEEE
// round-to-nearest, no multiply-add is contracted, the uint32 -> float
// conversion rounds to nearest and the 2^-32 scale is exact).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kMaxLevels = 17;

enum Mode { kRR = 0, kBin = 1, kSign = 2 };

// clip -> interval search -> round for one element x of a row whose level
// table lv (ascending, s entries, as every level fit gives) is in fast
// memory. L is the row's clip limit (used when has_lim); rb the element's
// rounding word (mode rr).
__device__ __forceinline__ uint32_t round_index(float x, const float* lv,
                                                int s, int mode, bool has_lim,
                                                float L, uint32_t rb) {
  if (has_lim) x = fminf(L, fmaxf(-L, x));
  if (mode == kRR) {
    // Interval search fused with the neighbour-level selection: the
    // table is ascending, so (x >= lv_j) is a prefix predicate and the
    // running selects end at lo = lv[k], hi = lv[k + 1].
    int k = 0;
    float lo = lv[0], hi = lv[1];
    bool ge_prev = false;
    for (int j = 0; j < s; ++j) {
      const bool ge = x >= lv[j];
      k += ge;
      if (j >= 1 && j <= s - 2 && ge) lo = lv[j];
      if (j >= 2 && ge_prev) hi = lv[j];
      ge_prev = ge;
    }
    k = min(max(k - 1, 0), s - 2);
    const float vc = fminf(fmaxf(x, lo), hi);
    const float width = __fsub_rn(hi, lo);
    const float p_up =
        width > 0.0f ? __fdiv_rn(__fsub_rn(vc, lo), width) : 0.0f;
    const float u = __fmul_rn(__uint2float_rn(rb),
                              2.3283064365386963e-10f);  // 2^-32
    return (uint32_t)k + (u < p_up ? 1u : 0u);
  }
  if (mode == kBin) {
    const float thr = __fmul_rn(0.5f, __fadd_rn(lv[0], lv[1]));
    return x >= thr ? 1u : 0u;
  }
  return x >= 0.0f ? 1u : 0u;
}

}  // namespace repro
