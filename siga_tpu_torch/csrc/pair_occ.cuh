// Occ counts from one row of the FM-index pair plane, shared by K1
// (scan_pair.cu) and K7 (kmer_count.cu).
//
// A pair-plane row (57 int32) covers one 128-symbol BWT block: 8 words of the
// current symbols and 8 of the previous ones (codes[LF(r)]), 2 bits a symbol
// as rank - 1, then their '$' masks in even-bit format (8 + 8 words), then 25
// exclusive pair checkpoints ckpt[p * 5 + c] = #{rows before the block with
// symbol c and previous symbol p}.
#pragma once

#include <cuda_runtime.h>

namespace pair_occ {

constexpr int kCols = 57;  // 8 cur | 8 prev | 8 cur '$' | 8 prev '$' | 25 ckpt
constexpr int kSample = 128;
constexpr unsigned kLo = 0x55555555u;

__device__ __forceinline__ unsigned match2(unsigned w, unsigned pattern) {
  const unsigned x = w ^ pattern;
  return ~(x | (x >> 1)) & kLo;
}

// Even-bit masks of the positions holding each symbol ('$' from its mask).
__device__ __forceinline__ void sym_masks(unsigned w, unsigned d, unsigned m[5]) {
  m[0] = d;
  m[1] = match2(w, 0u) & ~d;
  m[2] = match2(w, kLo);
  m[3] = match2(w, 0xAAAAAAAAu);
  m[4] = match2(w, 0xFFFFFFFFu);
}

template <typename T>
__device__ __forceinline__ T sel5(const T a[5], int c) {
  T out = a[0];
#pragma unroll
  for (int r = 1; r < 5; ++r) out = (c == r) ? a[r] : out;
  return out;
}

// Inclusive occ at BWT position i (i >= -1) of the table whose rows start at
// row `tab` of `plane` (`nrows` rows in all): s[c] = occ_c(i); with PAIRS,
// p[q] = occ2((q, c1), i), the rows up to i holding c1 whose previous symbol
// is q (0 when c1 = 0).
template <bool PAIRS>
__device__ __forceinline__ void occ_row(const int* plane, int nrows, int tab,
                                        int i, int c1, int s[5], int p[5]) {
  const int pos = i + 1;
  const int block0 = pos / kSample;
  const int tail = pos - block0 * kSample;
  const int row_i = min(max(block0 + tab, 0), nrows - 1);
  const int* row = plane + static_cast<size_t>(row_i) * kCols;
  const int* ck = row + 32;
#pragma unroll
  for (int c = 0; c < 5; ++c)
    s[c] = __ldg(ck + c) + __ldg(ck + 5 + c) + __ldg(ck + 10 + c) +
           __ldg(ck + 15 + c) + __ldg(ck + 20 + c);
  if (PAIRS) {
#pragma unroll
    for (int q = 0; q < 5; ++q) p[q] = c1 > 0 ? __ldg(ck + q * 5 + c1) : 0;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int valid = tail - 16 * k;
    if (valid <= 0) break;
    const unsigned wm = valid >= 16 ? 0xFFFFFFFFu : ((1u << (2 * valid)) - 1u);
    unsigned cm[5];
    sym_masks(__ldg(row + k), __ldg(row + 16 + k), cm);
#pragma unroll
    for (int c = 0; c < 5; ++c) s[c] += __popc(cm[c] & wm);
    if (PAIRS && c1 > 0) {
      const unsigned mc1 = sel5(cm, c1) & wm;
      unsigned pm[5];
      sym_masks(__ldg(row + 8 + k), __ldg(row + 24 + k), pm);
#pragma unroll
      for (int q = 0; q < 5; ++q) p[q] += __popc(pm[q] & mc1);
    }
  }
}

}  // namespace pair_occ
