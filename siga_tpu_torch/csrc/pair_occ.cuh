// Occ counts from one row of the FM-index pair plane, read by a group of
// threads; shared by K1 (scan_pair.cu) and K7 (kmer_count.cu).
//
// A pair-plane row (57 int32) covers one 128-symbol BWT block: 8 words of the
// current symbols and 8 of the previous ones (codes[LF(r)]), 2 bits a symbol
// as rank - 1, then their '$' masks in even-bit format (8 + 8 words), then 25
// exclusive pair checkpoints ckpt[p * 5 + c] = #{rows before the block with
// symbol c and previous symbol p}.
//
// Lane groups.  kGroup = 8 consecutive threads (a quarter warp) serve one
// search (a K1 lane, a K7 k-mer) and read its rows together: thread j loads
// word j of each of the four bit planes and checkpoints j, j + 8, j + 16 (and
// 24 for j = 0), so a group reads a plane's 8 words as one 32-byte access
// instead of one thread issuing 57 scalar loads.  Each thread
// counts its words below the query position (popcounts of even-bit match
// masks) and its checkpoints, and the group sums only the counts the caller
// uses (a butterfly of shuffles over the group's mask).  Every branch on the
// query depends on group-uniform values only (the position, c1, c2).
#pragma once

#include <cuda_runtime.h>

namespace pair_occ {

constexpr int kCols = 57;  // 8 cur | 8 prev | 8 cur '$' | 8 prev '$' | 25 ckpt
constexpr int kSample = 128;
constexpr unsigned kLo = 0x55555555u;
// Threads a search.  Groups of 4 were also built and measured on an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md): 8 ran the pipeline's 1,170
// contig lanes in 21.6-22.5 ms against 31.8-33.0 ms for 4 (a lane's chain of
// dependent row reads is shorter when each thread does less of a row), and
// 3 or 110 k-mers of K7 in 0.016-0.017 ms against 0.020-0.021; 4 was ahead
// only where the lanes fill the card, within the runs' spread at the
// 60,608-lane reads chunk (1.50-1.77 ms against 1.58-2.13) and by 8% at
// 262,144 k-mers (0.473 against 0.509 ms).  Both beat the one-thread design
// at every shape measured, so one group size is kept.
constexpr int kGroup = 8;

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

// Even-bit mask of the positions of word w ('$' mask d) holding rank c:
// '$' is code 0 with its mask bit set, rank c >= 1 is code c - 1.
__device__ __forceinline__ unsigned rank_mask(unsigned w, unsigned d, int c) {
  const unsigned m = match2(w, static_cast<unsigned>(max(c - 1, 0)) * kLo);
  return c == 0 ? d : c == 1 ? (m & ~d) : m;
}

// Even-bit mask of the positions holding a rank below c: '$' (code 0) and
// the codes below c - 1, read off the code's high and low bits.
__device__ __forceinline__ unsigned below_mask(unsigned w, unsigned d, int c) {
  const unsigned hi = (w >> 1) & kLo, lo = w & kLo;
  return c == 0   ? 0u
         : c == 1 ? d
         : c == 2 ? ~(hi | lo) & kLo
         : c == 3 ? ~hi & kLo
                  : ~(hi & lo) & kLo;
}

// The mask of the threads of the calling thread's group within its warp.
__device__ __forceinline__ unsigned group_mask() {
  const unsigned first = (threadIdx.x & 31u) & ~static_cast<unsigned>(kGroup - 1);
  return ((1u << kGroup) - 1u) << first;
}

// The group's sum of v, in every thread of the group: a butterfly of
// shuffles.  (__reduce_add_sync over the group's mask gives the same sums,
// but K1 and K7 ran several times slower with it on the H100 whenever a
// warp held more than one group.)
__device__ __forceinline__ unsigned group_sum(unsigned gmask, unsigned v) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off /= 2) v += __shfl_xor_sync(gmask, v, off, kGroup);
  return v;
}

// Valid-position mask of word k for a block prefix of `tail` symbols.
__device__ __forceinline__ unsigned tail_mask(int tail, int k) {
  const int valid = tail - 16 * k;
  return valid <= 0 ? 0u : valid >= 16 ? 0xFFFFFFFFu : ((1u << (2 * valid)) - 1u);
}

// Thread j's share of the row that holds BWT position i (i >= -1) of the
// table whose rows start at `tab` (`nrows` rows in all): the prefix of the
// block up to and including i is `tail` symbols long.
struct RowSlice {
  static constexpr int kW = 8 / kGroup;                  // words of each bit plane
  static constexpr int kC = (25 + kGroup - 1) / kGroup;  // checkpoints
  unsigned cur[kW], curd[kW], prev[kW], prevd[kW];
  unsigned ck[kC];
  int tail;

  // `with_prev`: also load the previous-symbol planes (the pair counts need
  // them; group-uniform).  Words past the tail are not read.
  __device__ __forceinline__ void load(const int* plane, int nrows, int tab, int i,
                                       int j, bool with_prev) {
    const int pos = i + 1;
    const int block0 = pos / kSample;
    tail = pos - block0 * kSample;
    const int row_i = min(max(block0 + tab, 0), nrows - 1);
    const unsigned* row =
        reinterpret_cast<const unsigned*>(plane) + static_cast<size_t>(row_i) * kCols;
#pragma unroll
    for (int m = 0; m < kW; ++m) {
      const int k = j + kGroup * m;
      const bool need = 16 * k < tail;
      cur[m] = need ? __ldg(row + k) : 0u;
      curd[m] = need ? __ldg(row + 16 + k) : 0u;
      prev[m] = need && with_prev ? __ldg(row + 8 + k) : 0u;
      prevd[m] = need && with_prev ? __ldg(row + 24 + k) : 0u;
    }
#pragma unroll
    for (int m = 0; m < kC; ++m) {
      const int k = j + kGroup * m;
      ck[m] = k < 25 ? __ldg(row + 32 + k) : 0u;
    }
  }
};

// What a pair superstep reads from one row, summed over the group: with
// s[c] = occ_c(i) and p[q] = occ2((q, c1), i) (0 when c1 = 0),
//   s_c1 = s[c1], s_below = sum_{r < c1} s[r], s_0 = s[0],
//   p_c2 = p[c2], p_below = sum_{q < c2} p[q], p_0 = p[0].
// With ALL false only s_c1 and p_c2 are summed (K7); the rest are 0.
struct StepCounts {
  int s_c1, s_below, s_0, p_c2, p_below, p_0;
};

template <bool ALL>
__device__ __forceinline__ StepCounts step_counts(const RowSlice& r, int j,
                                                  int c1, int c2, unsigned gmask) {
  unsigned v[6] = {0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int m = 0; m < RowSlice::kC; ++m) {
    const int k = j + kGroup * m;
    const int q = k / 5, c = k - 5 * (k / 5);
    const unsigned x = r.ck[m];  // 0 past column 24
    v[0] += c == c1 ? x : 0u;
    if (ALL) {
      v[1] += c < c1 ? x : 0u;
      v[2] += c == 0 ? x : 0u;
    }
    if (c1 > 0 && c == c1) {
      v[3] += q == c2 ? x : 0u;
      if (ALL) {
        v[4] += q < c2 ? x : 0u;
        v[5] += q == 0 ? x : 0u;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < RowSlice::kW; ++m) {
    const unsigned wm = tail_mask(r.tail, j + kGroup * m);
    const unsigned mc1 = rank_mask(r.cur[m], r.curd[m], c1) & wm;
    v[0] += __popc(mc1);
    if (ALL) {
      v[1] += __popc(below_mask(r.cur[m], r.curd[m], c1) & wm);
      v[2] += __popc(r.curd[m] & wm);
    }
    if (c1 > 0) {
      v[3] += __popc(rank_mask(r.prev[m], r.prevd[m], c2) & mc1);
      if (ALL) {
        v[4] += __popc(below_mask(r.prev[m], r.prevd[m], c2) & mc1);
        v[5] += __popc(r.prevd[m] & mc1);
      }
    }
  }
  StepCounts out;
  out.s_c1 = static_cast<int>(group_sum(gmask, v[0]));
  out.p_c2 = static_cast<int>(group_sum(gmask, v[3]));
  if (ALL) {
    out.s_below = static_cast<int>(group_sum(gmask, v[1]));
    out.s_0 = static_cast<int>(group_sum(gmask, v[2]));
    out.p_below = static_cast<int>(group_sum(gmask, v[4]));
    out.p_0 = static_cast<int>(group_sum(gmask, v[5]));
  } else {
    out.s_below = out.s_0 = out.p_below = out.p_0 = 0;
  }
  return out;
}

// All five single-symbol counts s[c] = occ_c(i) of a row, summed over the
// group (the finals, and the interval that opens a search).
__device__ __forceinline__ void singles(const RowSlice& r, int j, unsigned gmask,
                                        int s[5]) {
  unsigned v[5] = {0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int m = 0; m < RowSlice::kC; ++m) {
    const int k = j + kGroup * m;
    const int c = k - 5 * (k / 5);
#pragma unroll
    for (int r5 = 0; r5 < 5; ++r5) v[r5] += c == r5 ? r.ck[m] : 0u;
  }
#pragma unroll
  for (int m = 0; m < RowSlice::kW; ++m) {
    const unsigned wm = tail_mask(r.tail, j + kGroup * m);
    unsigned cm[5];
    sym_masks(r.cur[m], r.curd[m], cm);
#pragma unroll
    for (int c = 0; c < 5; ++c) v[c] += __popc(cm[c] & wm);
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) s[c] = static_cast<int>(group_sum(gmask, v[c]));
}

}  // namespace pair_occ
