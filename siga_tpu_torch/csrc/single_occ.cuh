// What the single-step scans K3 (scan_single.cu) and K9 (stage_a.cu) share:
// a 64-byte single-step plane row read as four 16-byte vectors, where a BWT
// position is counted, and the popcount counts of a row's block prefix.
//
// A single-step row (16 int32) covers one 128-symbol BWT block: 8 words of
// 2-bit symbols ('$' packs as A, code 0), 4 words of the '$' mask (one bit a
// symbol) and the exclusive A, C, G, T checkpoints; the '$' checkpoint is
// block * 128 minus their sum.
#pragma once

#include <cuda_runtime.h>

namespace single_occ {

constexpr int kCols = 16;  // 8 symbol words | 4 '$' words | A, C, G, T checkpoints
constexpr int kSample = 128;
constexpr unsigned kLo = 0x55555555u;

// A plane in one allocation: row r at r * 64 bytes.
struct WholePlane {
  const int* plane;

  __device__ __forceinline__ const uint4* row(int r) const {
    return reinterpret_cast<const uint4*>(plane) + static_cast<size_t>(r) * (kCols / 4);
  }
};

// One single-step row as its four 16-byte vectors.
struct Row {
  uint4 s0, s1;  // symbol words 0-3 and 4-7
  uint4 d;       // '$' mask words 0-3
  uint4 ck;      // exclusive A, C, G, T checkpoints
};

template <class Plane>
__device__ __forceinline__ Row load_row(const Plane& plane, int r) {
  const uint4* p = plane.row(r);
  return Row{__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};
}

// The vectors of row r that counts below `tail` read (a step's rows): the
// checkpoints, the '$' words and symbol words 0-3 for tail > 0, words 4-7 for
// tail > 64.  The others keep what they held: every count masks them out.
template <class Plane>
__device__ __forceinline__ void load_below(const Plane& plane, int r, int tail, Row& row) {
  const uint4* p = plane.row(r);
  row.ck = __ldg(p + 3);
  if (tail > 0) {
    row.s0 = __ldg(p);
    row.d = __ldg(p + 2);
  }
  if (tail > 64) row.s1 = __ldg(p + 1);
}

// Where BWT position i (i >= -1) of the table whose rows start at `tab`
// is counted: its row, clamped to the plane's `nrows` rows so that no query
// reads past the plane, its block, and the length of the block's prefix up
// to and including i (floor division, as the plain version's).
struct Where {
  int row, block0, tail;
};

__device__ __forceinline__ Where where(int i, int tab, int nrows) {
  static_assert(kSample == 128, "block and tail by shift and mask");
  const int pos = i + 1;
  const int block0 = pos >> 7;
  return Where{min(max(block0 + tab, 0), nrows - 1), block0, pos & (kSample - 1)};
}

// The bits of 2-bit symbol word k (1-bit '$' word k) that lie below `tail`.
__device__ __forceinline__ unsigned sym_below(int tail, int k) {
  return __funnelshift_lc(0xFFFFFFFFu, 0u, static_cast<unsigned>(max(2 * tail - 32 * k, 0)));
}

__device__ __forceinline__ unsigned dollar_below(int tail, int k) {
  return __funnelshift_lc(0xFFFFFFFFu, 0u, static_cast<unsigned>(max(tail - 32 * k, 0)));
}

// Even-bit masks of the symbols of word w whose code equals the code that
// `pattern` repeats, and whose code is below 2 * k1 + k0 (K1, K0: kLo for a
// set bit, else 0).
__device__ __forceinline__ unsigned code_eq(unsigned w, unsigned pattern) {
  const unsigned x = w ^ pattern;
  return ~(x | (x >> 1)) & kLo;
}

__device__ __forceinline__ unsigned code_lt(unsigned w, unsigned K1, unsigned K0) {
  const unsigned hi = (w >> 1) & kLo, lo = w & kLo;
  return (~hi & K1) | (~(hi ^ K1) & ~lo & K0);
}

__device__ __forceinline__ void sym_words(const Row& r, unsigned w[8]) {
  w[0] = r.s0.x, w[1] = r.s0.y, w[2] = r.s0.z, w[3] = r.s0.w;
  w[4] = r.s1.x, w[5] = r.s1.y, w[6] = r.s1.z, w[7] = r.s1.w;
}

// Symbols of the block prefix whose code equals `pattern`'s: two words'
// even-bit masks share a popcount.
__device__ __forceinline__ int count_eq(const Row& r, int tail, unsigned pattern) {
  unsigned w[8];
  sym_words(r, w);
  int n = 0;
#pragma unroll
  for (int k = 0; k < 8; k += 2) {
    n += __popc((code_eq(w[k], pattern) & sym_below(tail, k)) |
                ((code_eq(w[k + 1], pattern) & sym_below(tail, k + 1)) << 1));
  }
  return n;
}

// Symbols of the block prefix whose code is below 2 * k1 + k0.
__device__ __forceinline__ int count_lt(const Row& r, int tail, unsigned K1, unsigned K0) {
  unsigned w[8];
  sym_words(r, w);
  int n = 0;
#pragma unroll
  for (int k = 0; k < 8; k += 2) {
    n += __popc((code_lt(w[k], K1, K0) & sym_below(tail, k)) |
                ((code_lt(w[k + 1], K1, K0) & sym_below(tail, k + 1)) << 1));
  }
  return n;
}

// '$' bits of the block prefix.
__device__ __forceinline__ int count_dollar(const Row& r, int tail) {
  return __popc(r.d.x & dollar_below(tail, 0)) + __popc(r.d.y & dollar_below(tail, 1)) +
         __popc(r.d.z & dollar_below(tail, 2)) + __popc(r.d.w & dollar_below(tail, 3));
}

template <typename T>
__device__ __forceinline__ T sel5(const T a[5], int c) {
  T out = a[0];
#pragma unroll
  for (int r = 1; r < 5; ++r) out = (c == r) ? a[r] : out;
  return out;
}

// What a step needs of one row for a symbol of rank c in 1..4.  On the
// chain: occ_c(i) (`occ_c`, which subtracts the '$' bits from A's count,
// since '$' packs as A).  Off it: the sum of occ_r(i) over r < c
// (`below`) and occ_$(i) (`dollar`); base_$ = block * 128 - the ACGT
// checkpoints.
struct StepRow {
  int n_dollar;  // '$' bits of the block prefix

  __device__ __forceinline__ int occ_c(const Row& r, const Where& q, int c) {
    n_dollar = count_dollar(r, q.tail);
    const unsigned ck = c == 1 ? r.ck.x : c == 2 ? r.ck.y : c == 3 ? r.ck.z : r.ck.w;
    return static_cast<int>(ck) + count_eq(r, q.tail, static_cast<unsigned>(c - 1) * kLo) -
           (c == 1 ? n_dollar : 0);
  }

  // below: base_$ + the checkpoints of ranks 1..c-1 = block * 128 - those of
  // ranks c..4; in the block, '$' and A are code 0, so the ranks below
  // c >= 2 are the codes below c - 1, and below A only '$' counts
  __device__ __forceinline__ void off_chain(const Row& r, const Where& q, int c, int& below,
                                            int& dollar) const {
    const unsigned t4 = r.ck.w, t3 = r.ck.z + t4, t2 = r.ck.y + t3, t1 = r.ck.x + t2;
    const unsigned from_c = c == 1 ? t1 : c == 2 ? t2 : c == 3 ? t3 : t4;
    const unsigned base = static_cast<unsigned>(q.block0) * kSample;
    const unsigned k = static_cast<unsigned>(c - 1);
    below = static_cast<int>(base - from_c) +
            count_lt(r, q.tail, (k >> 1) ? kLo : 0u, (k & 1u) ? kLo : 0u) +
            (c == 1 ? n_dollar : 0);
    dollar = static_cast<int>(base - t1) + n_dollar;
  }
};

// All five counts s[c] = occ_c(i) of a row: the interval that opens a
// search, and the finals.
__device__ __forceinline__ void occ_all(const Row& r, const Where& q, int s[5]) {
  const int n_dollar = count_dollar(r, q.tail);
  const unsigned base = static_cast<unsigned>(q.block0) * kSample;
  s[0] = static_cast<int>(base - (r.ck.x + r.ck.y + r.ck.z + r.ck.w)) + n_dollar;
  s[1] = static_cast<int>(r.ck.x) + count_eq(r, q.tail, 0u) - n_dollar;
  s[2] = static_cast<int>(r.ck.y) + count_eq(r, q.tail, kLo);
  s[3] = static_cast<int>(r.ck.z) + count_eq(r, q.tail, 0xAAAAAAAAu);
  s[4] = static_cast<int>(r.ck.w) + count_eq(r, q.tail, 0xFFFFFFFFu);
}

}  // namespace single_occ
