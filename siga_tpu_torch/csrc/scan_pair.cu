// K1: the stage-A pair scan of the overlap engine, for sm_90a.
//
// Replaces siga_tpu/ops/fm_device.py::_scan_pair_core (an XLA program on the
// TPU); siga_tpu_torch/ops/fm_device.py::scan_pair_plain is the same function
// in plain PyTorch.  One thread per lane (one read in one orientation): the
// interval pair (lo, hi, rlo, rhi) stays in registers while the lane walks its
// read two symbols per superstep.  Each superstep reads the two 228-byte
// pair-plane rows that hold positions lo-1 and hi, counts single-symbol and
// pair occ with __popc over even-bit match masks, and advances two symbols at
// once through K[c2][c1] + occ2.
//
// What bounds it: dependent row reads.  A lane's next row address depends on
// this superstep's counts, so each lane is a chain of L2/HBM round trips and
// throughput comes only from many lanes in flight.  The plane is ~45 MB per
// direction at 25 Mchar, so only one direction fits in the 50 MB L2 at a
// time; lanes are laid out direction-major (forward groups first) and blocks
// start roughly in lane order, so most resident lanes read the same
// direction.  Only the row words below the query position are read.
//
// Emission is two launches of the same scan.  The count pass writes per-lane
// emission counts and the finals (containment candidates, and the candidate
// and substring bits as warp ballots); the caller takes an exclusive cumsum
// of the counts; the emit pass repeats the scan and writes [lo, rlo, size,
// trel] rows at the lane's offset, lane-major and t ascending.  That replaces
// the sort-based compaction of the TPU program and sizes the output exactly.
#include <cuda_runtime.h>

#include "pair_occ.cuh"

namespace {

using pair_occ::sel5;

constexpr int kThreads = 128;

enum Group { kId = 0, kRc = 1, kRev = 2, kComp = 3 };

struct ScanArgs {
  const int* plane;     // [2 * nblocks, 57]: forward rows, then reverse rows
  const int* K2;        // [2, 5, 5]: K[c2][c1] per direction
  const int* pred;      // [5]: C(c), shared by both directions
  const int* la_words;  // [n, wpr]: left-aligned reads, 2 bits a symbol
  const int* lens;      // [n]
  int length, nblocks, n, wpr, nfwd, groups_code, lim_t, p1, t0, lanes;
};

// sum over r < c of (u[r] - l[r])
__device__ __forceinline__ int below5(const int u[5], const int l[5], int c) {
  int out = 0;
#pragma unroll
  for (int r = 0; r < 5; ++r) out += (c > r) ? (u[r] - l[r]) : 0;
  return out;
}

// Inclusive occ at BWT position i (i >= -1) of the table whose rows start at
// `tab`: s[c] = occ_c(i); with PAIRS, p[q] = occ2((q, c1), i) (0 when c1 = 0).
template <bool PAIRS>
__device__ __forceinline__ void occ(const ScanArgs& a, int tab, int i, int c1,
                                    int s[5], int p[5]) {
  pair_occ::occ_row<PAIRS>(a.plane, 2 * a.nblocks, tab, i, c1, s, p);
}

// Symbol j (rank 1..4) of a left-aligned read; 0 outside [0, len).
__device__ __forceinline__ int la_at(const ScanArgs& a, int row, int len, int j) {
  if (j < 0 || j >= len || j >= a.wpr * 16) return 0;
  const unsigned w = __ldg(a.la_words + static_cast<size_t>(row) * a.wpr + (j >> 4));
  return static_cast<int>((w >> (2 * (j & 15))) & 3u) + 1;
}

__device__ __forceinline__ int comp(int c) { return c == 0 ? 0 : 5 - c; }

// The symbol prepended at step t: s'[l-2-t] of the lane's transformed read.
__device__ __forceinline__ int step_char(const ScanArgs& a, int group, int row,
                                         int len, int t) {
  switch (group) {
    case kId: return la_at(a, row, len, len - 2 - t);
    case kRc: return comp(la_at(a, row, len, t + 1));
    case kRev: return la_at(a, row, len, t + 1);
    default: return comp(la_at(a, row, len, len - 2 - t));
  }
}

// The lane's first symbol s'[l-1], which opens the search interval.
__device__ __forceinline__ int first_char(const ScanArgs& a, int group, int row,
                                          int len) {
  switch (group) {
    case kId: return la_at(a, row, len, len - 1);
    case kRc: return comp(la_at(a, row, len, 0));
    case kRev: return la_at(a, row, len, 0);
    default: return comp(la_at(a, row, len, len - 1));
  }
}

template <bool EMIT>
__global__ void __launch_bounds__(kThreads)
scan_pair_kernel(ScanArgs a, int* lane_counts, int* fall, unsigned* candmask,
                 unsigned* subwords, const long long* offsets, int4* out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  bool fvalid = false, substring = false;
  if (lane < a.lanes) {
    const int g = lane / a.n;
    const int row = lane - g * a.n;
    const int group = (a.groups_code >> (2 * g)) & 3;
    const bool fwd = g < a.nfwd;
    const int tab = fwd ? 0 : a.nblocks;
    const int* K = a.K2 + (fwd ? 0 : 25);
    const int len = __ldg(a.lens + row);
    int pred[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) pred[c] = __ldg(a.pred + c);

    int ls[5], lp[5], us[5], up[5];
    const int c0 = first_char(a, group, row, len);
    int lo = sel5(pred, c0);
    occ<false>(a, tab, a.length - 1, 0, us, up);
    int hi = lo + sel5(us, c0) - 1;
    int rlo = lo, rhi = hi;

    int count = 0;
    const long long base = EMIT ? offsets[lane] : 0;
    const int supersteps = (a.lim_t + 1) / 2;  // odd lim_t: a phantom half-step
    for (int st = 0; st < supersteps; ++st) {
      const int t = 2 * st;
      const int c1 = step_char(a, group, row, len, t);
      const int c2 = t + 1 < a.lim_t ? step_char(a, group, row, len, t + 1) : 0;
      occ<true>(a, tab, lo - 1, c1, ls, lp);
      occ<true>(a, tab, hi, c1, us, up);
      const bool act1 = t <= len - 2;
      const bool act2 = t + 1 <= len - 2;
      // after prepending c1
      const int d1 = sel5(us, c1) - sel5(ls, c1);
      const int nlo1 = sel5(pred, c1) + sel5(ls, c1);
      const int nhi1 = sel5(pred, c1) + sel5(us, c1) - 1;
      const int nrlo1 = rlo + below5(us, ls, c1);
      const int nrhi1 = nrlo1 + d1 - 1;
      // after prepending c2 as well: K[c2][c1] + occ2((c2, c1), .)
      const int kv = (c1 > 0 && c2 > 0) ? __ldg(K + c2 * 5 + c1) : 0;
      const int nlo2 = kv + sel5(lp, c2);
      const int nhi2 = kv + sel5(up, c2) - 1;
      const int d2 = sel5(up, c2) - sel5(lp, c2);
      const int nrlo2 = nrlo1 + below5(up, lp, c2);
      const int nrhi2 = nrlo2 + d2 - 1;
      // '$'-probe blocks of the states at t and at t + 1
      const int psize0 = us[0] - ls[0];
      if (psize0 > 0 && rlo + psize0 - 1 >= 0 && act1 && t >= a.p1) {
        if (EMIT) out[base + count] = make_int4(lo, rlo, hi - lo, t - a.t0);
        ++count;
      }
      const int psize1 = up[0] - lp[0];
      if (psize1 > 0 && nrlo1 + psize1 - 1 >= 0 && act2 && t + 1 >= a.p1) {
        if (EMIT) out[base + count] = make_int4(nlo1, nrlo1, d1 - 1, t + 1 - a.t0);
        ++count;
      }
      if (act2) {
        lo = nlo2; hi = nhi2; rlo = nrlo2; rhi = nrhi2;
      } else if (act1) {
        lo = nlo1; hi = nhi1; rlo = nrlo1; rhi = nrhi1;
      }
    }

    if (!EMIT) {
      lane_counts[lane] = count;
      // finals: left extensions in the own table, right extensions in the
      // other one, and the closed-form '$'-probe of the full-length interval
      occ<false>(a, tab, lo - 1, 0, ls, lp);
      occ<false>(a, tab, hi, 0, us, up);
      const int other = a.nblocks - tab;
      int rl[5], ru[5];
      occ<false>(a, other, rlo - 1, 0, rl, lp);
      occ<false>(a, other, rhi, 0, ru, up);
      int lext = 0, rext = 0;
#pragma unroll
      for (int c = 1; c < 5; ++c) {
        lext += us[c] - ls[c];
        rext += ru[c] - rl[c];
      }
      substring = lext > 0 || rext > 0;
      const int l0 = ls[0], u0 = us[0], psize = u0 - l0;
      fvalid = psize > 0 && u0 - 1 >= 0 && rlo + psize - 1 >= 0 &&
               rlo + psize - 1 >= rlo;
      fall[lane] = lo;
      fall[a.lanes + lane] = rlo;
      fall[2 * a.lanes + lane] = l0;
      fall[3 * a.lanes + lane] = hi - lo;
      fall[4 * a.lanes + lane] = psize;
    }
  }
  if (!EMIT) {
    // lanes of a warp are 32 consecutive lanes: one mask word per warp
    const unsigned cb = __ballot_sync(0xFFFFFFFFu, fvalid);
    const unsigned sb = __ballot_sync(0xFFFFFFFFu, substring);
    if ((threadIdx.x & 31) == 0 && lane < a.lanes) {
      candmask[lane >> 5] = cb;
      subwords[lane >> 5] = sb;
    }
  }
}

ScanArgs make_args(const void* plane, const void* K2, const void* pred,
                   const void* la_words, const void* lens, int length,
                   int nblocks, int n, int wpr, int nfwd, int groups_code,
                   int lim_t, int p1, int t0, int lanes) {
  return ScanArgs{static_cast<const int*>(plane), static_cast<const int*>(K2),
                  static_cast<const int*>(pred), static_cast<const int*>(la_words),
                  static_cast<const int*>(lens), length, nblocks, n, wpr, nfwd,
                  groups_code, lim_t, p1, t0, lanes};
}

}  // namespace

extern "C" int siga_scan_pair_count(
    const void* plane, const void* K2, const void* pred, const void* la_words,
    const void* lens, int length, int nblocks, int n, int wpr, int nfwd,
    int groups_code, int lim_t, int p1, int t0, int lanes, void* lane_counts,
    void* fall, void* candmask, void* subwords, void* stream) {
  const ScanArgs a = make_args(plane, K2, pred, la_words, lens, length, nblocks,
                               n, wpr, nfwd, groups_code, lim_t, p1, t0, lanes);
  const int grid = (lanes + kThreads - 1) / kThreads;
  scan_pair_kernel<false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<int*>(lane_counts), static_cast<int*>(fall),
      static_cast<unsigned*>(candmask), static_cast<unsigned*>(subwords),
      nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int siga_scan_pair_emit(
    const void* plane, const void* K2, const void* pred, const void* la_words,
    const void* lens, int length, int nblocks, int n, int wpr, int nfwd,
    int groups_code, int lim_t, int p1, int t0, int lanes, const void* offsets,
    void* out, void* stream) {
  const ScanArgs a = make_args(plane, K2, pred, la_words, lens, length, nblocks,
                               n, wpr, nfwd, groups_code, lim_t, p1, t0, lanes);
  const int grid = (lanes + kThreads - 1) / kThreads;
  scan_pair_kernel<true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, nullptr, nullptr, nullptr, nullptr,
      static_cast<const long long*>(offsets), static_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}
