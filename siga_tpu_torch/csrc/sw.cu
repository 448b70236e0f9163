// K5: batched affine-gap Smith-Waterman for sm_90a, a warp a pair with the
// wavefront in registers and DPX max-plus instructions.
//
// Replaces the Pallas TPU kernel siga_tpu/ops/sw_pallas.py::_sw_kernel and
// also returns the end positions that the JAX package took from the XLA
// version (siga_tpu/ops/sw_device.py::_sw_wavefront);
// siga_tpu_torch/ops/sw.py::sw_wavefront_plain is the same function in plain
// PyTorch.
//
// Work split: one warp per (query, ref) pair, kWarps pairs a block.  Lane t
// owns the R consecutive query rows tR + 1 .. (t + 1)R, R a template width at
// least ceil(M / 32), so L = ceil(M / R) lanes hold rows.  For each of its
// rows a lane keeps in registers H - gap_open and F of the previous ref
// column, the query symbol, and the row's best so far.
//
// Sweep: the warp walks the ref columns; lane t lags t columns behind lane
// 0, so a pass is N + L - 1 steps.  At a step lane t takes from lane t - 1
// by __shfl_up_sync the H - go and E of row tR at its own column (lane t - 1
// computed them the step before); the diagonal H(tR, j - 1) is what it took
// the step before.  E runs down the lane's rows within the thread; F moves
// along its registers.  A cell is four DPX instructions and three integer
// ones:
//   E = __viaddmax_s32(E_up, -ge, Hg_up)         max(E_up - ge, H_up - go)
//   F = __viaddmax_s32(F, -ge, Hg_left)          max(F - ge, H_left - go)
//   H = __vimax3_s32_relu(Hg_diag + (s + go), E, F)
//   best: __vibmax_s32 and a select of the step
// with Hg = H - go kept in place of H, so one subtraction serves E below, F
// to the right and the diagonal (s + go is match + go or go - mismatch).
// Ref symbols are staged a warp at a time in a 64-entry ring in shared
// memory (32 loaded every 32 steps, the next 32 in flight meanwhile); lane t
// reads symbol s - t at step s, so no thread makes a global load per cell.
// There is no barrier: the warp is the block of work.
//
// Boundaries: row 0 and column 0 of H are 0 as a diagonal neighbour and NEG
// as an E or F neighbour, as in _sw_wavefront.  Hg starts at -go (H = 0 as
// the diagonal), lane 0 takes H - go = NEG - go and E = NEG from above, and
// at column 1 F is max(NEG - go, NEG - ge).  Steps where some lane of the
// L is outside 1..N (the first L and the last L - 1) run the checked body:
// such a lane keeps its registers and its best; the others run unchecked.
//
// Ties: the sweep visits cells column by column, not diagonal by diagonal.
// A row's best is taken strictly greater, so it is the row's first column
// reaching it (the smallest d = i + j on that row); the lanes then reduce
// (h, d, i) by max h, then smallest d, then smallest i: the first diagonal
// that reaches the maximum, then the smallest query row on it, as
// _sw_wavefront.  A best h <= 0 gives (0, -1, -1).  Query code <= 0 is
// padding and never matches (queries <= 0 are read as 0, refs <= 0 as -1).
//
// Long queries: a query of M > 1,023 rows runs as strips of kStripRows =
// 992 rows (31 lanes of 32; the last strip takes the rest at its own width),
// one launch a strip, in order.  Strip k's last lane writes, at every ref
// column j, the H - go and E of the strip's last row into a carry buffer
// ([2, B, N] int32: H - go, then E); strip k + 1's lane 0 takes them from
// above in place of row 0's NEG - go and NEG (loading column j + 1's during
// column j's step), and the H - go it took the step before is its diagonal,
// as a lane takes lane t - 1's.  Two buffers alternate, so a launch never
// reads what it writes.  A strip's best carries global rows; all but the
// last strip write it raw (h, d, i) into best / qend / rend, and the next
// joins it by the same rule (sw_strip_kernel).  M <= 1,023 is one launch of
// sw_kernel, with no carry.
//
// What bounds it: operations, about ten integer instructions a cell with
// the step's shuffles and ring read shared over R cells; the cells of one
// step are a dependent chain down the lane's rows (E), hidden by the other
// warps on the scheduler.  Values are int32; a two-pairs-a-word 16-bit form
// (__viaddmax_s16x2) would need a range condition on the parameters.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 20);
constexpr int kWarps = 4;  // pairs a block
constexpr int kThreads = 32 * kWarps;
constexpr int kRing = 64;  // ref symbols staged a warp
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRows = 1023;   // rows one launch takes; ops/sw.py MAX_ROWS
constexpr int kStripRows = 992;  // rows of a strip that carries on; ops/sw.py STRIP_ROWS
constexpr int kStripR = kStripRows / 31;  // its width: 31 lanes of 32 rows

struct Params {
  int go, ge;
  int s_match, s_mismatch;  // match + go, go - mismatch
  int f_first;              // F at column 1: max(NEG - go, NEG - ge)
};

// The row above a strip, from the strip before (in: H - go and E of each ref
// column, of this pair), and the strip's last row for the next (out).  `hg`
// and `e` hold column j + 1's in-values during column j's step, in lane 0.
struct Carry {
  const int* in_hg;
  const int* in_e;
  int* out_hg;
  int* out_e;
  int hg, e;
};

// ref symbol idx of the pair, -1 past the end or for a code <= 0
__device__ __forceinline__ int ref_symbol(const int* ref, int idx, int N) {
  if (idx >= N) return -1;
  const int v = __ldg(ref + idx);
  return v > 0 ? v : -1;
}

// One step s of the sweep for lane t (column j = s - t + 1).  kEdge: some
// lane may be outside columns 1..N, so each lane checks its own.  kIn: the
// row above comes from the carry, not row 0; kOut: lane L - 1, which holds
// the strip's last row, writes it to the carry.
template <int R, bool kEdge, bool kIn, bool kOut>
__device__ __forceinline__ void sw_step(int s, int t, int N, int L, int* ring, int& next,
                                        const int* ref, const int (&q)[R], int (&hg)[R],
                                        int (&f)[R], int (&bh)[R], int (&bs)[R], int& diag0,
                                        int& e_last, const Params& p, Carry& c) {
  if ((s & 31) == 0 && s > 0) {  // the next 32 symbols into the ring
    __syncwarp();
    ring[(s + t) & (kRing - 1)] = next;
    next = ref_symbol(ref, s + 32 + t, N);
    __syncwarp();
  }
  const int r = ring[(s - t) & (kRing - 1)];
  int hg_up = __shfl_up_sync(kFull, hg[R - 1], 1);
  int e_up = __shfl_up_sync(kFull, e_last, 1);
  int diag = diag0;
  if constexpr (kIn) {
    if (t == 0) {  // the strip before's last row, at column s + 1
      hg_up = c.hg;
      e_up = c.e;
      if (s + 1 < N) {
        c.hg = __ldg(c.in_hg + s + 1);
        c.e = __ldg(c.in_e + s + 1);
      }
    }
    diag0 = hg_up;
  } else {
    diag0 = hg_up;
    if (t == 0) {  // row 0: NEG above, 0 on the diagonal
      hg_up = kNeg - p.go;
      e_up = kNeg;
      diag = -p.go;
    }
  }
  const int j = s - t + 1;
  const bool active = !kEdge || (j >= 1 && j <= N);
  const bool first = kEdge && j == 1;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int left = hg[k];
    const int e = __viaddmax_s32(e_up, -p.ge, hg_up);
    int fk = __viaddmax_s32(f[k], -p.ge, left);
    if (first) fk = p.f_first;
    const int h = __vimax3_s32_relu(diag + (q[k] == r ? p.s_match : p.s_mismatch), e, fk);
    const int g = h - p.go;
    if (active) {
      bool keep;
      bh[k] = __vibmax_s32(bh[k], g, &keep);
      bs[k] = keep ? bs[k] : s;
      hg[k] = g;
      f[k] = fk;
    }
    diag = left;
    hg_up = g;
    e_up = e;
  }
  e_last = e_up;
  if constexpr (kOut) {
    if (t == L - 1 && active) {
      c.out_hg[j - 1] = hg[R - 1];
      c.out_e[j - 1] = e_last;
    }
  }
}

// (h, d, i) of a cell beats (h2, d2, i2): larger h, then smaller d, then smaller i
__device__ __forceinline__ bool better(int h, int d, int i, int h2, int d2, int i2) {
  return h > h2 || (h == h2 && (d < d2 || (d == d2 && i < i2)));
}

// Rows i0 + 1 .. i0 + M of the pairs' queries (stride Q) against their refs.
template <int R, bool kIn, bool kOut>
__device__ __forceinline__ void sw_pairs(const int* __restrict__ queries,
                                         const int* __restrict__ refs, int B, int Q, int N,
                                         int i0_arg, int M, const Params& p,
                                         const int* __restrict__ carry_in,
                                         int* __restrict__ carry_out, int* __restrict__ best,
                                         int* __restrict__ qend, int* __restrict__ rend) {
  __shared__ int rings[kWarps][kRing];
  const int t = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  // one strip (the whole query): rows from 1, Q == M
  const int i0 = (kIn || kOut) ? i0_arg : 0;
  const int stride = (kIn || kOut) ? Q : M;
  int* ring = rings[threadIdx.x >> 5];
  const int* ref = refs + static_cast<size_t>(b) * N;
  const int* qrow = queries + static_cast<size_t>(b) * stride + i0;
  const int L = (M + R - 1) / R;
  const size_t plane = static_cast<size_t>(B) * N;  // H - go, then E
  Carry c{};
  if constexpr (kIn) {
    c.in_hg = carry_in + static_cast<size_t>(b) * N;
    c.in_e = c.in_hg + plane;
    c.hg = __ldg(c.in_hg);
    c.e = __ldg(c.in_e);
  }
  if constexpr (kOut) {
    c.out_hg = carry_out + static_cast<size_t>(b) * N;
    c.out_e = c.out_hg + plane;
  }

  int q[R], hg[R], f[R], bh[R], bs[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int row = t * R + k;
    q[k] = row < M ? max(qrow[row], 0) : 0;
    hg[k] = -p.go;
    f[k] = kNeg;
    bh[k] = INT_MIN;
    bs[k] = 0;
  }
  ring[t] = ref_symbol(ref, t, N);
  int next = ref_symbol(ref, 32 + t, N);
  __syncwarp();
  int diag0 = -p.go, e_last = kNeg;

  // steps [0, L) and [max(L, N), N + L - 1) are checked; [L, N) are not
  int s = 0;
  for (; s < L && s < N + L - 1; ++s)
    sw_step<R, true, kIn, kOut>(s, t, N, L, ring, next, ref, q, hg, f, bh, bs, diag0, e_last, p,
                                c);
  for (; s < N; ++s)
    sw_step<R, false, kIn, kOut>(s, t, N, L, ring, next, ref, q, hg, f, bh, bs, diag0, e_last,
                                 p, c);
  for (; s < N + L - 1; ++s)
    sw_step<R, true, kIn, kOut>(s, t, N, L, ring, next, ref, q, hg, f, bh, bs, diag0, e_last, p,
                                c);

  int h = INT_MIN, d = INT_MAX, i = INT_MAX;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int row = i0 + t * R + k + 1;  // query row i of the cell
    if (row <= i0 + M) {
      const int hk = bh[k] + p.go, dk = row + bs[k] - t + 1;
      if (better(hk, dk, row, h, d, i)) {
        h = hk;
        d = dk;
        i = row;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int h2 = __shfl_xor_sync(kFull, h, off);
    const int d2 = __shfl_xor_sync(kFull, d, off);
    const int i2 = __shfl_xor_sync(kFull, i, off);
    if (better(h2, d2, i2, h, d, i)) {
      h = h2;
      d = d2;
      i = i2;
    }
  }
  if (t == 0) {
    if constexpr (kIn) {
      if (better(best[b], qend[b], rend[b], h, d, i)) {  // the strips before's, raw
        h = best[b];
        d = qend[b];
        i = rend[b];
      }
    }
    if constexpr (kOut) {
      best[b] = h;
      qend[b] = d;
      rend[b] = i;
    } else {
      const bool none = h <= 0;
      best[b] = none ? 0 : h;
      qend[b] = none ? -1 : i - 1;
      rend[b] = none ? -1 : d - i - 1;
    }
  }
}

// A whole query of M <= 1,023 rows a pair, with no strip parameters: with
// them in its signature the same body compiled to another register
// assignment and schedule and ran 0.4% slower at 4,096 x 150 x 400 (PERF.md)
template <int R>
__global__ void __launch_bounds__(kThreads)
sw_kernel(const int* __restrict__ queries, const int* __restrict__ refs, int B, int M, int N,
          Params p, int* __restrict__ best, int* __restrict__ qend, int* __restrict__ rend) {
  sw_pairs<R, false, false>(queries, refs, B, M, N, 0, M, p, nullptr, nullptr, best, qend,
                            rend);
}

// One strip of longer queries: kIn after the first strip, kOut before the last.
template <int R, bool kIn, bool kOut>
__global__ void __launch_bounds__(kThreads)
sw_strip_kernel(const int* __restrict__ queries, const int* __restrict__ refs, int B, int Q,
                int N, int i0, int M, Params p, const int* __restrict__ carry_in,
                int* __restrict__ carry_out, int* __restrict__ best, int* __restrict__ qend,
                int* __restrict__ rend) {
  sw_pairs<R, kIn, kOut>(queries, refs, B, Q, N, i0, M, p, carry_in, carry_out, best, qend,
                         rend);
}

struct Call {
  const int* queries;
  const int* refs;
  int B, Q, N, i0, M;
  Params p;
  const int* carry_in;
  int* carry_out;
  int *best, *qend, *rend;
  cudaStream_t stream;
};

template <int R, bool kIn, bool kOut>
int launch(const Call& c) {
  const int blocks = (c.B + kWarps - 1) / kWarps;
  if constexpr (!kIn && !kOut) {
    sw_kernel<R><<<blocks, kThreads, 0, c.stream>>>(c.queries, c.refs, c.B, c.M, c.N, c.p,
                                                     c.best, c.qend, c.rend);
  } else {
    sw_strip_kernel<R, kIn, kOut><<<blocks, kThreads, 0, c.stream>>>(
        c.queries, c.refs, c.B, c.Q, c.N, c.i0, c.M, c.p, c.carry_in, c.carry_out, c.best,
        c.qend, c.rend);
  }
  return static_cast<int>(cudaGetLastError());
}

// the smallest instantiated width R >= rmin
template <bool kIn, int R, int... Rs>
int dispatch(int rmin, const Call& c) {
  if (rmin <= R) return launch<R, kIn, false>(c);
  if constexpr (sizeof...(Rs) > 0) {
    return dispatch<kIn, Rs...>(rmin, c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kIn>
int dispatch_last(const Call& c) {
  return dispatch<kIn, 1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32>((c.M + 31) / 32, c);
}

}  // namespace

// Rows i0 + 1 .. i0 + M of queries [B, Q] against refs [B, N], 1 <= M <=
// 1,023, N >= 1.  carry_in: null for the first strip, else the carry the
// strip before wrote; carry_out: null for the last strip, else a carry to
// write ([2, B, N] int32), and then M is kStripRows.  The last strip writes
// (best, qend, rend); the others write the raw (h, d, i) the next one joins.
extern "C" int siga_sw_wavefront(const void* queries, const void* refs, int B, int Q, int N,
                                 int match, int mismatch, int gap_open, int gap_extend, int i0,
                                 int M, const void* carry_in, void* carry_out, void* best,
                                 void* qend, void* rend, void* stream) {
  if (B < 1 || M < 1 || M > kMaxRows || N < 1 || i0 < 0 || i0 + M > Q ||
      (carry_in == nullptr) != (i0 == 0) || (carry_out != nullptr && M != kStripRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int f_first = max(kNeg - gap_open, kNeg - gap_extend);
  const Call c{static_cast<const int*>(queries), static_cast<const int*>(refs), B, Q, N, i0, M,
               Params{gap_open, gap_extend, match + gap_open, gap_open - mismatch, f_first},
               static_cast<const int*>(carry_in), static_cast<int*>(carry_out),
               static_cast<int*>(best), static_cast<int*>(qend), static_cast<int*>(rend),
               static_cast<cudaStream_t>(stream)};
  if (carry_out != nullptr) {
    return carry_in == nullptr ? launch<kStripR, false, true>(c) : launch<kStripR, true, true>(c);
  }
  return carry_in == nullptr ? dispatch_last<false>(c) : dispatch_last<true>(c);
}
