// K9: the stage-A scan with '$'-probes of the compile check and the dry run,
// for sm_90a.
//
// Replaces siga_tpu/ops/fm_device.py::_scan_stage_a (an XLA lax.scan on the
// TPU; its callers are __graft_entry__.py's compile check and multichip dry
// run); siga_tpu_torch/ops/fm_device.py::scan_stage_a_plain is the same
// function in plain PyTorch.  Each lane walks its read one symbol a step
// over a single-step plane (single_occ.cuh): the rows that hold positions
// lo - 1 and hi give the occ counts of the prepended symbol, of the symbols
// below it and of '$', so one step is one backward-search update and one
// closed-form '$'-probe, as in K3 (scan_single.cu).  Unlike K3 it compacts
// nothing: every step t in [0, max_t) writes every lane's state before the
// step (emitted [max_t, L, 3] int32: lo, rlo, hi - lo) and its validity
// (valid [max_t, L] bytes), an inactive lane's frozen state included; the
// finals are [lo, hi, rlo, rhi] and the '$'-probe of the full-length
// interval in the lane's own table, and the five count differences there.
//
// Inputs as JAX's: chars [L, max_t + 1] int32, lane-major (chars[l, t] is
// the symbol step t prepends, chars[l, max_t] the one that opens the
// search; past len - 2 never read); lens [L]; the plane of any row
// count, each lane's row offset from lane_tab (null: 0), a row index
// clamped to the plane as JAX's gather clamps it.  Symbols are ranks 0..4:
// '$' (a read's N encodes as 0) takes the '$' count and has nothing below.
//
// What bounds it on an H100: bytes.  At one overlap chunk's shape (60,608
// lanes x 149 steps) it must move about 170 MB (the dense outputs 117 MB,
// the chars 36 MB, the plane), 0.051 ms at 3.35 TB/s; its chain of 151
// dependent row reads takes about 0.035 ms at the L2 round trip (PERF.md).
// The design:
//  - one thread a lane, its rows read and counted as K3's (single_occ.cuh):
//    the prepended symbol's counts first, the next rows' loads issued, then
//    the counts below it and of '$' while those loads are in flight; a row
//    shared by lo - 1 and hi read once;
//  - the symbol of step t + 1 is loaded during step t, so the strided
//    chars load (a lane's row is (max_t + 1) * 4 bytes, not a multiple of
//    16) is never on the chain;
//  - outputs step-major: at step t the 32 lanes of a warp write 32
//    consecutive 12-byte records of `emitted` and 32 consecutive bytes of
//    `valid`, so each step's stores coalesce; a lane past its last live
//    step writes its frozen state without reading a row.
#include <cuda_runtime.h>

#include <cstdint>

#include "single_occ.cuh"

namespace {

using namespace single_occ;

constexpr int kThreads = 64;
constexpr int kMinBlocks = 8;  // at most 128 registers a thread, as K3

struct StageArgs {
  const int* plane;  // [nrows, 16]
  const int* pred;   // [5]
  const int* chars;  // [L, max_t + 1]
  const int* lens;   // [L]
  const int* tab;    // [L] row offsets, or null
  int nrows, length, L, max_t, min_overlap;
  int* emitted;          // [max_t, L, 3]
  unsigned char* valid;  // [max_t, L]
  int* finals;           // [L, 8]
  int* lext;             // [L, 5]
};

// occ of rank c in 0..4 of a step's row, on the chain: K3's count for a
// base, the '$' count (base_$ + the prefix's '$' bits) for c = 0
__device__ __forceinline__ int occ_rank(StepRow& st, const Row& r, const Where& q, int c) {
  const int n = st.occ_c(r, q, c);
  if (c != 0) return n;
  const unsigned base = static_cast<unsigned>(q.block0) * kSample;
  return static_cast<int>(base - (r.ck.x + r.ck.y + r.ck.z + r.ck.w)) + st.n_dollar;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) scan_stage_a_kernel(StageArgs a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.L) return;
  const WholePlane plane{a.plane};
  const int nrows = a.nrows;
  const int tab = a.tab != nullptr ? __ldg(a.tab + lane) : 0;
  const int len = __ldg(a.lens + lane);
  const int* chars = a.chars + static_cast<size_t>(lane) * (a.max_t + 1);
  int pred[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) pred[c] = __ldg(a.pred + c);

  const int c0 = __ldg(chars + a.max_t);
  int lo = sel5(pred, c0), hi;
  {
    const Where q = where(a.length - 1, tab, nrows);
    int s[5];
    occ_all(load_row(plane, q.row), q, s);
    hi = lo + sel5(s, c0) - 1;
  }
  int rlo = lo;

  // the rows of lo - 1 (wq[0], rows[0]) and hi (wq[1], rows[1]), loaded a
  // step ahead, as K3's
  Where wq[2];
  Row rows[2];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int m = 0; m < 2; ++m) rows[m] = Row{zero, zero, zero, zero};
  auto load_step = [&](int nlo, int nhi) {
#pragma unroll
    for (int m = 0; m < 2; ++m) wq[m] = where(m == 0 ? nlo - 1 : nhi, tab, nrows);
    const bool same = wq[1].row == wq[0].row;  // one row for both: the tail of hi, the longer
    load_below(plane, wq[0].row, same ? wq[1].tail : wq[0].tail, rows[0]);
    if (!same) load_below(plane, wq[1].row, wq[1].tail, rows[1]);
  };
  auto row_hi = [&]() -> Row {
    const bool same = wq[1].row == wq[0].row;
    const Row& u = rows[1];
    const Row& l = rows[0];
    return Row{same ? l.s0 : u.s0, same ? l.s1 : u.s1, same ? l.d : u.d, same ? l.ck : u.ck};
  };
  load_step(lo, hi);

  const size_t stride = static_cast<size_t>(a.L);
  int* em = a.emitted + static_cast<size_t>(lane) * 3;
  unsigned char* va = a.valid + lane;
  // live steps t <= len - 2; the rest keep the state and emit it, not valid
  const int steps = min(a.max_t, max(len - 1, 0));
  int c = steps > 0 ? __ldg(chars) : 0;
  int t = 0;
  for (; t < steps; ++t) {
    const int c_next = t + 1 < steps ? __ldg(chars + t + 1) : 0;
    // on the chain: occ_c of the two rows, then the next rows' loads
    const Row cur0 = rows[0], cur1 = row_hi();
    const Where q0 = wq[0], q1 = wq[1];
    StepRow st0, st1;
    const int s_lo = occ_rank(st0, cur0, q0, c);
    const int s_hi = occ_rank(st1, cur1, q1, c);
    const int pc = sel5(pred, c);
    const int nlo = pc + s_lo, nhi = pc + s_hi - 1;
    load_step(nlo, nhi);
    // off the chain: the counts below c and of '$' of this step's rows
    int b_lo, b_hi, d_lo, d_hi;
    st0.off_chain(cur0, q0, c, b_lo, d_lo);
    st1.off_chain(cur1, q1, c, b_hi, d_hi);
    // the '$'-probe of the state at t: prhi >= prlo and prhi >= 0
    const int psize = d_hi - d_lo;
    const bool ok = psize > 0 && rlo + psize - 1 >= 0 && t + 1 >= a.min_overlap;
    em[0] = lo;
    em[1] = rlo;
    em[2] = hi - lo;
    *va = ok ? 1 : 0;
    em += 3 * stride;
    va += stride;
    if (c != 0) rlo += b_hi - b_lo;  // nothing ranks below '$'
    lo = nlo;
    hi = nhi;
    c = c_next;
  }
  for (; t < a.max_t; ++t) {
    em[0] = lo;
    em[1] = rlo;
    em[2] = hi - lo;
    *va = 0;
    em += 3 * stride;
    va += stride;
  }

  // finals: the counts of the rows loaded last (lo - 1 and hi of the
  // full-length interval), the '$'-probe of that interval
  int l[5], u[5];
  occ_all(rows[0], wq[0], l);
  occ_all(row_hi(), wq[1], u);
  int* fin = a.finals + static_cast<size_t>(lane) * 8;
  int* ext = a.lext + static_cast<size_t>(lane) * 5;
  const int p0 = u[0] - l[0];
#pragma unroll
  for (int k = 0; k < 5; ++k) ext[k] = u[k] - l[k];
  fin[0] = lo;
  fin[1] = hi;
  fin[2] = rlo;
  fin[3] = rlo + hi - lo;  // the intervals keep equal sizes
  fin[4] = pred[0] + l[0];
  fin[5] = pred[0] + u[0] - 1;
  fin[6] = rlo;
  fin[7] = rlo + p0 - 1;
}

}  // namespace

// K9 over L lanes: the plane [nrows, 16] int32 (16-byte aligned), pred [5],
// chars [L, max_t + 1], lens [L], lane_tab [L] or null; writes emitted
// [max_t, L, 3], valid [max_t, L] (one byte each), final [L, 8], lext [L, 5].
extern "C" int siga_scan_stage_a(const void* plane, int nrows, const void* pred, int length,
                                 const void* chars, const void* lens, const void* lane_tab, int L,
                                 int max_t, int min_overlap, void* emitted, void* valid,
                                 void* finals, void* lext, void* stream) {
  if (nrows < 1 || L < 1 || max_t < 0 || length < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<std::uintptr_t>(plane) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const StageArgs a{static_cast<const int*>(plane), static_cast<const int*>(pred),
                    static_cast<const int*>(chars), static_cast<const int*>(lens),
                    static_cast<const int*>(lane_tab), nrows, length, L, max_t, min_overlap,
                    static_cast<int*>(emitted), static_cast<unsigned char*>(valid),
                    static_cast<int*>(finals), static_cast<int*>(lext)};
  const int grid = static_cast<int>((static_cast<long long>(L) + kThreads - 1) / kThreads);
  scan_stage_a_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
