// K1: the stage-A pair scan of the overlap engine, for sm_90a.
//
// Replaces siga_tpu/ops/fm_device.py::_scan_pair_core (an XLA program on the
// TPU); siga_tpu_torch/ops/fm_device.py::scan_pair_plain is the same function
// in plain PyTorch.  Each lane (one read in one orientation) walks its read
// two symbols per superstep: the two 228-byte pair-plane rows that hold
// positions lo-1 and hi give single-symbol and pair occ counts, and
// K[c2][c1] + occ2 is the interval two symbols on.
//
// What bounds it.  A lane's next row address depends on this superstep's
// counts, so each lane is a chain of dependent row reads.  With many lanes
// (a 60,608-lane reads chunk: 75 supersteps each) the rows all lanes read
// bound it: ~1.6 GB with re-reads, ~0.5 ms at 3.35 TB/s, though most of
// them hit the 50 MB L2 (one direction's plane is 45 MB), and counted once
// each the plane is only 90 MB.  With few long lanes (the contig chunk:
// 1,170 lanes, the longest ~19,300 supersteps) the longest lane's chain of
// L2 round trips bounds it.
//
// The first design (one thread per lane) issued ~57 scalar loads a
// row from one thread, 32 rows per warp instruction, walked every lane to
// the chunk's deepest superstep, and ran the whole scan twice (a count pass
// to size the output, then an emit pass).  This design (csrc/pair_occ.cuh):
//  - a group of 8 threads (pair_occ::kGroup) serves one lane; thread j
//    loads word j of each bit plane and its share of the checkpoints, both
//    rows' loads are issued before either is summed, and the group sums only
//    the six counts per row that a superstep uses, by a butterfly of
//    shuffles; the state (lo, hi, rlo, rhi) is group-uniform, so every
//    branch is (pair_occ.cuh gives the measurements behind 8 threads);
//  - a lane stops after its last live superstep (t <= len - 2): the masked
//    supersteps of a short read in a long chunk change nothing;
//  - the lane's 2-bit read word is loaded once every 16 symbols;
//  - one pass: the group's leader writes the emitted [lo, rlo, size, trel]
//    rows into the lane's slab of `cap` int4 (each superstep emits at most
//    two rows, and only at t in [p1, lim_t - 1], so cap = lim_t - p1 holds
//    every lane), the counts and the finals; the caller compacts the slabs
//    into the lane-major, t-ascending layout (ops/fm_device.py::compact_slab)
//    and splits the lanes over several launches where the slabs do not fit
//    in free device memory;
//  - the candidate and substring bits are a ballot of the group leaders,
//    OR-ed into their mask words (zeroed by the caller).
// Times on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md; chip_smoke.py and
// probes/kernel_ab.py), through the wrapper, bit-equal to the first design:
// the 60,608-lane reads chunk 1.49-1.78 ms (the first design 1.89-2.18 ms
// in the same calls), the pipeline's 1,170 contig lanes 21.6-22.5 ms (the
// first design: 164.876 ms in an earlier run), within 5x of the chain bound
// of their longest lane (19,314 supersteps x one ~233 ns L2 round trip).
#include <cuda_runtime.h>

#include "lane_scan.cuh"
#include "pair_occ.cuh"

namespace {

using pair_occ::kGroup;
using pair_occ::RowSlice;
using pair_occ::sel5;
using lane_scan::step_char;

constexpr int kThreads = 64;

struct ScanArgs {
  const int* plane;     // [2 * nblocks, 57]: forward rows, then reverse rows
  const int* K2;        // [2, 5, 5]: K[c2][c1] per direction
  const int* pred;      // [5]: C(c), shared by both directions
  const int* la_words;  // [n, wpr]: left-aligned reads, 2 bits a symbol
  const int* lens;      // [n]
  int length, nblocks, n, wpr, nfwd, groups_code, lim_t, p1, t0, lanes;
};

__global__ void __launch_bounds__(kThreads)
scan_pair_kernel(ScanArgs a, int lane_base, int nl, int cap, int* lane_counts,
                 int* fall, unsigned* candmask, unsigned* subwords, int4* slab) {
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = gtid & (kGroup - 1);
  const int local = gtid / kGroup;  // lane within this launch
  const int lane = lane_base + local;
  const bool leader = j == 0;
  bool fvalid = false, substring = false;
  if (local < nl) {
    const unsigned gmask = pair_occ::group_mask();
    const int nrows = 2 * a.nblocks;
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
    lane_scan::SymReader rd(a.la_words + static_cast<size_t>(row) * a.wpr, len);

    int us[5], ls[5];
    RowSlice r0, r1;
    const int c0 = step_char(rd, group, -1);
    int lo = sel5(pred, c0);
    r0.load(a.plane, nrows, tab, a.length - 1, j, false);
    pair_occ::singles(r0, j, gmask, us);
    int hi = lo + sel5(us, c0) - 1;
    int rlo = lo, rhi = hi;

    int count = 0;
    int4* out = slab + static_cast<size_t>(local) * cap;
    // supersteps with t <= len - 2; the rest (odd lim_t: a phantom half-step
    // too) are masked and change nothing
    const int steps = min((a.lim_t + 1) / 2, len >= 2 ? (len - 2) / 2 + 1 : 0);
    for (int st = 0; st < steps; ++st) {
      const int t = 2 * st;
      const int c1 = step_char(rd, group, t);  // t <= len - 2: c1 in 1..4
      const int c2 = t + 1 < a.lim_t ? step_char(rd, group, t + 1) : 0;
      r0.load(a.plane, nrows, tab, lo - 1, j, true);
      r1.load(a.plane, nrows, tab, hi, j, true);
      const pair_occ::StepCounts L = pair_occ::step_counts<true>(r0, j, c1, c2, gmask);
      const pair_occ::StepCounts U = pair_occ::step_counts<true>(r1, j, c1, c2, gmask);
      const bool act2 = t + 1 <= len - 2;
      // after prepending c1
      const int d1 = U.s_c1 - L.s_c1;
      const int nlo1 = sel5(pred, c1) + L.s_c1;
      const int nhi1 = sel5(pred, c1) + U.s_c1 - 1;
      const int nrlo1 = rlo + U.s_below - L.s_below;
      const int nrhi1 = nrlo1 + d1 - 1;
      // after prepending c2 as well: K[c2][c1] + occ2((c2, c1), .)
      const int kv = c2 > 0 ? __ldg(K + c2 * 5 + c1) : 0;
      const int nlo2 = kv + L.p_c2;
      const int nhi2 = kv + U.p_c2 - 1;
      const int d2 = U.p_c2 - L.p_c2;
      const int nrlo2 = nrlo1 + U.p_below - L.p_below;
      const int nrhi2 = nrlo2 + d2 - 1;
      // '$'-probe blocks of the states at t and at t + 1
      const int psize0 = U.s_0 - L.s_0;
      if (psize0 > 0 && rlo + psize0 - 1 >= 0 && t >= a.p1) {
        if (leader && count < cap) out[count] = make_int4(lo, rlo, hi - lo, t - a.t0);
        ++count;
      }
      const int psize1 = U.p_0 - L.p_0;
      if (psize1 > 0 && nrlo1 + psize1 - 1 >= 0 && act2 && t + 1 >= a.p1) {
        if (leader && count < cap) out[count] = make_int4(nlo1, nrlo1, d1 - 1, t + 1 - a.t0);
        ++count;
      }
      if (act2) {
        lo = nlo2; hi = nhi2; rlo = nrlo2; rhi = nrhi2;
      } else {
        lo = nlo1; hi = nhi1; rlo = nrlo1; rhi = nrhi1;
      }
    }

    // finals: left extensions in the own table, right extensions in the
    // other one, and the closed-form '$'-probe of the full-length interval
    const int other = a.nblocks - tab;
    RowSlice r2, r3;
    r0.load(a.plane, nrows, tab, lo - 1, j, false);
    r1.load(a.plane, nrows, tab, hi, j, false);
    r2.load(a.plane, nrows, other, rlo - 1, j, false);
    r3.load(a.plane, nrows, other, rhi, j, false);
    int rl[5], ru[5];
    pair_occ::singles(r0, j, gmask, ls);
    pair_occ::singles(r1, j, gmask, us);
    pair_occ::singles(r2, j, gmask, rl);
    pair_occ::singles(r3, j, gmask, ru);
    int lext = 0, rext = 0;
#pragma unroll
    for (int c = 1; c < 5; ++c) {
      lext += us[c] - ls[c];
      rext += ru[c] - rl[c];
    }
    substring = lext > 0 || rext > 0;
    const int l0 = ls[0], u0 = us[0], psize = u0 - l0;
    fvalid = psize > 0 && u0 - 1 >= 0 && rlo + psize - 1 >= 0 && rlo + psize - 1 >= rlo;
    if (leader) {
      lane_counts[lane] = count;
      fall[lane] = lo;
      fall[a.lanes + lane] = rlo;
      fall[2 * a.lanes + lane] = l0;
      fall[3 * a.lanes + lane] = hi - lo;
      fall[4 * a.lanes + lane] = psize;
    }
  }
  lane_scan::write_lane_bits<kGroup>(leader, fvalid, substring, lane, candmask, subwords);
}

}  // namespace

// One launch scans lanes [lane_base, lane_base + nl) (lane_base a multiple of
// 32), kGroup threads a lane: per lane its count, finals and emitted
// rows (slab [nl, cap] int4, lane-major); the candidate and substring bits
// are OR-ed into candmask and subwords.
extern "C" int siga_scan_pair(
    const void* plane, const void* K2, const void* pred, const void* la_words,
    const void* lens, int length, int nblocks, int n, int wpr, int nfwd,
    int groups_code, int lim_t, int p1, int t0, int lanes, int lane_base, int nl,
    int cap, void* lane_counts, void* fall, void* candmask, void* subwords,
    void* slab, void* stream) {
  const ScanArgs a{static_cast<const int*>(plane), static_cast<const int*>(K2),
                   static_cast<const int*>(pred), static_cast<const int*>(la_words),
                   static_cast<const int*>(lens), length, nblocks, n, wpr, nfwd,
                   groups_code, lim_t, p1, t0, lanes};
  if (lane_base % 32 != 0 || nl <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(nl) * kGroup;
  const int grid = static_cast<int>((threads + kThreads - 1) / kThreads);
  scan_pair_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, lane_base, nl, cap, static_cast<int*>(lane_counts), static_cast<int*>(fall),
      static_cast<unsigned*>(candmask), static_cast<unsigned*>(subwords),
      static_cast<int4*>(slab));
  return static_cast<int>(cudaGetLastError());
}

// Threads a lane of K1 and a k-mer of K7.
extern "C" int siga_lane_group() { return kGroup; }
