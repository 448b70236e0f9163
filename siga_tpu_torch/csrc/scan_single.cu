// K3: the single-step stage-A scan of the overlap engine, for sm_90a.
//
// Replaces siga_tpu/ops/fm_device.py::_scan_packed_core (an XLA program on the
// TPU, which runs it when SIGA_PAIR_STEP=0 and in its index-sharded mode);
// siga_tpu_torch/ops/fm_device.py::scan_single_plain is the same function in
// plain PyTorch.  Each lane (one read in one orientation) walks its read one
// symbol a step: the two 64-byte single-step rows that hold positions lo-1
// and hi give the occ counts of the prepended symbol, of the symbols below it
// and of '$', so one step is one backward-search update and one closed-form
// '$'-probe.
//
// A single-step row covers one 128-symbol BWT block (single_occ.cuh, whose
// row loader and counters K3 shares with K9, csrc/stage_a.cu).
//
// What bounds it on an H100.  A lane's steps are a chain: the rows of a step
// are known only once the step before has counted its own, so a lane takes
// at least its steps times the L2 round trip of a dependent row read (the
// 25.2 MB stacked plane of the 1 Mb x 25x cell sits in the 50 MB L2).  Where
// a few long lanes run (the 1,170 contig lanes, up to 38,628 steps) that
// chain and the work on it set the time; where the lanes fill the card (a
// chunk of 60,608 lanes of 150 bp reads) the chains overlap and the issue
// slots of every lane's step work do.
//
// The design:
//  - one thread serves a lane (kGroup; the readings of two threads and of
//    the earlier eight are at the constant).  A thread reads a row as four
//    16-byte vectors (symbol words 0-3, symbol words 4-7, the '$' words, the
//    checkpoints) and counts it alone: the symbols of one code by popcounts
//    of even-bit match masks below the query's tail, two words a popcount,
//    and the '$' bits of the mask words.  No shuffle, and no step work done
//    over again by several threads of a lane;
//  - only the prepended symbol's counts of the two rows feed the next rows,
//    so they are taken first, the next rows' loads are issued, and the
//    counts of the symbols below it and of '$' (the reverse interval, the
//    '$'-probe) are taken while those loads are in flight;
//  - when lo - 1 and hi fall in one row, that row is read once, and of a
//    row only the vectors that hold symbols below the query's tail;
//  - the reader loads the packed read's word of the next step during the
//    step before, so no read word is a dependent load on the chain;
//  - a lane stops after its last live step (t <= len - 2);
//  - one pass: the lane writes the emitted [lo, rlo, size, t - p1] rows into
//    its slab of `cap` = lim_t - p1 int4 (one a step at most, only at t in
//    [p1, lim_t - 1]), the counts and the finals; the caller compacts the
//    slabs (ops/fm_device.py::compact_slab) and splits the lanes over several
//    launches where the slabs do not fit in free device memory;
//  - the candidate and substring bits are a ballot (lane_scan.cuh).
//
// The index-sharded scan (scan_single_sharded_kernel, launched by the same
// entry when it is given more than one shard) is the same loop over a
// stacked plane split into D <= kMaxShards contiguous row ranges of `bps`
// rows, each its own allocation, on this card or on a peer: it replaces the
// JAX package's _build_sharded_scan (siga_tpu/ops/fm_device.py, the scan
// under shard_map with the occ of every step answered by the owner shard and
// a psum over the mesh).  Here there is no collective: every lane runs on
// this card and a row read goes to the shard that owns the (clamped) global
// row, at (row / bps, row % bps).  The D base pointers are copied from the
// kernel arguments to shared memory once a block, so that a per-lane shard
// index reads shared memory and not an indexed kernel-parameter array.
// What bounds it is K3's chain of dependent row reads; a shard on a peer
// card adds the peer link's latency to each of its row reads.
#include <cuda_runtime.h>

#include <cstdint>

#include "lane_scan.cuh"
#include "single_occ.cuh"

namespace {

using namespace single_occ;

// Threads a lane: one; scan_lanes is written for it.  Kernel device time
// on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): one thread 0.1496 ms at
// the error pipeline's first reads.ec.fa chunk (30,298 lanes) and 17.49 ms
// at its 1,170 contig lanes; two threads, a thread a row (thread 0 reading
// row lo - 1, thread 1 row hi, a shuffle of each count giving both the
// step), 0.1631 and 16.52 ms; the earlier groups of eight (`kernel_ab
// --scan`) 0.4230 and 21.03 ms.  One thread wins where the lanes fill the
// card (the fewest instructions a lane-step, and issue bounds it there),
// two where a few long lanes run (half the count work on a step's chain);
// one loses less, so it is kept.
constexpr int kGroup = 1;
constexpr int kThreads = 64;
// 8 blocks of 64 an SM at once, so at most 128 registers a thread: a
// 60,608-lane chunk at one thread a lane (460 threads an SM) runs in one wave
constexpr int kMinBlocks = 8;
constexpr int kMaxShards = 16;  // ops/fm_device.py MAX_SHARDS

struct SingleArgs {
  const int* plane;     // [2 * nblocks, 16]: forward rows, then reverse rows
  const int* pred;      // [5]: C(c), shared by both directions
  const int* la_words;  // [n, wpr]: left-aligned reads, 2 bits a symbol
  const int* lens;      // [n]
  int length, nblocks, n, wpr, nfwd, groups_code, lim_t, p1, lanes;
};

// Where row r of the stacked plane lives: one allocation (WholePlane,
// single_occ.cuh) or the shard r / bps, at its row r % bps (`base` in shared
// memory).
// The quotient comes from a multiply by inv = floor((2^32 - 1) / bps), which
// gives r / bps or one less for every r < 2^31, and one correction: a few
// instructions where the divide by a runtime bps took some twenty, on the
// path from a step's interval to its row loads.
struct ShardedPlane {
  const int* const* base;
  int bps;
  unsigned inv;

  __device__ __forceinline__ const uint4* row(int r) const {
    int k = static_cast<int>(__umulhi(static_cast<unsigned>(r), inv));
    int local = r - k * bps;
    if (local >= bps) {
      ++k;
      local -= bps;
    }
    return reinterpret_cast<const uint4*>(base[k]) + static_cast<size_t>(local) * (kCols / 4);
  }
};

// The symbols a lane prepends, one a step, from its left-aligned 2-bit read:
// s'[l-1], s'[l-2], ... of the lane's transformed read s' (ID: the read
// from its end; RC: the read from its start, complemented; REV: from its
// start; COMP: from its end, complemented; as lane_scan::step_char).  It
// holds the word of the current symbol, and loads the word of the next
// symbol during the step before the one that reads it (clamped to the
// read's row), so no read word is a dependent load on the chain.
struct StepReader {
  const unsigned* words;
  int last;       // the row's last word
  int pos, dir;   // the next symbol, and the direction of the walk
  unsigned flip;  // 3 to complement (code -> 3 - code)
  unsigned word;  // the word that holds symbol `pos`

  __device__ __forceinline__ StepReader(const int* w, int wpr, int len, int group)
      : words(reinterpret_cast<const unsigned*>(w)), last(wpr - 1) {
    const bool up = group == lane_scan::kRc || group == lane_scan::kRev;
    flip = (group == lane_scan::kRc || group == lane_scan::kComp) ? 3u : 0u;
    dir = up ? 1 : -1;
    pos = up ? 0 : len - 1;
    word = __ldg(words + min(max(pos >> 4, 0), last));
  }

  // rank 1..4 of the next symbol
  __device__ __forceinline__ int next() {
    const int c = static_cast<int>(((word >> (2 * (pos & 15))) & 3u) ^ flip) + 1;
    pos += dir;
    word = __ldg(words + min(max(pos >> 4, 0), last));
    return c;
  }
};

// The scan of one launch's lanes, a thread a lane, its rows read through
// `plane`: of a step the rows of lo - 1 and hi, of the finals also the rows
// of rlo - 1 and rhi in the other table.
template <class Plane>
__device__ __forceinline__ void scan_lanes(const SingleArgs& a, const Plane& plane, int lane_base,
                                           int nl, int cap, int* lane_counts, int* fall,
                                           unsigned* candmask, unsigned* subwords, int4* slab) {
  const int local = blockIdx.x * blockDim.x + threadIdx.x;  // lane within this launch
  const int lane = lane_base + local;
  bool fvalid = false, substring = false;
  if (local < nl) {
    const int nrows = 2 * a.nblocks;
    const int g = lane / a.n;
    const int read = lane - g * a.n;
    const int group = (a.groups_code >> (2 * g)) & 3;
    const int tab = g < a.nfwd ? 0 : a.nblocks;
    const int len = __ldg(a.lens + read);
    int pred[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) pred[c] = __ldg(a.pred + c);
    StepReader rd(a.la_words + static_cast<size_t>(read) * a.wpr, a.wpr, len, group);

    const int c0 = len > 0 ? rd.next() : 0;
    int lo = sel5(pred, c0), hi;
    {
      const Where q = where(a.length - 1, tab, nrows);
      int s[5];
      occ_all(load_row(plane, q.row), q, s);
      hi = lo + sel5(s, c0) - 1;
    }
    int rlo = lo;

    // the rows of lo - 1 (wq[0], rows[0]) and hi (wq[1], rows[1]), loaded
    // a step ahead.  As arrays: the same code over four scalars compiles to
    // 122 registers in place of 123 and ran 4-6% slower on an NVIDIA H100
    // 80GB HBM3 at 700 W (PERF.md)
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
    // the row of hi (that of lo - 1 when both are one row)
    auto row_hi = [&]() -> Row {
      const bool same = wq[1].row == wq[0].row;
      const Row& u = rows[1];
      const Row& l = rows[0];
      return Row{same ? l.s0 : u.s0, same ? l.s1 : u.s1, same ? l.d : u.d, same ? l.ck : u.ck};
    };
    load_step(lo, hi);

    int count = 0;
    int4* out = slab + static_cast<size_t>(local) * cap;
    // steps with t <= len - 2; the rest are masked and change nothing
    const int steps = min(a.lim_t, max(len - 1, 0));
    for (int t = 0; t < steps; ++t) {
      const int c = rd.next();  // t <= len - 2: c in 1..4
      // on the chain: occ_c of the two rows, then the next rows' loads
      const Row cur0 = rows[0], cur1 = row_hi();
      const Where q0 = wq[0], q1 = wq[1];
      StepRow st0, st1;
      const int s_lo = st0.occ_c(cur0, q0, c);
      const int s_hi = st1.occ_c(cur1, q1, c);
      const int pc = sel5(pred, c);
      const int nlo = pc + s_lo, nhi = pc + s_hi - 1;
      load_step(nlo, nhi);
      // off the chain: the counts below c and of '$' of this step's rows
      int b_lo, b_hi, d_lo, d_hi;
      st0.off_chain(cur0, q0, c, b_lo, d_lo);
      st1.off_chain(cur1, q1, c, b_hi, d_hi);
      // the '$'-probe block of the state at t
      const int psize = d_hi - d_lo;
      if (t >= a.p1 && psize > 0 && rlo + psize - 1 >= 0) {
        if (count < cap) out[count] = make_int4(lo, rlo, hi - lo, t - a.p1);
        ++count;
      }
      rlo += b_hi - b_lo;
      lo = nlo;
      hi = nhi;
    }
    const int rhi = rlo + hi - lo;  // the intervals keep equal sizes

    // finals: left extensions in the own table (the rows loaded last),
    // right extensions in the other one, and the closed-form '$'-probe of
    // the full-length interval; per row, the DNA count and occ_$
    const int other = a.nblocks - tab;
    int dna[4], dol[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      Where w;
      Row r;
      if (m < 2) {
        w = wq[m];
        r = m == 0 ? rows[0] : row_hi();
      } else {
        w = where(m == 2 ? rlo - 1 : rhi, other, nrows);
        r = load_row(plane, w.row);
      }
      int s[5];
      occ_all(r, w, s);
      dna[m] = s[1] + s[2] + s[3] + s[4];
      dol[m] = s[0];
    }
    const int lext = dna[1] - dna[0], rext = dna[3] - dna[2];
    substring = lext > 0 || rext > 0;
    const int l0 = dol[0], u0 = dol[1], psize = u0 - l0;
    fvalid = psize > 0 && u0 - 1 >= 0 && rlo + psize - 1 >= 0 && rlo + psize - 1 >= rlo;
    lane_counts[lane] = count;
    fall[lane] = lo;
    fall[a.lanes + lane] = rlo;
    fall[2 * a.lanes + lane] = l0;
    fall[3 * a.lanes + lane] = hi - lo;
    fall[4 * a.lanes + lane] = psize;
  }
  lane_scan::write_lane_bits<kGroup>(true, fvalid, substring, lane, candmask, subwords);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_single_kernel(SingleArgs a, int lane_base, int nl, int cap, int* lane_counts,
                   int* fall, unsigned* candmask, unsigned* subwords, int4* slab) {
  scan_lanes(a, WholePlane{a.plane}, lane_base, nl, cap, lane_counts, fall, candmask,
                     subwords, slab);
}

struct ShardTable {
  const int* base[kMaxShards];  // shard k's row 0; unused entries null
  int bps;
  unsigned inv;  // floor((2^32 - 1) / bps), see ShardedPlane
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_single_sharded_kernel(SingleArgs a, ShardTable shards, int lane_base, int nl, int cap,
                           int* lane_counts, int* fall, unsigned* candmask, unsigned* subwords,
                           int4* slab) {
  __shared__ const int* base[kMaxShards];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kMaxShards; ++k) base[k] = shards.base[k];
  }
  __syncthreads();
  scan_lanes(a, ShardedPlane{base, shards.bps, shards.inv}, lane_base, nl, cap,
                     lane_counts, fall, candmask, subwords, slab);
}

int grid_of(int nl) {
  const long long threads = static_cast<long long>(nl) * kGroup;
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// One launch scans lanes [lane_base, lane_base + nl) (lane_base a multiple of
// 32), kGroup threads a lane: per lane its count, finals and emitted rows
// (slab [nl, cap] int4, lane-major); the candidate and substring bits are
// OR-ed into candmask and subwords.  The stacked plane is `nshards` row ranges
// of `bps` rows: `shards` is a host array of their base pointers (device
// addresses this card can read, a peer's after siga_enable_peer_access; each
// 16-byte aligned, as the rows are read as 16-byte vectors).  One shard is
// the whole plane and runs scan_single_kernel (K3), more run
// scan_single_sharded_kernel.
extern "C" int siga_scan_single(
    const void* shards, int nshards, int bps, const void* pred, const void* la_words,
    const void* lens, int length, int nblocks, int n, int wpr, int nfwd, int groups_code,
    int lim_t, int p1, int lanes, int lane_base, int nl, int cap, void* lane_counts, void* fall,
    void* candmask, void* subwords, void* slab, void* stream) {
  if (lane_base % 32 != 0 || nl <= 0 || nshards < 1 || nshards > kMaxShards || bps < 1 ||
      static_cast<long long>(nshards) * bps < 2LL * nblocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* const* given = static_cast<const int* const*>(shards);
  for (int k = 0; k < nshards; ++k) {
    if (reinterpret_cast<std::uintptr_t>(given[k]) % 16 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  const SingleArgs a{given[0], static_cast<const int*>(pred),
                     static_cast<const int*>(la_words), static_cast<const int*>(lens),
                     length, nblocks, n, wpr, nfwd, groups_code, lim_t, p1, lanes};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* const counts = static_cast<int*>(lane_counts);
  int* const finals = static_cast<int*>(fall);
  unsigned* const cand = static_cast<unsigned*>(candmask);
  unsigned* const sub = static_cast<unsigned*>(subwords);
  int4* const rows = static_cast<int4*>(slab);
  if (nshards == 1) {
    scan_single_kernel<<<grid_of(nl), kThreads, 0, s>>>(a, lane_base, nl, cap, counts, finals,
                                                         cand, sub, rows);
  } else {
    ShardTable table{};
    for (int k = 0; k < nshards; ++k) table.base[k] = given[k];
    table.bps = bps;
    table.inv = 0xFFFFFFFFu / static_cast<unsigned>(bps);
    scan_single_sharded_kernel<<<grid_of(nl), kThreads, 0, s>>>(a, table, lane_base, nl, cap,
                                                                counts, finals, cand, sub, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// Lets the current card read `peer`'s memory (a shard of the sharded scan);
// 0 when it can, also when it already could.
extern "C" int siga_enable_peer_access(int peer) {
  cudaError_t rc = cudaDeviceEnablePeerAccess(peer, 0);
  if (rc == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it
    rc = cudaSuccess;
  }
  return static_cast<int>(rc);
}
