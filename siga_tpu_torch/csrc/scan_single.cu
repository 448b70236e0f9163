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
// A single-step row (16 int32) covers one 128-symbol BWT block: 8 words of
// 2-bit symbols ('$' packs as A, code 0), 4 words of the '$' mask (one bit a
// symbol) and the exclusive A, C, G, T checkpoints; the '$' checkpoint is
// block * 128 minus their sum.
//
// The design is K1's (scan_pair.cu, pair_occ.cuh) with one symbol a step:
//  - a group of kGroup = 8 threads serves one lane; thread j loads symbol word
//    j and the row's word 8 + j (the '$' mask word j for j < 4, the checkpoint
//    of rank j - 3 for j >= 4), so a group reads a row as two 32-byte
//    accesses, and both rows' loads are issued before either is summed;
//    thread j takes the 16 '$' bits of its symbol word from thread j / 2 by a
//    shuffle and spreads them to the even bits;
//  - the group sums the three counts a step uses per row (the symbol's, the
//    ones below it with '$', and '$'), both rows' six in one butterfly of
//    shuffles (`step_sums`); the '$' checkpoint enters as block * 128 after
//    the sums and minus each ACGT checkpoint before them;
//  - a lane stops after its last live step (t <= len - 2);
//  - one pass: the leader writes the emitted [lo, rlo, size, t - p1] rows into
//    the lane's slab of `cap` = lim_t - p1 int4 (one a step at most, only at t
//    in [p1, lim_t - 1]), the counts and the finals; the caller compacts the
//    slabs (ops/fm_device.py::compact_slab) and splits the lanes over several
//    launches where the slabs do not fit in free device memory;
//  - the candidate and substring bits are a ballot of the group leaders
//    (lane_scan.cuh).
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

#include "lane_scan.cuh"
#include "pair_occ.cuh"

namespace {

using lane_scan::step_char;
using pair_occ::group_sum;
using pair_occ::kGroup;
using pair_occ::sel5;
using pair_occ::tail_mask;

constexpr int kThreads = 64;
constexpr int kCols = 16;  // 8 symbol words | 4 '$' words | A, C, G, T checkpoints
constexpr int kSample = 128;
constexpr int kMaxShards = 16;  // ops/fm_device.py MAX_SHARDS

struct SingleArgs {
  const int* plane;     // [2 * nblocks, 16]: forward rows, then reverse rows
  const int* pred;      // [5]: C(c), shared by both directions
  const int* la_words;  // [n, wpr]: left-aligned reads, 2 bits a symbol
  const int* lens;      // [n]
  int length, nblocks, n, wpr, nfwd, groups_code, lim_t, p1, lanes;
};

// 16 one-bit flags -> bit 2k of the result for flag k (the even-bit format of
// the symbol masks).
__device__ __forceinline__ unsigned spread16(unsigned x) {
  x &= 0xFFFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  x = (x | (x << 1)) & 0x55555555u;
  return x;
}

// Where row r of the stacked plane lives: one allocation ...
struct WholePlane {
  const int* plane;

  __device__ __forceinline__ const unsigned* row(int r) const {
    return reinterpret_cast<const unsigned*>(plane) + static_cast<size_t>(r) * kCols;
  }
};

// ... or the shard r / bps, at its row r % bps (`base` in shared memory).
// The quotient comes from a multiply by inv = floor((2^32 - 1) / bps), which
// gives r / bps or one less for every r < 2^31, and one correction: a few
// instructions where the divide by a runtime bps took some twenty, on the
// path from a step's interval to its row loads.
struct ShardedPlane {
  const int* const* base;
  int bps;
  unsigned inv;

  __device__ __forceinline__ const unsigned* row(int r) const {
    int k = static_cast<int>(__umulhi(static_cast<unsigned>(r), inv));
    int local = r - k * bps;
    if (local >= bps) {
      ++k;
      local -= bps;
    }
    return reinterpret_cast<const unsigned*>(base[k]) + static_cast<size_t>(local) * kCols;
  }
};

// Thread j's share of the row that holds BWT position i (i >= -1) of the
// table whose rows start at `tab`: symbol word j (0 past the tail) and the
// row's word 8 + j.
struct SingleRow {
  unsigned w, aux, d;  // d: the '$' bits of word j, even-bit format (`finish`)
  int tail, block0;

  template <class Plane>
  __device__ __forceinline__ void load(const Plane& plane, int nrows, int tab, int i, int j) {
    const int pos = i + 1;
    block0 = pos / kSample;
    tail = pos - block0 * kSample;
    const unsigned* row = plane.row(min(max(block0 + tab, 0), nrows - 1));
    w = 16 * j < tail ? __ldg(row + j) : 0u;
    aux = (j >= 4 || 32 * j < tail) ? __ldg(row + 8 + j) : 0u;
  }

  // After `load`, in every thread of the group: '$' word j / 2 is thread
  // j / 2's aux.
  __device__ __forceinline__ void finish(int j, unsigned gmask) {
    const unsigned dw = __shfl_sync(gmask, aux, j >> 1, kGroup);
    d = spread16(dw >> (16 * (j & 1)));
  }
};

// What a step reads from one row, summed over the group: occ_c(i), the sum
// of occ_r(i) over r < c, and occ_$(i), for a symbol c in 1..4.
struct StepSums {
  int s_c, s_below, s_0;
};

// Thread j's share of a row's three step counts (before the group sum).
__device__ __forceinline__ void step_counts(const SingleRow& r, int j, int c, unsigned v[3]) {
  const unsigned wm = tail_mask(r.tail, j);
  v[0] = __popc(pair_occ::rank_mask(r.w, r.d, c) & wm);
  v[1] = __popc(pair_occ::below_mask(r.w, r.d, c) & wm);
  v[2] = __popc(r.d & wm);
  if (j >= 4) {  // checkpoint of rank j - 3; base_$ = block * 128 - sum of them
    const int rk = j - 3;
    v[0] += rk == c ? r.aux : 0u;
    v[1] += (rk < c ? r.aux : 0u) - r.aux;
    v[2] -= r.aux;
  }
}

// The step sums of both rows of a step (lo - 1 and hi), the six group sums
// taken by one butterfly: their shuffles are independent and written out
// side by side, so that they overlap.  (Summed one after another through
// group_sum, ptxas reused one register for every shuffle's result and
// serialised them: on an H100 that cost about 0.2 us a step where a lane's
// steps are the critical path, as at the contigs.)
__device__ __forceinline__ void step_sums(const SingleRow& r0, const SingleRow& r1, int j, int c,
                                          unsigned gmask, StepSums& L, StepSums& U) {
  unsigned v[6];
  step_counts(r0, j, c, v);
  step_counts(r1, j, c, v + 3);
#pragma unroll
  for (int off = kGroup / 2; off > 0; off /= 2) {
    unsigned other[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) other[k] = __shfl_xor_sync(gmask, v[k], off, kGroup);
#pragma unroll
    for (int k = 0; k < 6; ++k) v[k] += other[k];
  }
  const unsigned base0 = static_cast<unsigned>(r0.block0) * kSample;
  const unsigned base1 = static_cast<unsigned>(r1.block0) * kSample;
  L = {static_cast<int>(v[0]), static_cast<int>(v[1] + base0), static_cast<int>(v[2] + base0)};
  U = {static_cast<int>(v[3]), static_cast<int>(v[4] + base1), static_cast<int>(v[5] + base1)};
}

// All five counts s[c] = occ_c(i) of a row, summed over the group.
__device__ __forceinline__ void singles(const SingleRow& r, int j, unsigned gmask, int s[5]) {
  const unsigned wm = tail_mask(r.tail, j);
  unsigned m[5], v[5];
  pair_occ::sym_masks(r.w, r.d, m);
#pragma unroll
  for (int c = 0; c < 5; ++c) v[c] = __popc(m[c] & wm);
  if (j >= 4) {
#pragma unroll
    for (int c = 1; c < 5; ++c) v[c] += c == j - 3 ? r.aux : 0u;
    v[0] -= r.aux;
  }
  const unsigned base = static_cast<unsigned>(r.block0) * kSample;
#pragma unroll
  for (int c = 0; c < 5; ++c) s[c] = static_cast<int>(group_sum(gmask, v[c]) + (c == 0 ? base : 0u));
}

// The scan of one launch's lanes, its rows read through `plane`.
template <class Plane>
__device__ __forceinline__ void scan_lanes(const SingleArgs& a, const Plane& plane, int lane_base,
                                           int nl, int cap, int* lane_counts, int* fall,
                                           unsigned* candmask, unsigned* subwords, int4* slab) {
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
    const int tab = g < a.nfwd ? 0 : a.nblocks;
    const int len = __ldg(a.lens + row);
    int pred[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) pred[c] = __ldg(a.pred + c);
    lane_scan::SymReader rd(a.la_words + static_cast<size_t>(row) * a.wpr, len);

    int us[5], ls[5];
    SingleRow r0, r1;
    const int c0 = step_char(rd, group, -1);
    int lo = sel5(pred, c0);
    r0.load(plane, nrows, tab, a.length - 1, j);
    r0.finish(j, gmask);
    singles(r0, j, gmask, us);
    int hi = lo + sel5(us, c0) - 1;
    int rlo = lo;

    int count = 0;
    int4* out = slab + static_cast<size_t>(local) * cap;
    // steps with t <= len - 2; the rest are masked and change nothing
    const int steps = min(a.lim_t, max(len - 1, 0));
    for (int t = 0; t < steps; ++t) {
      const int c = step_char(rd, group, t);  // t <= len - 2: c in 1..4
      r0.load(plane, nrows, tab, lo - 1, j);
      r1.load(plane, nrows, tab, hi, j);
      r0.finish(j, gmask);
      r1.finish(j, gmask);
      StepSums L, U;
      step_sums(r0, r1, j, c, gmask, L, U);
      // the '$'-probe block of the state at t
      const int psize = U.s_0 - L.s_0;
      if (t >= a.p1 && psize > 0 && rlo + psize - 1 >= 0) {
        if (leader && count < cap) out[count] = make_int4(lo, rlo, hi - lo, t - a.p1);
        ++count;
      }
      rlo += U.s_below - L.s_below;
      lo = sel5(pred, c) + L.s_c;
      hi = sel5(pred, c) + U.s_c - 1;
    }
    const int rhi = rlo + hi - lo;  // the intervals keep equal sizes

    // finals: left extensions in the own table, right extensions in the
    // other one, and the closed-form '$'-probe of the full-length interval
    const int other = a.nblocks - tab;
    SingleRow r2, r3;
    r0.load(plane, nrows, tab, lo - 1, j);
    r1.load(plane, nrows, tab, hi, j);
    r2.load(plane, nrows, other, rlo - 1, j);
    r3.load(plane, nrows, other, rhi, j);
    r0.finish(j, gmask);
    r1.finish(j, gmask);
    r2.finish(j, gmask);
    r3.finish(j, gmask);
    int rl[5], ru[5];
    singles(r0, j, gmask, ls);
    singles(r1, j, gmask, us);
    singles(r2, j, gmask, rl);
    singles(r3, j, gmask, ru);
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

__global__ void __launch_bounds__(kThreads)
scan_single_kernel(SingleArgs a, int lane_base, int nl, int cap, int* lane_counts,
                   int* fall, unsigned* candmask, unsigned* subwords, int4* slab) {
  scan_lanes(a, WholePlane{a.plane}, lane_base, nl, cap, lane_counts, fall, candmask, subwords,
             slab);
}

struct ShardTable {
  const int* base[kMaxShards];  // shard k's row 0; unused entries null
  int bps;
  unsigned inv;  // floor((2^32 - 1) / bps), see ShardedPlane
};

__global__ void __launch_bounds__(kThreads)
scan_single_sharded_kernel(SingleArgs a, ShardTable shards, int lane_base, int nl, int cap,
                           int* lane_counts, int* fall, unsigned* candmask, unsigned* subwords,
                           int4* slab) {
  __shared__ const int* base[kMaxShards];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kMaxShards; ++k) base[k] = shards.base[k];
  }
  __syncthreads();
  scan_lanes(a, ShardedPlane{base, shards.bps, shards.inv}, lane_base, nl, cap, lane_counts, fall,
             candmask, subwords, slab);
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
// addresses this card can read, a peer's after siga_enable_peer_access).  One
// shard is the whole plane and runs scan_single_kernel (K3), more run
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
