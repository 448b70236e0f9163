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
// Its bytes bound: at one overlap chunk's shape (60,608 lanes x 149 steps)
// it must move about 170 MB (the dense outputs 117 MB, the chars 36 MB, the
// plane), 0.051 ms at 3.35 TB/s; its chain of 151 dependent row reads
// takes about 0.035 ms at the L2 round trip (PERF.md).  What holds it far
// above both is its integer instructions: 60,608 lanes are 14 warps an SM
// at one thread a lane, each step is hundreds of instructions of counting,
// and probes/stage_a_parts.py found the first design (one thread a lane,
// K3's counts) at 0.213 of its 0.234 ms with its stores, its chars and its
// row reads all taken away.  So the design cuts instructions and hides the
// chain behind more warps:
//  - two threads a lane, one a row: side 0 counts the row of lo - 1, side 1
//    the row of hi, each loading its own row a step ahead (the whole row
//    when the prefix needs it, as K3's loader); the pair trades occ_c by
//    one shuffle and the differences of the counts below c and of '$' by
//    two, and keeps the same state.  28.7 warps an SM instead of 14, at
//    most 64 registers a thread, no spill;
//  - K9's own count (prefix_counts): three popcounts a pair of symbol words
//    give every code's count, the symbols past the prefix shifted out of a
//    64-bit pair instead of masked, the counts below and up to each code as
//    the bytes of two words that one byte permute picks from (each
//    design's instructions a step: probes/stage_a_parts.py, PERF.md);
//  - records stored as the first design stored them: a side's words of its
//    lane's record, valid from side 1.  Staging them through shared memory
//    a tile of steps at a time, as 16-byte runs, was slower in both designs
//    that tried it (commits cf411cd and 5b67bbc, PERF.md), and the chars
//    cost nothing to split off.
#include <cuda_runtime.h>

#include <cstdint>

#include "single_occ.cuh"

namespace {

using namespace single_occ;

constexpr int kThreads = 64;    // 32 lanes a block, two threads a lane
constexpr int kMinBlocks = 16;  // 32 warps an SM: at most 64 registers a thread

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

// x << s for s >= 0: 0 from s = 64 (32) on, since PTX clamps the shift
__device__ __forceinline__ unsigned long long shl64(unsigned long long x, int s) {
  unsigned long long y;
  asm("shl.b64 %0, %1, %2;" : "=l"(y) : "l"(x), "r"(s));
  return y;
}

__device__ __forceinline__ unsigned shl32(unsigned x, int s) {
  unsigned y;
  asm("shl.b32 %0, %1, %2;" : "=r"(y) : "r"(x), "r"(s));
  return y;
}

// What a step needs of a row's block prefix of `tail` symbols, in K9's own
// count (the counts are single_occ.cuh's count_eq / count_lt /
// count_dollar, in fewer instructions: the kernel is bound by its integer
// instructions, PERF.md).  A pair of symbol words (32 symbols) gives every
// code's count at once by three popcounts: the codes' low bits, their high
// bits, both ('$' packs as A, code 0).  The pair's symbols past the prefix
// are shifted out of the top rather than masked: an even shift keeps each
// symbol's two bits together, and a count does not see where they went.
// The counts of codes below k and up to k, for k = 0..3, are kept as the
// bytes of two words, so that a step picks its symbol's from each with one
// byte permute.
struct Prefix {
  unsigned below;  // byte k: the prefix's symbols of codes below k
  unsigned upto;   // byte k: of codes up to k
  int dollar;      // '$' bits of the prefix
};

__device__ __forceinline__ Prefix prefix_counts(const Row& r, int tail) {
  unsigned w[8];
  sym_words(r, w);
  const unsigned d[4] = {r.d.x, r.d.y, r.d.z, r.d.w};
  int n_lo = 0, n_hi = 0, n_both = 0, n_dollar = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned long long pair =
        shl64((static_cast<unsigned long long>(w[2 * j + 1]) << 32) | w[2 * j],
              max(64 * (j + 1) - 2 * tail, 0));
    const unsigned y0 = static_cast<unsigned>(pair), y1 = static_cast<unsigned>(pair >> 32);
    // y0's symbols at the even bits, y1's at the odd bits
    const unsigned lo = (y0 & kLo) | ((y1 << 1) & ~kLo);
    const unsigned hi = ((y0 >> 1) & kLo) | (y1 & ~kLo);
    n_lo += __popc(lo);
    n_hi += __popc(hi);
    n_both += __popc(lo & hi);
    n_dollar += __popc(shl32(d[j], max(32 * (j + 1) - tail, 0)));
  }
  // codes below k: 0, t - lo - hi + both, t - hi, t - both; up to 3: t
  const unsigned t = tail, nl = n_lo, nh = n_hi, nb = n_both;
  return Prefix{t * 0x01010100u - nl * 0x100u - nh * 0x10100u + nb * 0xFF000100u,
                t * 0x01010101u - nl - nh * 0x101u + nb * 0xFFFF0001u, n_dollar};
}

// x of rank c in 1..4 from its four values
__device__ __forceinline__ unsigned of_rank(int c, unsigned x1, unsigned x2, unsigned x3,
                                            unsigned x4) {
  unsigned out = x1;
  out = c == 2 ? x2 : out;
  out = c == 3 ? x3 : out;
  out = c == 4 ? x4 : out;
  return out;
}

// A step's counts of one row for the symbol of rank c: occ_c (on the
// chain; c = 0, '$': base_$ + the prefix's '$' bits; a base: its
// checkpoint + its code's symbols, A's less the '$' bits, since '$' packs
// as A), the sum of occ_r over r < c (`below`: base_$ + the checkpoints of
// ranks 1..c-1 = block * 128 - those of ranks c..4, + the codes below
// c - 1, + the '$' bits for c = 1) and occ_$.  `pick` is the byte permute
// that takes byte c - 1.
struct StepCounts {
  int occ, below, dollar;
};

__device__ __forceinline__ StepCounts step_counts(const Row& r, const Where& q, const Prefix& p,
                                                  int c, unsigned pick) {
  const unsigned t4 = r.ck.w, t3 = r.ck.z + t4, t2 = r.ck.y + t3, t1 = r.ck.x + t2;
  const unsigned base = static_cast<unsigned>(q.block0) * kSample;
  const int lt = static_cast<int>(__byte_perm(p.below, 0u, pick));
  const int le = static_cast<int>(__byte_perm(p.upto, 0u, pick));
  const int a_dollar = c == 1 ? p.dollar : 0;
  StepCounts s;
  s.dollar = static_cast<int>(base - t1) + p.dollar;
  s.below = static_cast<int>(base - of_rank(c, t1, t2, t3, t4)) + lt + a_dollar;
  const int occ = static_cast<int>(of_rank(c, r.ck.x, r.ck.y, r.ck.z, r.ck.w)) + (le - lt) - a_dollar;
  s.occ = c == 0 ? s.dollar : occ;
  return s;
}

// Thread 2l + side of lane l: side 0 keeps the row of lo - 1, side 1 the
// row of hi, each loaded a step ahead; the two trade a step's counts by
// shuffles within the pair and keep the same state.
__global__ void __launch_bounds__(kThreads, kMinBlocks) scan_stage_a_kernel(StageArgs a) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int lane = g >> 1, side = g & 1;
  if (lane >= a.L) return;  // both threads of the lane
  const unsigned pair = 3u << (threadIdx.x & 30);
  const WholePlane plane{a.plane};
  const int nrows = a.nrows, max_t = a.max_t;
  const int tab = a.tab != nullptr ? __ldg(a.tab + lane) : 0;
  const int len = __ldg(a.lens + lane);
  const int* chars = a.chars + static_cast<size_t>(lane) * (max_t + 1);
  int pred[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) pred[c] = __ldg(a.pred + c);

  const int c0 = __ldg(chars + max_t);
  int lo = sel5(pred, c0), hi;
  {
    const Where q = where(a.length - 1, tab, nrows);
    int s[5];
    occ_all(load_row(plane, q.row), q, s);
    hi = lo + sel5(s, c0) - 1;
  }
  int rlo = lo;

  // this side's row of the step: where lo - 1 (side 0) or hi (side 1) is
  // counted, loaded a step ahead
  Where q = where(side != 0 ? hi : lo - 1, tab, nrows);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  Row row{zero, zero, zero, zero};
  load_below(plane, q.row, q.tail, row);

  const size_t stride = static_cast<size_t>(a.L);
  int* em = a.emitted + static_cast<size_t>(lane) * 3 + 2 * side;  // side 0: lo, rlo; side 1: hi - lo
  unsigned char* va = a.valid + lane;
  // live steps t <= len - 2; the rest keep the state and emit it, not valid
  const int steps = min(max_t, max(len - 1, 0));
  int c = steps > 0 ? __ldg(chars) : 0;
  int t = 0;
  for (; t < steps; ++t) {
    const int c_next = t + 1 < steps ? __ldg(chars + t + 1) : 0;
    // on the chain: this side's counts, the other side's occ_c, the next row
    const StepCounts mine =
        step_counts(row, q, prefix_counts(row, q.tail), c, 0x4440u | ((c - 1) & 3));
    const int theirs = __shfl_xor_sync(pair, mine.occ, 1);
    const int pc = sel5(pred, c);
    const int nlo = pc + (side != 0 ? theirs : mine.occ);
    const int nhi = pc + (side != 0 ? mine.occ : theirs) - 1;
    q = where(side != 0 ? nhi : nlo - 1, tab, nrows);
    load_below(plane, q.row, q.tail, row);
    // off the chain: hi's counts less lo-1's, summed over the pair; the
    // '$'-probe of the state at t: prhi >= prlo and prhi >= 0
    const int mine_size = side != 0 ? mine.dollar : -mine.dollar;
    const int mine_below = side != 0 ? mine.below : -mine.below;
    const int psize = mine_size + __shfl_xor_sync(pair, mine_size, 1);
    const int below = mine_below + __shfl_xor_sync(pair, mine_below, 1);
    const bool ok = psize > 0 && rlo + psize - 1 >= 0 && t + 1 >= a.min_overlap;
    if (side == 0) {
      em[0] = lo;
      em[1] = rlo;
    } else {
      em[0] = hi - lo;
      *va = ok ? 1 : 0;
    }
    em += 3 * stride;
    va += stride;
    if (c != 0) rlo += below;  // nothing ranks below '$'
    lo = nlo;
    hi = nhi;
    c = c_next;
  }
  for (; t < max_t; ++t) {
    if (side == 0) {
      em[0] = lo;
      em[1] = rlo;
    } else {
      em[0] = hi - lo;
      *va = 0;
    }
    em += 3 * stride;
    va += stride;
  }

  // finals: the counts of the rows loaded last (lo - 1 and hi of the
  // full-length interval), the '$'-probe of that interval; side 0 writes
  // final, side 1 lext
  int mine[5], l[5], u[5];
  occ_all(row, q, mine);
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int theirs = __shfl_xor_sync(pair, mine[k], 1);
    l[k] = side != 0 ? theirs : mine[k];
    u[k] = side != 0 ? mine[k] : theirs;
  }
  if (side == 0) {
    int* fin = a.finals + static_cast<size_t>(lane) * 8;
    fin[0] = lo;
    fin[1] = hi;
    fin[2] = rlo;
    fin[3] = rlo + hi - lo;  // the intervals keep equal sizes
    fin[4] = pred[0] + l[0];
    fin[5] = pred[0] + u[0] - 1;
    fin[6] = rlo;
    fin[7] = rlo + u[0] - l[0] - 1;
  } else {
    int* ext = a.lext + static_cast<size_t>(lane) * 5;
#pragma unroll
    for (int k = 0; k < 5; ++k) ext[k] = u[k] - l[k];
  }
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
  const int grid = static_cast<int>((2LL * L + kThreads - 1) / kThreads);
  scan_stage_a_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
