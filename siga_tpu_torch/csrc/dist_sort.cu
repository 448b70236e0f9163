// K8: the distributed index build's steps around its radix passes, for
// sm_90a (`parallel/dist_build.py`, which runs the route and holds each step
// in plain PyTorch beside its wrapper, `*_plain`).
//
// Replaces siga_tpu/parallel/dist_build.py::_dist_sa_program with
// _bitonic_device_sort, _halo_next, _halo_prev_last and
// _global_exclusive_prefix (XLA programs over a TPU mesh), and the torch-ops
// route that ported them (dist_build.py at commit 929606b): its D - 1
// three-level compares a segment to size the buckets (`_lex_gt`), its stable
// re-sort of every bucket (three passes in the seed, one a round), its
// cumsum numbering with the run counts to the host (`_number_runs`) and its
// two scatters back to text order (`_to_text_order`).  Segment k holds S
// positions; a global sort is a PSRS exchange of segments already sorted by
// `torch.sort` (K6's `seed_keys`, `gather_keys` and `round_keys` build their
// keys).  The four kernels:
//  1. levels: a segment's columns in its sort order: o = order[idx[j]], and
//     key_b, sentpos and the BWT payload of o (the code before o, or on a '$'
//     row (rid << 3), rid by a binary search over the segment's sentinels);
//  2. bounds: each splitter's rows at or below it in a sorted segment, a
//     32-way search by one warp a splitter (5 rounds at 12.6 M rows);
//  3. merge: two sorted runs merged stably (ties to the first run), the
//     D pieces of a bucket by a tree of them: the merge path, each block's
//     two splits found by a 32-way warp search over the runs, its share of
//     both runs' keys staged in shared memory, a thread's eight outputs
//     merged from its own split in shared memory, and every column written
//     in coalesced order through the merged rows' sources;
//  4. number: each row of a bucket ranked by the global slot of its run's
//     first row (a max scan over the bucket: warp ballots inside a tile, a
//     decoupled look-back across tiles as K6's, and the previous bucket's
//     last rank for a run that starts before the bucket), stored straight
//     into its segment's rank table at its text position.
// What bounds them on an H100: bytes.  Each reads its inputs and writes its
// outputs once: a gather through a permutation reads 32-byte sectors
// (levels), the merge reads each run's columns once and writes the
// bucket's once, the numbering reads the bucket's keys and positions once
// and stores each rank at a random text position (a sector a row, the rate
// of K6's rank stores).  The design moves each array once a step: the
// bucket is merged from its sorted pieces in one pass a tree level (one for
// D = 2) where the torch route re-sorted it (8-24 digit passes of key and
// int64 index), the sizes come from a binary search where the torch route
// compared every row with every splitter, and the ranks need neither the
// run counts on the host nor an inverse of the bucket's order.
#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                 // a thread's items: one row of 32 a warp at a time
constexpr int kWarpItems = 32 * kItems;
constexpr int kTile = kThreads * kItems;  // rows a block (the scratch of siga_sa_scan_scratch)
constexpr int kGatherItems = 4;           // rows a thread of `levels`
constexpr int kMaxSegments = 16;          // rank tables a numbering takes
constexpr unsigned kGram = 64;            // sentpos of a suffix with no '$' in its seed
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 63;  // the word holds the tile's own head
constexpr unsigned long long kInclusive = 1ull << 62;  // the word holds the head up to the tile

// A row's columns (null where absent): keys, position, BWT payload.
struct Cols {
  const long long* k1;
  const long long* k2;         // the seed's key_b
  const unsigned char* sp;     // the seed's sentpos
  const long long* pos;
  const long long* pay;
};

struct OutCols {
  long long* k1;
  long long* k2;
  unsigned char* sp;
  long long* pos;
  long long* pay;
};

// A row's keys; kSeed: (key_a, key_b, sentpos), else (key).
template <bool kSeed>
struct Key {
  long long k1, k2;
  unsigned sp;
};

template <bool kSeed>
__device__ __forceinline__ Key<kSeed> load_key(const Cols& c, long long i) {
  Key<kSeed> k{c.k1[i], 0, 0u};
  if (kSeed) {
    k.k2 = c.k2[i];
    k.sp = c.sp[i];
  }
  return k;
}

// -1, 0 or 1 as a is below, equal to or above b.
template <bool kSeed>
__device__ __forceinline__ int cmp(const Key<kSeed>& a, const Key<kSeed>& b) {
  if (a.k1 != b.k1) return a.k1 < b.k1 ? -1 : 1;
  if (kSeed) {
    if (a.k2 != b.k2) return a.k2 < b.k2 ? -1 : 1;
    if (a.sp != b.sp) return a.sp < b.sp ? -1 : 1;
  }
  return 0;
}

// The first index in [lo, hi) where a predicate that is true and then
// false is false (hi where it is never false), by the whole warp: each round
// tests 32 evenly spaced indices, and the range shrinks 32-fold.
template <class Pred>
__device__ long long warp_partition(long long lo, long long hi, Pred pred) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long at = lo + lane * step;
    const int trues = __popc(__ballot_sync(kFull, at < hi && pred(at)));
    if (trues == 0) return lo;
    const long long last = lo + (trues - 1) * step;
    lo = last + 1;
    hi = min(hi, last + step);
  }
  return lo;
}

// --- 1. levels

__device__ __forceinline__ long long count_below(const int* __restrict__ s, int n, long long x) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (s[lo + half] < x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// kGatherItems rows a thread, a block's kThreads apart, each level of loads
// issued for all of them before the next (the gathers are random reads).
__global__ void __launch_bounds__(kThreads)
levels_kernel(const long long* __restrict__ idx, const long long* __restrict__ order,
              const long long* __restrict__ key, const unsigned char* __restrict__ sentpos,
              const unsigned char* __restrict__ codes, const int* __restrict__ sents, int n_sents,
              long long rid_base, long long m, long long* __restrict__ out_pos,
              long long* __restrict__ out_key, unsigned char* __restrict__ out_sp,
              long long* __restrict__ out_pay) {
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads * kGatherItems + threadIdx.x;
  long long o[kGatherItems], kv[kGatherItems];
  unsigned sv[kGatherItems], cv[kGatherItems];
#pragma unroll
  for (int j = 0; j < kGatherItems; ++j) {
    const long long i = first + j * kThreads;
    o[j] = i < m ? idx[i] : 0;
  }
  if (order) {
#pragma unroll
    for (int j = 0; j < kGatherItems; ++j) {
      if (first + j * kThreads < m) o[j] = order[o[j]];
    }
  }
#pragma unroll
  for (int j = 0; j < kGatherItems; ++j) {
    const bool real = first + j * kThreads < m;
    kv[j] = real && key ? key[o[j]] : 0;
    sv[j] = real && sentpos ? sentpos[o[j]] : 0u;
    cv[j] = real && codes ? codes[o[j]] : 0u;
  }
#pragma unroll
  for (int j = 0; j < kGatherItems; ++j) {
    const long long i = first + j * kThreads;
    if (i >= m) continue;
    if (out_pos) out_pos[i] = o[j];
    if (out_key) out_key[i] = kv[j];
    if (out_sp) out_sp[i] = static_cast<unsigned char>(sv[j]);
    if (out_pay) {
      out_pay[i] = cv[j] ? static_cast<long long>(cv[j])
                         : (rid_base + count_below(sents, n_sents, o[j])) << 3;
    }
  }
}

// --- 2. bounds

// One warp a splitter: the rows of the sorted segment at or below it, the
// segment's positions with `base` added.
template <bool kSeed>
__global__ void __launch_bounds__(kThreads)
bounds_kernel(Cols c, long long m, long long base, Cols split, int nsplit,
              long long* __restrict__ out) {
  const int j = static_cast<int>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (j >= nsplit) return;
  const Key<kSeed> s = load_key<kSeed>(split, j);
  const long long spos = split.pos[j];
  const long long below = warp_partition(0, m, [&](long long i) {
    const int o = cmp(load_key<kSeed>(c, i), s);
    return o < 0 || (o == 0 && c.pos[i] + base <= spos);
  });
  if ((threadIdx.x & 31) == 0) out[j] = below;
}

// --- 3. merge

template <bool kSeed>
struct MergeShared {
  long long k1[kTile];
  long long k2[kSeed ? kTile : 1];
  unsigned char sp[kSeed ? kTile : 1];
  unsigned short src[kTile];  // the staged row of each output: a's, then b's
  long long split[2];         // rows of a before the block's first output, before its end
};

template <bool kSeed>
__device__ __forceinline__ Key<kSeed> shared_key(const MergeShared<kSeed>& sm, int i) {
  return {sm.k1[i], kSeed ? sm.k2[i] : 0, kSeed ? static_cast<unsigned>(sm.sp[i]) : 0u};
}

// Outputs [o0, o0 + kTile) of the merge of a (na rows) and b (nb rows): the
// rows of a among the first d outputs are the first index i where a[i] comes
// after b[d - 1 - i] (a row of a before a row of b with equal keys).
template <bool kSeed>
__global__ void __launch_bounds__(kThreads)
merge_kernel(Cols a, long long na, long long a_base, Cols b, long long nb, long long b_base,
             OutCols out) {
  __shared__ MergeShared<kSeed> sm;
  const int warp = threadIdx.x >> 5;
  const long long o0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long total = na + nb;
  if (warp < 2) {
    const long long d = min(o0 + warp * kTile, total);
    const long long cut = warp_partition(max(0ll, d - nb), min(d, na), [&](long long i) {
      return cmp(load_key<kSeed>(a, i), load_key<kSeed>(b, d - 1 - i)) <= 0;
    });
    if ((threadIdx.x & 31) == 0) sm.split[warp] = cut;
  }
  __syncthreads();
  const long long a0 = sm.split[0], b0 = o0 - a0;
  const int nt = static_cast<int>(min(o0 + kTile, total) - o0);
  const int nat = static_cast<int>(sm.split[1] - a0), nbt = nt - nat;
  for (int t = threadIdx.x; t < nt; t += kThreads) {
    const bool from_a = t < nat;
    const long long i = from_a ? a0 + t : b0 + (t - nat);
    const Key<kSeed> k = load_key<kSeed>(from_a ? a : b, i);
    sm.k1[t] = k.k1;
    if (kSeed) {
      sm.k2[t] = k.k2;
      sm.sp[t] = static_cast<unsigned char>(k.sp);
    }
  }
  __syncthreads();
  // this thread's kItems outputs, from its own split of the staged runs
  const int d = min(static_cast<int>(threadIdx.x) * kItems, nt);
  int lo = max(0, d - nbt), hi = min(d, nat);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cmp(shared_key(sm, mid), shared_key(sm, nat + d - 1 - mid)) <= 0) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo, j = d - lo;
  for (int k = 0; k < kItems && d + k < nt; ++k) {
    const bool take_a =
        i < nat && (j >= nbt || cmp(shared_key(sm, i), shared_key(sm, nat + j)) <= 0);
    sm.src[d + k] = static_cast<unsigned short>(take_a ? i++ : nat + j++);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nt; t += kThreads) {
    const int s = sm.src[t];
    const long long o = o0 + t;
    if (out.k1) out.k1[o] = sm.k1[s];
    if (kSeed && out.k2) out.k2[o] = sm.k2[s];
    if (kSeed && out.sp) out.sp[o] = sm.sp[s];
    const bool from_a = s < nat;
    const long long at = from_a ? a0 + s : b0 + (s - nat);
    if (out.pos) out.pos[o] = (from_a ? a.pos[at] + a_base : b.pos[at] + b_base);
    if (out.pay) out.pay[o] = from_a ? a.pay[at] : b.pay[at];
  }
}

// --- 4. number

struct Tabs {
  int* p[kMaxSegments];
};

__device__ __forceinline__ unsigned long long load_word(const unsigned long long* w) {
  return cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(
             *const_cast<unsigned long long*>(w)).load(cuda::std::memory_order_relaxed);
}

__device__ __forceinline__ void store_word(unsigned long long* w, unsigned long long v) {
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(*w).store(
      v, cuda::std::memory_order_relaxed);
}

struct ScanShared {
  unsigned warp_head[kWarps];
  unsigned warp_base[kWarps];
  int ticket;
};

// The tile this block scans, taken in order from a counter (the word after
// the tiles' words), so a look-back only waits on a tile running or done.
__device__ int take_ticket(unsigned long long* state, int tiles, ScanShared& sh) {
  if (threadIdx.x == 0) {
    sh.ticket = static_cast<int>(atomicAdd(reinterpret_cast<unsigned*>(state + tiles), 1u));
  }
  __syncthreads();
  return sh.ticket;
}

// Decoupled look-back by one whole warp (K6's, csrc/suffix_sort.cu, over a
// largest head alone): publishes the tile's own head, returns in every lane
// the largest head of the tiles before it, and publishes its inclusive head.
__device__ unsigned look_back(int tile, unsigned agg, unsigned long long* state) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) store_word(state, kInclusive | agg);
    return 0u;
  }
  if (lane == 0) store_word(state + tile, kAggregate | agg);
  unsigned base = 0u;
  for (int first = tile - 1;;) {
    const int t = first - lane;
    const unsigned long long w = t >= 0 ? load_word(state + t) : kInclusive;
    const unsigned none = __ballot_sync(kFull, (w & (kAggregate | kInclusive)) == 0);
    const unsigned incl = __ballot_sync(kFull, (w & kInclusive) != 0);
    const unsigned upto = incl ? (incl & (0u - incl)) * 2u - 1u : kFull;
    if (none & upto) continue;
    if ((upto >> lane) & 1u) base = max(base, static_cast<unsigned>(w));
    if (incl) break;
    first -= 32;
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) base = max(base, __shfl_xor_sync(kFull, base, s));
  if (lane == 0) store_word(state + tile, kInclusive | max(base, agg));
  return base;
}

// A bucket's rows ranked: see the file's note.  Item j of a lane is row
// base + warp * kWarpItems + 32 j + lane.
template <bool kSeed>
__global__ void __launch_bounds__(kThreads)
number_kernel(Cols c, int m, Cols prev, long long off, Tabs tabs, int seg,
              unsigned long long* __restrict__ state, int tiles) {
  __shared__ ScanShared sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = take_ticket(state, tiles, sh);
  const long long base = static_cast<long long>(tile) * kTile + warp * kWarpItems + lane;
  long long pos[kItems];
  bool starts[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + 32 * j;
    pos[j] = i < m ? c.pos[i] : 0;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + 32 * j;
    starts[j] = false;
    if (i < m) {
      const Key<kSeed> x = load_key<kSeed>(c, i);
      const bool has = i > 0 || prev.k1;
      starts[j] = !has || cmp(x, i > 0 ? load_key<kSeed>(c, i - 1) : load_key<kSeed>(prev, 0)) ||
                  (kSeed && x.sp != kGram);
    }
  }
  unsigned head = 0u, head_at[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    // the largest slot of a run start at or before each item: the slot grows
    // with the lane, so it is the last start's
    const unsigned value = static_cast<unsigned>(off + base + 32 * j);
    const unsigned b = __ballot_sync(kFull, starts[j]);
    const unsigned upto = b & (kFull >> (31 - lane));
    const unsigned at = __shfl_sync(kFull, value, upto ? 31 - __clz(upto) : 0);
    head_at[j] = upto ? max(head, at) : head;
    if (b) head = max(head, __shfl_sync(kFull, value, 31 - __clz(b)));
  }
  if (lane == 0) sh.warp_head[warp] = head;
  __syncthreads();
  if (warp == 0) {
    unsigned total = 0u, before = 0u;
    for (int w = 0; w < kWarps; ++w) {
      if (w == lane) before = total;
      total = max(total, sh.warp_head[w]);
    }
    const unsigned tile_base = look_back(tile, total, state);
    if (lane < kWarps) sh.warp_base[lane] = max(tile_base, before);
  }
  __syncthreads();
  unsigned carry = sh.warp_base[warp];
  if (prev.pos) {
    const long long p = prev.pos[0];
    const int k = static_cast<int>(p / seg);
    carry = max(carry, static_cast<unsigned>(tabs.p[k][p - static_cast<long long>(k) * seg]));
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (base + 32 * j >= m) continue;
    const int k = static_cast<int>(pos[j] / seg);
    tabs.p[k][pos[j] - static_cast<long long>(k) * seg] = static_cast<int>(max(carry, head_at[j]));
  }
}

int blocks_of(long long items, long long per) { return static_cast<int>((items + per - 1) / per); }

bool bad_size(long long n) { return n < 0 || n >= (1ll << 31) - kTile; }

Cols cols(const void* k1, const void* k2, const void* sp, const void* pos, const void* pay) {
  return {static_cast<const long long*>(k1), static_cast<const long long*>(k2),
          static_cast<const unsigned char*>(sp), static_cast<const long long*>(pos),
          static_cast<const long long*>(pay)};
}

}  // namespace

// Row j of m: o = order[idx[j]] (idx[j] where order is null), and where the
// output is not null o itself, key[o] (int64), sentpos[o] (uint8) and the
// payload of o (int64: codes[o] if not 0, else (rid_base + the entries of
// sents (int32, ascending, n_sents of them) below o) << 3).
extern "C" int siga_dist_levels(const void* idx, const void* order, const void* key,
                                const void* sentpos, const void* codes, const void* sents,
                                int n_sents, long long rid_base, long long m, void* out_pos,
                                void* out_key, void* out_sp, void* out_pay, void* stream) {
  if (bad_size(m) || n_sents < 0 || !idx || !order != !out_pos || !key != !out_key ||
      !sentpos != !out_sp || !codes != !out_pay || (codes && n_sents && !sents)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  levels_kernel<<<blocks_of(m, static_cast<long long>(kThreads) * kGatherItems), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(idx), static_cast<const long long*>(order),
      static_cast<const long long*>(key), static_cast<const unsigned char*>(sentpos),
      static_cast<const unsigned char*>(codes), static_cast<const int*>(sents), n_sents, rid_base,
      m, static_cast<long long*>(out_pos), static_cast<long long*>(out_key),
      static_cast<unsigned char*>(out_sp), static_cast<long long*>(out_pay));
  return static_cast<int>(cudaGetLastError());
}

// out[j] (int64 [nsplit]): the rows of the sorted segment (k1, k2, sp, pos;
// k2 and sp both given or both null) whose (keys, pos + base) are at or below
// splitter j's (s_k1, s_k2, s_sp, s_pos, the positions global).
extern "C" int siga_dist_bounds(const void* k1, const void* k2, const void* sp, const void* pos,
                                long long m, long long base, const void* s_k1, const void* s_k2,
                                const void* s_sp, const void* s_pos, int nsplit, void* out,
                                void* stream) {
  const bool seed = k2 != nullptr;
  if (bad_size(m) || nsplit < 0 || !k1 || !pos || !s_k1 || !s_pos || !out || !sp != !seed ||
      !s_k2 != !seed || !s_sp != !seed) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nsplit == 0) return static_cast<int>(cudaSuccess);
  const Cols c = cols(k1, k2, sp, pos, nullptr), s = cols(s_k1, s_k2, s_sp, s_pos, nullptr);
  const auto st = static_cast<cudaStream_t>(stream);
  long long* o = static_cast<long long*>(out);
  if (seed) {
    bounds_kernel<true><<<blocks_of(nsplit, kWarps), kThreads, 0, st>>>(c, m, base, s, nsplit, o);
  } else {
    bounds_kernel<false><<<blocks_of(nsplit, kWarps), kThreads, 0, st>>>(c, m, base, s, nsplit, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// The sorted runs a (na rows) and b (nb rows) merged into out (na + nb rows),
// a row of a first among equal keys: keys k1 (int64), with k2 (int64) and
// sp (uint8) in the seed (all three given in a, b alike), positions pos
// (int64, a_base and b_base added) and payload pay (int64).  An output
// column that is null is not written (and its inputs are not read); an
// empty run's columns may be null.
extern "C" int siga_dist_merge(const void* a_k1, const void* a_k2, const void* a_sp,
                               const void* a_pos, const void* a_pay, long long na, long long a_base,
                               const void* b_k1, const void* b_k2, const void* b_sp,
                               const void* b_pos, const void* b_pay, long long nb, long long b_base,
                               void* o_k1, void* o_k2, void* o_sp, void* o_pos, void* o_pay,
                               void* stream) {
  // an empty run's columns may be null (an empty allocation); it is not read
  const bool seed = a_k2 != nullptr || b_k2 != nullptr;
  const auto bad_run = [&](long long n, const void* k1, const void* k2, const void* sp,
                           const void* pos, const void* pay) {
    return n > 0 && (!k1 || !k2 != !seed || !sp != !seed || (o_pos && !pos) || (o_pay && !pay));
  };
  if (na < 0 || nb < 0 || bad_size(na + nb) || (o_k2 && !seed) ||
      bad_run(na, a_k1, a_k2, a_sp, a_pos, a_pay) || bad_run(nb, b_k1, b_k2, b_sp, b_pos, b_pay)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (na + nb == 0) return static_cast<int>(cudaSuccess);
  const Cols a = cols(a_k1, a_k2, a_sp, a_pos, a_pay), b = cols(b_k1, b_k2, b_sp, b_pos, b_pay);
  const OutCols o{static_cast<long long*>(o_k1), static_cast<long long*>(o_k2),
                  static_cast<unsigned char*>(o_sp), static_cast<long long*>(o_pos),
                  static_cast<long long*>(o_pay)};
  const int grid = blocks_of(na + nb, kTile);
  const auto st = static_cast<cudaStream_t>(stream);
  if (seed) {
    merge_kernel<true><<<grid, kThreads, 0, st>>>(a, na, a_base, b, nb, b_base, o);
  } else {
    merge_kernel<false><<<grid, kThreads, 0, st>>>(a, na, a_base, b, nb, b_base, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// A bucket's m sorted rows (k1, k2, sp, pos; k2 and sp both given or both
// null; pos global) ranked into the rank tables (tabs: a host array of ntabs
// int32 tables of seg rows, rank of position p at tabs[p / seg][p % seg]):
// the slot off + i of its run's first row, prev (the previous non-empty
// bucket's last row, the same columns, or all null) ranked before.  scratch:
// siga_sa_scan_scratch(m) words.
extern "C" int siga_dist_number(const void* k1, const void* k2, const void* sp, const void* pos,
                                long long m, const void* p_k1, const void* p_k2, const void* p_sp,
                                const void* p_pos, long long off, const void* tabs, int ntabs,
                                long long seg, void* scratch, void* stream) {
  const bool seed = k2 != nullptr;
  if (bad_size(m) || off < 0 || off + m >= (1ll << 31) || ntabs < 1 || ntabs > kMaxSegments ||
      seg < 1 || seg >= (1ll << 31) || !k1 || !pos || !tabs || !scratch || !sp != !seed ||
      !p_k1 != !p_pos || (p_k1 && (!p_k2 != !seed || !p_sp != !seed))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  Tabs t{};
  for (int k = 0; k < ntabs; ++k) t.p[k] = static_cast<int* const*>(tabs)[k];
  const auto st = static_cast<cudaStream_t>(stream);
  const int tiles = blocks_of(m, kTile);
  const cudaError_t rc =
      cudaMemsetAsync(scratch, 0, sizeof(unsigned long long) * (tiles + 1), st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const Cols c = cols(k1, k2, sp, pos, nullptr), p = cols(p_k1, p_k2, p_sp, p_pos, nullptr);
  auto* words = static_cast<unsigned long long*>(scratch);
  if (seed) {
    number_kernel<true><<<tiles, kThreads, 0, st>>>(c, static_cast<int>(m), p, off, t,
                                                   static_cast<int>(seg), words, tiles);
  } else {
    number_kernel<false><<<tiles, kThreads, 0, st>>>(c, static_cast<int>(m), p, off, t,
                                                    static_cast<int>(seg), words, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
