// K6: the device suffix sort of the index build (`index -a sais2`), for
// sm_90a: every step of the sort but its radix passes, and the BWT and .sai
// permutation derived from the suffix array.
//
// Replaces siga_tpu/index/sa.py::_sa_build_v3 and _sa_bwt_perm_v3 (XLA
// programs on the TPU).  Their multi-key sorts are lax.sort, left to XLA;
// here they stay torch.sort.  siga_tpu_torch/index/sa.py runs the route and
// holds each step in plain PyTorch beside its wrapper (`*_plain`).  For a
// rank text of n characters ('$' = 0 < A < C < G < T, ending in '$'):
//  1. seed_keys: each position's distance to its first '$' capped at 64
//     (sentpos, one byte) and its first 64 symbols as four masked
//     big-endian 2-bit words in two order-preserving int64 keys; the
//     positions whose sentpos is 64 (the only ones that can tie) compacted
//     in text order (upos);
//  2. torch.sort by sentpos (one byte: the position tie-break is the sort's
//     stability), gather of key_b in that order, torch.sort, gather of key_a
//     through the composed order, torch.sort;
//  3. seed_ranks: the composed seed order; each row's group head (the slot
//     of the first row of its run of equal keys, where a row whose sentpos
//     is not 64 always starts a run) as the rank of its position; the slots
//     whose row has sentpos 64 compacted (uslot);
//  4. each doubling round, h = 64 << r: round_keys packs (rank, rank h
//     ahead + 1, or 0 past the end) of the upos positions; torch.sort sorts
//     only those; round_scatter writes the k-th sorted position into slot
//     uslot[k] of the order (the tied groups are whole, contiguous and in
//     rank order on both sides) and, before the last round, gives it its new
//     group head as its rank;
//  5. bwt_perm: bwt[i] = codes[sa[i] - 1] ('$' where sa[i] = 0), and the
//     read ids of the rows whose BWT symbol is '$' compacted in SA order.  A
//     read that starts at p > 0 follows the '$' at p - 1, and the first R
//     rows of the SA are the R sentinels in text order, so its id is one more
//     than that sentinel's row (a binary search over them).
// The compactions and the head ranks are one-pass scans: a block takes a
// tile ticket, scans its tile by warp ballots, and a decoupled look-back (as
// K2's, csrc/pair_plane.cu) over one 64-bit word a tile (two flags, a 31-bit
// count and a 31-bit largest head) gives the tile's prefix.  Heads grow with
// the slot, so the largest head at or before a row is its own.  No step
// waits on the host: the seed's compactions are sized n (their arrays
// zeroed first), and the host works out the rounds, the upos count and the
// reads from the text while the card sorts the seed.
//
// What bounds it on an H100: bytes.  Each kernel reads its inputs and writes
// its outputs once, a gather by a permutation as 32-byte sectors; the
// route's floor is the radix passes' traffic (PERF.md: key and int64 index
// read and written once a digit pass).  The design moves each array once a
// step: the seed keys from the text staged in shared memory (a '$' bit mask
// by ballot, the 2-bit words by a 16-lane OR, each position's keys from two
// words and a shift), the gathers fused with the composition of the pass
// orders, the boundary compares and the scan in the kernel that writes the
// order, and the doubling sorts over the positions that can tie alone (about
// 58% of a 150 bp read set's positions).
#include <cstdint>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                  // a thread's items: one row of 32 a warp at a time
constexpr int kWarpItems = 32 * kItems;
constexpr int kTile = kThreads * kItems;   // items a tile of a scan
constexpr int kGatherItems = 4;            // items a thread of the gathers
constexpr int kGram = 64;                  // symbols of the seed
constexpr int kHalo = 80;                  // codes past a position that its seed keys read
constexpr int kStage = kTile + 96;         // codes a seed tile stages: the tile, the halo
static_assert(kStage % 32 == 0 && kStage >= kTile + kHalo, "whole words of '$' bits");
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 63;  // the word holds the tile's own scan
constexpr unsigned long long kInclusive = 1ull << 62;  // the word holds the scan up to the tile
constexpr unsigned kField = 0x7fffffffu;

// A scan value: the flagged items, and the largest value of a boundary item
// (0 before the first).
struct Scan {
  unsigned count;
  unsigned head;
};

__device__ __forceinline__ Scan join(Scan a, Scan b) {
  return {a.count + b.count, max(a.head, b.head)};
}

__device__ __forceinline__ unsigned long long word(Scan s, unsigned long long flag) {
  return flag | static_cast<unsigned long long>(s.count & kField) << 31 | (s.head & kField);
}

__device__ __forceinline__ Scan unword(unsigned long long w) {
  return {static_cast<unsigned>(w >> 31) & kField, static_cast<unsigned>(w) & kField};
}

__device__ __forceinline__ unsigned long long load_word(const unsigned long long* w) {
  return cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(
             *const_cast<unsigned long long*>(w)).load(cuda::std::memory_order_relaxed);
}

__device__ __forceinline__ void store_word(unsigned long long* w, unsigned long long v) {
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(*w).store(
      v, cuda::std::memory_order_relaxed);
}

__device__ __forceinline__ long long pack64(unsigned hi, unsigned lo) {
  // sa.py::pack64: (hi - 2**31) * 2**32 + lo, ordered as the pairs (hi, lo)
  return static_cast<long long>(static_cast<unsigned long long>(hi ^ 0x80000000u) << 32 | lo);
}

struct ScanShared {
  Scan warp_total[kWarps];
  Scan warp_base[kWarps];
  int ticket;
};

// The tile this block scans.  Tiles are taken in order from a counter (the
// word after the tiles' words), so a look-back only waits on a tile that is
// running or done.
__device__ int take_ticket(unsigned long long* state, int tiles, ScanShared& sh) {
  if (threadIdx.x == 0) {
    sh.ticket = static_cast<int>(atomicAdd(reinterpret_cast<unsigned*>(state + tiles), 1u));
  }
  __syncthreads();
  return sh.ticket;
}

// Decoupled look-back by one whole warp: publishes the tile's own scan
// `agg`, returns in every lane the scan of the tiles before `tile`, and
// publishes the tile's inclusive scan.  Lane i reads tile first - i, 32
// tiles a step, nearest first, until the nearest inclusive word, and reads
// again while a tile up to it has published nothing.  A tile's value and
// its flags share one word, so a read word is whole or unwritten.
__device__ Scan look_back(int tile, Scan agg, unsigned long long* state) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) store_word(state, word(agg, kInclusive));
    return {0u, 0u};
  }
  if (lane == 0) store_word(state + tile, word(agg, kAggregate));
  Scan base = {0u, 0u};
  for (int first = tile - 1;;) {
    const int t = first - lane;
    const unsigned long long w = t >= 0 ? load_word(state + t) : kInclusive;  // before tile 0: 0
    const unsigned none = __ballot_sync(kFull, (w & (kAggregate | kInclusive)) == 0);
    const unsigned incl = __ballot_sync(kFull, (w & kInclusive) != 0);
    const unsigned upto = incl ? (incl & (0u - incl)) * 2u - 1u : kFull;  // lanes to the nearest
    if (none & upto) continue;
    if ((upto >> lane) & 1u) base = join(base, unword(w));
    if (incl) break;
    first -= 32;
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    base.count += __shfl_xor_sync(kFull, base.count, m);
    base.head = max(base.head, __shfl_xor_sync(kFull, base.head, m));
  }
  if (lane == 0) store_word(state + tile, word(join(base, agg), kInclusive));
  return base;
}

// A warp's running scan over its rows of 32 items (item k of a row in lane
// k): for each item, the flagged items of the warp's part of the tile before
// it, and the largest boundary value at or before it there.
struct WarpScan {
  unsigned count = 0u, head = 0u;

  __device__ __forceinline__ void row(bool flag, bool boundary, unsigned value,
                                      unsigned* count_before, unsigned* head_at) {
    const unsigned lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    const unsigned f = __ballot_sync(kFull, flag);
    const unsigned b = __ballot_sync(kFull, boundary);
    *count_before = count + __popc(f & below);
    count += __popc(f);
    const unsigned upto = b & (below | 1u << lane);
    const unsigned v = __shfl_sync(kFull, value, upto ? 31 - __clz(upto) : 0);
    *head_at = upto ? max(head, v) : head;
    if (b) head = max(head, __shfl_sync(kFull, value, 31 - __clz(b)));
  }
};

// The scan before this warp's part of the tile, over the whole array.
// `mine` is the warp's total (the same in every lane).
__device__ Scan tile_base(int tile, Scan mine, unsigned long long* state, ScanShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh.warp_total[warp] = mine;
  __syncthreads();
  if (warp == 0) {
    Scan total = {0u, 0u}, before = {0u, 0u};
    for (int w = 0; w < kWarps; ++w) {
      if (w == lane) before = total;
      total = join(total, sh.warp_total[w]);
    }
    const Scan base = look_back(tile, total, state);
    if (lane < kWarps) sh.warp_base[lane] = join(base, before);
  }
  __syncthreads();
  return sh.warp_base[warp];
}

struct SeedShared {
  ScanShared scan;
  unsigned zero[kStage / 32];  // bit k of word w: staged code 32w + k is '$'
  unsigned w16[kStage / 16];   // staged codes 16w .. 16w + 15 as 2-bit symbols, big-endian
};

// Seed keys of positions [0, n) of the codes c[0, limit) (codes at or past
// limit read as '$'); with upos, the positions whose sentpos is 64 in text
// order, at most ucap of them.
__global__ void __launch_bounds__(kThreads)
seed_keys_kernel(const unsigned char* __restrict__ c, long long limit, int n,
                 unsigned char* __restrict__ sentpos, long long* __restrict__ key_a,
                 long long* __restrict__ key_b, int* __restrict__ upos, int ucap,
                 unsigned long long* __restrict__ state, int tiles) {
  __shared__ SeedShared sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = upos ? take_ticket(state, tiles, sm.scan) : static_cast<int>(blockIdx.x);
  const long long base = static_cast<long long>(tile) * kTile;
  // a warp stages 32 consecutive codes a step (kStage is whole warps' worth)
  for (int k = threadIdx.x; k < kStage; k += kThreads) {
    const long long at = base + k;
    const unsigned code = at < limit ? c[at] : 0u;
    const unsigned zero = __ballot_sync(kFull, code == 0u);
    unsigned sym = ((code ? code - 1u : 0u) & 3u) << (30 - 2 * (lane & 15));
#pragma unroll
    for (int m = 8; m > 0; m >>= 1) sym |= __shfl_xor_sync(kFull, sym, m);
    if (lane == 0) sm.zero[k >> 5] = zero;
    if ((lane & 15) == 0) sm.w16[k >> 4] = sym;
  }
  __syncthreads();

  const int first = warp * kWarpItems + lane;
  WarpScan ws;
  unsigned before[kItems];
  bool tied[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int o = first + 32 * j;
    const long long i = base + o;
    tied[j] = false;
    if (i < n) {
      // the first '$' at or after i within 64 codes: bits i .. i + 63
      const int wi = o >> 5, sh = o & 31;
      unsigned long long win =
          (static_cast<unsigned long long>(sm.zero[wi + 1]) << 32 | sm.zero[wi]) >> sh;
      if (sh) win |= static_cast<unsigned long long>(sm.zero[wi + 2]) << (64 - sh);
      const int sp = win ? __ffsll(static_cast<long long>(win)) - 1 : kGram;
      const int blk = o >> 4, o2 = 2 * (o & 15);
      unsigned w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned wa = sm.w16[blk + q], wb = sm.w16[blk + q + 1];
        const unsigned x = o2 ? (wa << o2) | (wb >> (32 - o2)) : wa;
        const int valid = min(max(sp - 16 * q, 0), 16);  // symbols before the '$'
        w[q] = valid ? x & (kFull << (32 - 2 * valid)) : 0u;
      }
      sentpos[i] = static_cast<unsigned char>(sp);
      key_a[i] = pack64(w[0], w[1]);
      key_b[i] = pack64(w[2], w[3]);
      tied[j] = sp == kGram;
    }
    if (upos) {
      unsigned head;
      ws.row(tied[j], false, 0u, &before[j], &head);
    }
  }
  if (!upos) return;
  const Scan wb = tile_base(tile, {ws.count, ws.head}, state, sm.scan);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const unsigned at = wb.count + before[j];
    if (tied[j] && at < static_cast<unsigned>(ucap)) upos[at] = static_cast<int>(base + first + 32 * j);
  }
}

// out_order[i] = order[idx[i]] (idx[i] without order; then no out_order),
// out_key[i] = key[out_order[i]].  kGatherItems items a
// thread, a block's kThreads apart, each level of loads issued for all of
// them before the next: the gathers are random reads, so the loads a
// thread has in flight set the rate.
__global__ void __launch_bounds__(kThreads)
gather_kernel(const long long* __restrict__ order, const long long* __restrict__ idx,
              const long long* __restrict__ key, long long n, long long* __restrict__ out_order,
              long long* __restrict__ out_key) {
  const long long first = static_cast<long long>(blockIdx.x) * kThreads * kGatherItems + threadIdx.x;
  long long o[kGatherItems];
#pragma unroll
  for (int j = 0; j < kGatherItems; ++j) {
    const long long i = first + j * kThreads;
    o[j] = i < n ? idx[i] : 0;
  }
  if (order) {
#pragma unroll
    for (int j = 0; j < kGatherItems; ++j) {
      if (first + j * kThreads < n) o[j] = order[o[j]];
    }
  }
#pragma unroll
  for (int j = 0; j < kGatherItems; ++j) {
    const long long i = first + j * kThreads;
    if (i < n) {
      if (out_order) out_order[i] = o[j];
      out_key[i] = key[o[j]];
    }
  }
}

// The seed order (order2 composed with the last pass's idx3), each
// position's group head as its rank, and the slots of the rows whose
// sentpos is 64 (at most ucap).  ka_s is the last pass's sorted key_a.
__global__ void __launch_bounds__(kThreads)
seed_ranks_kernel(const long long* __restrict__ order2, const long long* __restrict__ idx3,
                  const long long* __restrict__ ka_s, const long long* __restrict__ key_b,
                  const unsigned char* __restrict__ sentpos, int n, long long* __restrict__ order,
                  int* __restrict__ rank, int* __restrict__ uslot, int ucap,
                  unsigned long long* __restrict__ state, int tiles) {
  __shared__ ScanShared sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = take_ticket(state, tiles, sm);
  const long long base = static_cast<long long>(tile) * kTile;
  const int first = warp * kWarpItems + lane;
  // the row before this lane's item: lane 31 of the row before, or for the
  // warp's first row the item before the warp's part, read through the order
  long long carry_kb = 0;
  int carry_sp = 0;
  {
    const long long i = base + warp * kWarpItems - 1;
    if (lane == 0 && i >= 0 && i < n) {
      const long long o = order2[idx3[i]];
      carry_kb = key_b[o];
      carry_sp = sentpos[o];
    }
  }
  // the loads first, each level for all the thread's items (random reads)
  long long o[kItems], kbs[kItems];
  int sps[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + first + 32 * j;
    o[j] = i < n ? idx3[i] : 0;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (base + first + 32 * j < n) o[j] = order2[o[j]];
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool real = base + first + 32 * j < n;
    kbs[j] = real ? key_b[o[j]] : 0;
    sps[j] = real ? sentpos[o[j]] : 0;
  }
  WarpScan ws;
  int pos[kItems];
  unsigned before[kItems], head[kItems];
  bool tied[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + first + 32 * j;
    const bool real = i < n;
    const long long kb = kbs[j];
    const int sp = sps[j];
    if (real) order[i] = o[j];
    long long up_kb = __shfl_up_sync(kFull, kb, 1);
    int up_sp = __shfl_up_sync(kFull, sp, 1);
    if (lane == 0) {
      up_kb = carry_kb;
      up_sp = carry_sp;
    }
    carry_kb = __shfl_sync(kFull, kb, 31);
    carry_sp = __shfl_sync(kFull, sp, 31);
    const bool boundary = real && (i == 0 || sp != kGram || sp != up_sp || kb != up_kb ||
                                   ka_s[i] != ka_s[i - 1]);
    tied[j] = real && sp == kGram;
    pos[j] = static_cast<int>(o[j]);
    ws.row(tied[j], boundary, static_cast<unsigned>(i), &before[j], &head[j]);
  }
  const Scan wb = tile_base(tile, {ws.count, ws.head}, state, sm);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + first + 32 * j;
    if (i >= n) continue;
    rank[pos[j]] = static_cast<int>(max(wb.head, head[j]));
    const unsigned at = wb.count + before[j];
    if (tied[j] && at < static_cast<unsigned>(ucap)) uslot[at] = static_cast<int>(i);
  }
}

// (rank[p], rank[p + h] + 1, or 0 past the end) of each upos position p.
__global__ void __launch_bounds__(kThreads)
round_keys_kernel(const int* __restrict__ upos, const int* __restrict__ rank, long long h, int n,
                  int m, long long* __restrict__ key) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= m) return;
  const long long p = upos[j];
  const unsigned lo = p + h < n ? static_cast<unsigned>(rank[p + h]) + 1u : 0u;
  key[j] = pack64(static_cast<unsigned>(rank[p]), lo);
}

// The last round: the k-th sorted position into slot uslot[k].
__global__ void __launch_bounds__(kThreads)
round_place_kernel(const long long* __restrict__ idx, const int* __restrict__ upos,
                   const int* __restrict__ uslot, int m, long long* __restrict__ order) {
  const long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (k < m) order[uslot[k]] = upos[idx[k]];
}

// A round before the last: the k-th sorted position into slot uslot[k], and
// its new group head (the slot of the first of its run of equal sorted
// keys) as its rank.
__global__ void __launch_bounds__(kThreads)
round_scatter_kernel(const long long* __restrict__ idx, const long long* __restrict__ skey,
                     const int* __restrict__ upos, const int* __restrict__ uslot, int m,
                     long long* __restrict__ order, int* __restrict__ rank,
                     unsigned long long* __restrict__ state, int tiles) {
  __shared__ ScanShared sm;
  const int tile = take_ticket(state, tiles, sm);
  const long long base = static_cast<long long>(tile) * kTile;
  const int first = (threadIdx.x >> 5) * kWarpItems + (threadIdx.x & 31);
  // the loads first, each level for all the thread's items (random reads)
  long long at[kItems];
  int pos[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long k = base + first + 32 * j;
    at[j] = k < m ? idx[k] : 0;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    pos[j] = base + first + 32 * j < m ? upos[at[j]] : 0;
  }
  WarpScan ws;
  unsigned head[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long k = base + first + 32 * j;
    unsigned slot = 0u;
    bool boundary = false;
    if (k < m) {
      slot = static_cast<unsigned>(uslot[k]);
      order[slot] = pos[j];
      boundary = k == 0 || skey[k] != skey[k - 1];
    }
    unsigned before;
    ws.row(false, boundary, slot, &before, &head[j]);
  }
  const Scan wb = tile_base(tile, {ws.count, ws.head}, state, sm);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (base + first + 32 * j < m) rank[pos[j]] = static_cast<int>(max(wb.head, head[j]));
  }
}

// The first row of sa[0, r) (ascending) that is not below x.
__device__ __forceinline__ long long lower_bound(const long long* __restrict__ sa, long long r,
                                                 long long x) {
  long long lo = 0;
  while (r > 0) {
    const long long half = r >> 1;
    if (sa[lo + half] < x) {
      lo += half + 1;
      r -= half + 1;
    } else {
      r = half;
    }
  }
  return lo;
}

// The BWT of the suffix array sa of the codes c, and the read ids of its
// '$' rows in SA order (R reads: R sentinels, the first R rows of sa).
__global__ void __launch_bounds__(kThreads)
bwt_perm_kernel(const long long* __restrict__ sa, const unsigned char* __restrict__ c, int n,
                int R, unsigned char* __restrict__ bwt, long long* __restrict__ perm,
                unsigned long long* __restrict__ state, int tiles) {
  __shared__ ScanShared sm;
  const int tile = take_ticket(state, tiles, sm);
  const long long base = static_cast<long long>(tile) * kTile;
  const int first = (threadIdx.x >> 5) * kWarpItems + (threadIdx.x & 31);
  WarpScan ws;
  long long suffix[kItems];
  unsigned before[kItems];
  bool dollar[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + first + 32 * j;
    suffix[j] = i < n ? sa[i] : 0;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + first + 32 * j;
    dollar[j] = false;
    if (i < n) {
      const long long s = suffix[j];
      const unsigned char b = s ? c[s - 1] : 0;
      bwt[i] = b;
      dollar[j] = b == 0;
    }
    unsigned head;
    ws.row(dollar[j], false, 0u, &before[j], &head);
  }
  const Scan wb = tile_base(tile, {ws.count, ws.head}, state, sm);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const unsigned at = wb.count + before[j];
    if (!dollar[j] || at >= static_cast<unsigned>(R)) continue;
    const long long s = suffix[j];
    perm[at] = s ? 1 + lower_bound(sa, R, s - 1) : 0;
  }
}

int tiles_of(long long items) { return static_cast<int>((items + kTile - 1) / kTile); }

int grid_of(long long items) { return static_cast<int>((items + kThreads - 1) / kThreads); }

// Zeroes a scan's look-back words and ticket on the stream.
cudaError_t clear_state(void* scratch, int tiles, cudaStream_t s) {
  return cudaMemsetAsync(scratch, 0, sizeof(unsigned long long) * (tiles + 1), s);
}

bool bad_size(long long n) { return n < 0 || n >= (1ll << 31) - kTile; }

}  // namespace

// 64-bit words of scratch a scan over `items` items needs: one a tile, then
// the ticket.
extern "C" int siga_sa_scan_scratch(long long items) { return tiles_of(items) + 1; }

// sentpos (uint8 [n]), key_a and key_b (int64 [n]) of the positions [0, n)
// of the codes c (uint8, `limit` of them readable, limit <= n + 80); with
// upos (int32 [ucap]) the positions whose sentpos is 64, which needs
// scratch of siga_sa_scan_scratch(n) words (else null).
extern "C" int siga_sa_seed_keys(const void* c, long long limit, int n, void* sentpos, void* key_a,
                                 void* key_b, void* upos, int ucap, void* scratch, void* stream) {
  if (bad_size(n) || limit < 0 || limit > static_cast<long long>(n) + kHalo || ucap < 0 ||
      (upos && !scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_of(n);
  if (upos) {
    const cudaError_t rc = clear_state(scratch, tiles, s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  seed_keys_kernel<<<tiles, kThreads, 0, s>>>(
      static_cast<const unsigned char*>(c), limit, n, static_cast<unsigned char*>(sentpos),
      static_cast<long long*>(key_a), static_cast<long long*>(key_b), static_cast<int*>(upos),
      ucap, static_cast<unsigned long long*>(scratch), tiles);
  return static_cast<int>(cudaGetLastError());
}

// out_order[i] = order[idx[i]] and out_key[i] = key[out_order[i]], i < n,
// all int64; order null: out_order[i] would be idx[i], and is null too.
extern "C" int siga_sa_gather(const void* order, const void* idx, const void* key, long long n,
                              void* out_order, void* out_key, void* stream) {
  if (bad_size(n) || !key || !out_key || !order != !out_order) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  gather_kernel<<<grid_of((n + kGatherItems - 1) / kGatherItems), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(order), static_cast<const long long*>(idx),
      static_cast<const long long*>(key), n, static_cast<long long*>(out_order),
      static_cast<long long*>(out_key));
  return static_cast<int>(cudaGetLastError());
}

// The seed order (int64 [n]), the ranks (int32 [n], by position) and the
// slots of the rows whose sentpos is 64 (int32 [ucap]) from the last seed
// pass; scratch of siga_sa_scan_scratch(n) words.
extern "C" int siga_sa_seed_ranks(const void* order2, const void* idx3, const void* ka_s,
                                  const void* key_b, const void* sentpos, int n, void* order,
                                  void* rank, void* uslot, int ucap, void* scratch, void* stream) {
  if (bad_size(n) || ucap < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_of(n);
  const cudaError_t rc = clear_state(scratch, tiles, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  seed_ranks_kernel<<<tiles, kThreads, 0, s>>>(
      static_cast<const long long*>(order2), static_cast<const long long*>(idx3),
      static_cast<const long long*>(ka_s), static_cast<const long long*>(key_b),
      static_cast<const unsigned char*>(sentpos), n, static_cast<long long*>(order),
      static_cast<int*>(rank), static_cast<int*>(uslot), ucap,
      static_cast<unsigned long long*>(scratch), tiles);
  return static_cast<int>(cudaGetLastError());
}

// A round's keys (int64 [m]) of the positions upos (int32 [m]) from the
// ranks (int32 [n]) at distance h.
extern "C" int siga_sa_round_keys(const void* upos, const void* rank, long long h, int n, int m,
                                  void* key, void* stream) {
  if (bad_size(n) || m < 0 || m > n || h < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaSuccess);
  round_keys_kernel<<<grid_of(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(upos), static_cast<const int*>(rank), h, n, m,
      static_cast<long long*>(key));
  return static_cast<int>(cudaGetLastError());
}

// A round's sorted positions into the order (int64) at the slots uslot
// (int32 [m]); with rank (int32) their new group heads too, from the sorted
// keys skey (int64 [m]), which needs scratch of siga_sa_scan_scratch(m)
// words; rank null: the last round (skey and scratch unused).
extern "C" int siga_sa_round_scatter(const void* idx, const void* skey, const void* upos,
                                     const void* uslot, int m, void* order, void* rank,
                                     void* scratch, void* stream) {
  if (bad_size(m) || (rank && (!skey || !scratch))) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  if (!rank) {
    round_place_kernel<<<grid_of(m), kThreads, 0, s>>>(
        static_cast<const long long*>(idx), static_cast<const int*>(upos),
        static_cast<const int*>(uslot), m, static_cast<long long*>(order));
    return static_cast<int>(cudaGetLastError());
  }
  const int tiles = tiles_of(m);
  const cudaError_t rc = clear_state(scratch, tiles, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  round_scatter_kernel<<<tiles, kThreads, 0, s>>>(
      static_cast<const long long*>(idx), static_cast<const long long*>(skey),
      static_cast<const int*>(upos), static_cast<const int*>(uslot), m,
      static_cast<long long*>(order), static_cast<int*>(rank),
      static_cast<unsigned long long*>(scratch), tiles);
  return static_cast<int>(cudaGetLastError());
}

// The BWT (uint8 [n]) and the .sai permutation (int64 [R]) of the suffix
// array sa (int64 [n]) of the codes c (uint8 [n]) of R reads; scratch of
// siga_sa_scan_scratch(n) words.
extern "C" int siga_sa_bwt_perm(const void* sa, const void* c, int n, int R, void* bwt,
                                void* perm, void* scratch, void* stream) {
  if (bad_size(n) || R < 0 || R > n) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const int tiles = tiles_of(n);
  const cudaError_t rc = clear_state(scratch, tiles, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  bwt_perm_kernel<<<tiles, kThreads, 0, s>>>(
      static_cast<const long long*>(sa), static_cast<const unsigned char*>(c), n, R,
      static_cast<unsigned char*>(bwt), static_cast<long long*>(perm),
      static_cast<unsigned long long*>(scratch), tiles);
  return static_cast<int>(cudaGetLastError());
}
