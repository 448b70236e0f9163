// K2: the pair-plane build of a device FM-index, for sm_90a.
//
// Replaces siga_tpu/ops/fm_device.py::_build_pair_plane_dev (an XLA program
// on the TPU); siga_tpu_torch/ops/fm_device.py::build_pair_plane_plain is
// the same function in plain PyTorch, and native/extractor.cpp's
// siga_pack_pair_plane packs the same bytes on the host.  From the BWT rank
// codes (uint8 [n], '$' = 0 < A < C < G < T) it writes one 57-int32 row per
// 128-row block (csrc/pair_occ.cuh gives the layout): the cur and prev 2-bit
// words, their '$' masks in even-bit form, and 25 exclusive pair
// checkpoints, where prev[r] = codes[LF(r)] and
// LF(r) = C[c] + #{rows before r with symbol c}; and the 5x5 closure
// K[c2][c1] = C[c2] + occ_c2(C[c1] - 1).  Rows n..n_pad-1 read as '$' in
// both masks and are left out of the pair counts.
//
// What bounds it: bytes.  The codes are read once (25.2 MB at the 1 Mb x
// 25x index) and the plane written once (44.8 MB): 0.021 ms at 3.35 TB/s.
// The design reads them twice (the tile, then as runs of other tiles).
//
// The design rests on one fact.  Take the rows [R0, R1) of a tile: those
// that hold symbol c have LF values C[c] + occ_c(R0) ... C[c] + occ_c(R1) - 1
// in row order, so their prevs are one contiguous run of the codes, and the
// runs of all tiles cover [C[1], n) once (LF is a bijection).  A tile's prev
// gathers are four runs, read like the text itself.  One launch, one thread
// block a tile of kTile plane rows; a lane serves 16 rows of a block (one
// word of each bit plane), eight lanes a block, a warp 16 consecutive
// blocks.  The phases (each marked PHASE k in the kernel, where
// probes/plane_phases.py puts its timer marks):
//  1. the block takes a tile ticket from a counter, so tiles start in order
//     and a look-back only ever waits on a tile that is running, and copies
//     the tile's codes to shared memory (16-byte cp.async copies; rows past
//     n read as '$');
//  2. the cur word and '$' mask come from the bytes by a product that packs
//     four 2-bit fields and byte permutes, the lane's symbol counts by
//     popcounts of even-bit match masks, scanned over the warp by shuffles
//     and over the warps in shared memory;
//  3. warp 0 publishes the tile's symbol counts and looks back over the
//     tiles before it for theirs (a decoupled look-back; see look_back),
//     then publishes its inclusive prefix;
//  4. the four runs go to shared memory, each widened to 16-byte edges;
//  5. a row's prev is the byte at its rank within its symbol's run: the
//     lane keeps its next rank of each symbol in a 16-bit field, and a row
//     takes its symbol's field by a byte permute; the 16 pair counts (p, c),
//     p and c in 1-4, of a lane's rows are popcounts of ANDed match masks,
//     summed over the block's eight lanes by a shuffle butterfly, then
//     scanned down the tile's blocks, a warp a column; the other nine pairs
//     follow from them ('$' rows have prev '$', so (p, '$') is 0 for p > 0
//     and ('$', c) is c's count less the rest);
//  6. warps 0-3 look back for the pairs before the tile, one channel of
//     four pairs each, and the checkpoints are put together;
//  7. the tile's rows, built in shared memory over the codes and runs, go
//     out with 16-byte stores, whole rows in one stretch.
// K[c2][c1] is written by warp c1 % kWarps of the tile where C[c1] falls.
// The look-back state and the ticket are zeroed on the stream before the
// launch.  Every count is an integer, so the result does not depend on the
// order in which tiles run.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md) a build takes
// 0.0975-0.1012 ms a direction at the 1 Mb x 25x index, 20.6-21.5% of the
// bound, in the kernel and a memset; the five-launch build it replaced
// (count, scan, rows with 25.2 M scattered byte gathers, scan, add) took
// 0.149-0.151 ms.  What holds it back is measured by
// probes/plane_phases.py: a tile's waits in its two look-backs, and the
// integer work a row.
#include <cstdint>
#include <cuda/atomic>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "pair_occ.cuh"

namespace {

using pair_occ::kCols;
using pair_occ::kSample;

constexpr int kTile = 64;                      // plane rows a tile
constexpr int kTileCodes = kTile * kSample;    // 8,192
constexpr int kThreads = 2 * kTile;            // a thread serves 64 rows
constexpr int kBlocksSm = 1024 / kThreads;     // tiles an SM holds at 64 registers a thread
constexpr int kWarps = kThreads / 32;
constexpr int kRowsLane = 16;                  // one word of each bit plane
constexpr int kLanesBlock = kSample / kRowsLane;
constexpr int kBlocksStep = 32 / kLanesBlock;  // blocks a warp serves at once
constexpr int kBlocksWarp = kTile / kWarps;    // consecutive blocks a warp
constexpr int kSteps = kBlocksWarp / kBlocksStep;
constexpr int kBlocksLane = kTile / 32;        // blocks a lane scans in the pair scan
static_assert(kSteps == 4 && kTile % 32 == 0, "a lane serves 4 x 16 rows");
constexpr int kRunBytes = kTileCodes + 4 * 32;  // four runs, widened to 16-byte edges
constexpr int kPairs = 16;                     // (p, c), p and c in 1-4
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kSet = 1ull << 63;  // a look-back word that has been written

struct Pred {
  int c[5];
};

// The look-back state, in scratch zeroed before a build: five channels of
// four counts a tile (the symbols A, C, G, T; then for each c = 1-4 the
// pairs (p, c), p = 1-4), each as three 64-bit words a tile: the aggregate
// (four 15-bit fields) and the inclusive prefix (two words of two 31-bit
// fields), each word with kSet once it is written.  Then the tile ticket.
constexpr int kChannels = 5;

int tiles(int nblocks) { return (nblocks + kTile - 1) / kTile; }

struct Smem {
  union {
    struct {
      uint4 codes[kTileCodes / 16];
      uint4 runs[kRunBytes / 16];
    } in;
    int rows[kTile * kCols];  // the tile's plane rows, as they go out
  } u;
  unsigned blk_sym[kTile][2];   // symbols before each block in the tile: A | G << 16, C | T << 16
  unsigned blk_pair[kTile][4];  // each block's pair counts: word c - 1, byte p - 1
  unsigned pre_pair[kTile][8];  // pairs before each block in the tile: word 2(c - 1) + h,
                                // p = 2h + 1 in the low half, 2h + 2 in the high
  unsigned warp_sym[kWarps][2];
  unsigned tot_pair[8];
  int sym_base[4];              // symbols before the tile
  int pair_base[kPairs];        // pairs before the tile
  int ticket;
};
static_assert(sizeof(int) * kTile * kCols <= kTileCodes + kRunBytes, "rows fit over codes and runs");

template <typename T>
__device__ __forceinline__ T sel4(const T a[4], int i) {
  T out = a[0];
#pragma unroll
  for (int k = 1; k < 4; ++k) out = i == k ? a[k] : out;
  return out;
}

__device__ __forceinline__ unsigned part(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The 2-bit code word (rank - 1; 0 for '$') and even-bit '$' mask of 16
// codes (rows 0-15, row 0 in the low bits), from their bytes.  Per 4 bytes:
// nz has a one in each byte that is not '$' (w - nz takes one from every
// code but '$', with no borrow between bytes); the low two bits of each
// byte go to bits 24 + 2k by one product (its four terms land on distinct
// bit pairs, so nothing carries), and the four top bytes are gathered by
// byte permutes.  A byte above 4 (what '$' rows read as their prev) gives
// some code; its row is masked by the caller.
__device__ __forceinline__ void code_words(const uint4& cw, unsigned* code, unsigned* dollar) {
  const unsigned w[4] = {cw.x, cw.y, cw.z, cw.w};
  unsigned c[4], d[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned nz = (w[k] | (w[k] >> 1) | (w[k] >> 2)) & 0x01010101u;
    c[k] = ((w[k] - nz) & 0x03030303u) * 0x01041040u;
    d[k] = (nz ^ 0x01010101u) * 0x01041040u;
  }
  *code = __byte_perm(__byte_perm(c[0], c[1], 0x73), __byte_perm(c[2], c[3], 0x73), 0x5410);
  *dollar = __byte_perm(__byte_perm(d[0], d[1], 0x73), __byte_perm(d[2], d[3], 0x73), 0x5410);
}

__device__ __forceinline__ unsigned long long load_word(const unsigned long long* w) {
  return cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(
             *const_cast<unsigned long long*>(w)).load(
      cuda::std::memory_order_relaxed);
}

__device__ __forceinline__ void store_word(unsigned long long* w, unsigned long long v) {
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(*w).store(
      v, cuda::std::memory_order_relaxed);
}

__device__ __forceinline__ unsigned long long inc_word(unsigned a, unsigned b) {
  return kSet | a | static_cast<unsigned long long>(b) << 31;
}

// Publishes `agg`, the tile's four counts of one channel (`ch`: three words
// a tile): the first tile's are its inclusive prefix.
__device__ __forceinline__ void publish_aggregate(int tile, const uint4& agg, unsigned long long* ch) {
  unsigned long long* mine = ch + 3 * static_cast<size_t>(tile);
  if (tile == 0) {
    store_word(mine + 1, inc_word(agg.x, agg.y));
    store_word(mine + 2, inc_word(agg.z, agg.w));
  } else {
    store_word(mine, kSet | agg.x | static_cast<unsigned long long>(agg.y) << 15 |
                         static_cast<unsigned long long>(agg.z) << 30 |
                         static_cast<unsigned long long>(agg.w) << 45);
  }
}

// Decoupled look-back over one channel, by one whole warp, after the
// tile's aggregate `agg` is published: returns in every lane the sums of the
// tiles before `tile`, and publishes the tile's inclusive prefix.  Lane i
// reads tile first - i, 32 tiles a step, nearest first, until the nearest
// inclusive prefix, and reads again while a tile up to it has published
// nothing.  A tile's counts and their flag share a word, so a word read is
// whole or not written yet, and one read a step serves: no ordering between
// words is needed.
__device__ uint4 look_back(int tile, int lane, const uint4& agg, unsigned long long* ch) {
  uint4 base = make_uint4(0, 0, 0, 0);
  if (tile == 0) return base;
  for (int first = tile - 1;;) {
    const int t = first - lane;
    const bool real = t >= 0;  // before tile 0: an inclusive 0
    const unsigned long long* w = ch + 3 * static_cast<size_t>(real ? t : 0);
    const unsigned long long a = real ? load_word(w) : 0ull;
    const unsigned long long b = real ? load_word(w + 1) : kSet;
    const unsigned long long c = real ? load_word(w + 2) : kSet;
    const bool inc = (b & c & kSet) != 0;
    const unsigned none = __ballot_sync(kFull, !inc && !(a & kSet));
    const unsigned incl = __ballot_sync(kFull, inc);
    const unsigned upto = incl ? (incl & (0u - incl)) * 2u - 1u : kFull;  // lanes to the nearest
    if (none & upto) continue;
    if ((upto >> lane) & 1u) {
      if (inc) {
        base.x += static_cast<unsigned>(b) & 0x7fffffffu;
        base.y += static_cast<unsigned>(b >> 31) & 0x7fffffffu;
        base.z += static_cast<unsigned>(c) & 0x7fffffffu;
        base.w += static_cast<unsigned>(c >> 31) & 0x7fffffffu;
      } else {
        base.x += static_cast<unsigned>(a) & 0x7fffu;
        base.y += static_cast<unsigned>(a >> 15) & 0x7fffu;
        base.z += static_cast<unsigned>(a >> 30) & 0x7fffu;
        base.w += static_cast<unsigned>(a >> 45) & 0x7fffu;
      }
    }
    if (incl) break;
    first -= 32;
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    base.x += __shfl_xor_sync(kFull, base.x, m);
    base.y += __shfl_xor_sync(kFull, base.y, m);
    base.z += __shfl_xor_sync(kFull, base.z, m);
    base.w += __shfl_xor_sync(kFull, base.w, m);
  }
  if (lane == 0) {
    unsigned long long* mine = ch + 3 * static_cast<size_t>(tile);
    store_word(mine + 1, inc_word(base.x + agg.x, base.y + agg.y));
    store_word(mine + 2, inc_word(base.z + agg.z, base.w + agg.w));
  }
  return base;
}

__global__ void __launch_bounds__(kThreads, kBlocksSm)
pair_plane(const unsigned char* __restrict__ codes, int n, int nblocks, Pred pred,
           unsigned long long* __restrict__ state, int* __restrict__ plane, int* __restrict__ K) {
  __shared__ Smem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % kLanesBlock;  // the lane's word of its block
  if (threadIdx.x == 0) {
    auto* ticket = reinterpret_cast<unsigned*>(state + kChannels * 3 * static_cast<size_t>(gridDim.x));
    sm.ticket = static_cast<int>(atomicAdd(ticket, 1u));
  }
  __syncthreads();
  const int tile = sm.ticket;
  const int b0 = tile * kTile;
  const int nb = min(kTile, nblocks - b0);
  const int r0 = b0 * kSample;

  // PHASE 1: the tile's codes; rows past n read as '$' (the pair counts never
  // count '$' rows: the '$' checkpoints follow from the row counts)
  for (int i = threadIdx.x; i < kTileCodes / 16; i += kThreads) {
    const int g = r0 + 16 * i;
    if (n - g >= 16) {
      __pipeline_memcpy_async(&sm.u.in.codes[i], codes + g, 16);
    } else {
      unsigned v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = 0;
        for (int j = 0; j < 4; ++j) {
          const int r = g + 4 * k + j;
          v[k] |= (r < n ? static_cast<unsigned>(codes[r]) : 0u) << (8 * j);
        }
      }
      sm.u.in.codes[i] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // PHASE 2: code words and symbol counts; rank_*: the symbols before the lane's
  // rows in the tile, A | G << 16 and C | T << 16
  const int bw = warp * kBlocksWarp;
  unsigned cur[kSteps], curd[kSteps], rank_lo[kSteps], rank_hi[kSteps];
  unsigned carry_lo = 0, carry_hi = 0;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int b = bw + kBlocksStep * s + lane / kLanesBlock;
    code_words(sm.u.in.codes[b * (kSample / 16) + sub], &cur[s], &curd[s]);
    unsigned m[5];
    pair_occ::sym_masks(cur[s], curd[s], m);
    const unsigned lo = __popc(m[1]) | __popc(m[3]) << 16;
    const unsigned hi = __popc(m[2]) | __popc(m[4]) << 16;
    unsigned ilo = lo, ihi = hi;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned ulo = __shfl_up_sync(kFull, ilo, d), uhi = __shfl_up_sync(kFull, ihi, d);
      if (lane >= d) {
        ilo += ulo;
        ihi += uhi;
      }
    }
    rank_lo[s] = carry_lo + ilo - lo;
    rank_hi[s] = carry_hi + ihi - hi;
    carry_lo += __shfl_sync(kFull, ilo, 31);
    carry_hi += __shfl_sync(kFull, ihi, 31);
  }
  if (lane == 0) {
    sm.warp_sym[warp][0] = carry_lo;
    sm.warp_sym[warp][1] = carry_hi;
  }
  __syncthreads();
  unsigned wlo = 0, whi = 0, tlo = 0, thi = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned a = sm.warp_sym[w][0], c = sm.warp_sym[w][1];
    wlo += w < warp ? a : 0u;
    whi += w < warp ? c : 0u;
    tlo += a;
    thi += c;
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    rank_lo[s] += wlo;
    rank_hi[s] += whi;
    if (sub == 0) {
      const int b = bw + kBlocksStep * s + lane / kLanesBlock;
      sm.blk_sym[b][0] = rank_lo[s];
      sm.blk_sym[b][1] = rank_hi[s];
    }
  }
  const int tot[4] = {static_cast<int>(tlo & 0xffffu), static_cast<int>(thi & 0xffffu),
                      static_cast<int>(tlo >> 16), static_cast<int>(thi >> 16)};

  // PHASE 3: the symbols before the tile
  if (warp == 0) {
    const uint4 agg = make_uint4(tot[0], tot[1], tot[2], tot[3]);
    if (lane == 0) publish_aggregate(tile, agg, state);
    const uint4 base = look_back(tile, lane, agg, state);
    if (lane < 4) sm.sym_base[lane] = static_cast<int>(part(base, lane));
  }
  __syncthreads();

  // PHASE 4: the four runs: run c - 1 is codes[C[c] + occ_c(R0), + tot[c - 1]),
  // its first code at byte run_at[c - 1] of sm.u.in.runs
  int run_at[4];
  {
    int lo16[4], first[4], chunks = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int start = pred.c[c + 1] + sm.sym_base[c];
      const int a = start & ~15;
      const int e = tot[c] > 0 ? (start + tot[c] + 15) & ~15 : a;
      lo16[c] = a;
      first[c] = chunks;
      run_at[c] = 16 * chunks + (start - a);
      chunks += (e - a) / 16;
    }
    for (int j = threadIdx.x; j < chunks; j += kThreads) {
      int c = 0;
#pragma unroll
      for (int q = 1; q < 4; ++q) c += j >= first[q];
      const int g = sel4(lo16, c) + 16 * (j - sel4(first, c));
      if (n - g >= 16) {
        __pipeline_memcpy_async(&sm.u.in.runs[j], codes + g, 16);
      } else {
        unsigned v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[k] = 0;
          for (int i = 0; i < 4; ++i) {
            const int r = g + 4 * k + i;
            v[k] |= (r < n ? static_cast<unsigned>(codes[r]) : 0u) << (8 * i);
          }
        }
        sm.u.in.runs[j] = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  __syncthreads();

  // K[c2][c1] = C[c2] + occ_c2(C[c1]), by warp c1 % kWarps of the tile
  // where C[c1] falls; the rows before C[c1] are all below n
  for (int c1 = warp; c1 < 5; c1 += kWarps) {
    const int kb = pred.c[c1] / kSample - b0, off = pred.c[c1] % kSample;
    if (kb < 0 || kb >= nb) continue;
    const unsigned w = reinterpret_cast<const unsigned*>(sm.u.in.codes)[kb * 32 + lane];
    unsigned f = 0;  // symbols 1-4 among the block's rows before off, a byte each
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned c = (w >> (8 * j)) & 0xffu;
      if (4 * lane + j < off && c - 1 < 4u) f += 1u << (8 * (c - 1));
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) f += __shfl_xor_sync(kFull, f, m);
    if (lane < 5) {
      int before[5];  // each symbol before the block
      before[0] = (b0 + kb) * kSample;
#pragma unroll
      for (int c = 1; c < 5; ++c) {
        const unsigned x = sm.blk_sym[kb][(c - 1) & 1] >> (16 * ((c - 1) >> 1));
        before[c] = sm.sym_base[c - 1] + static_cast<int>(x & 0xffffu);
        before[0] -= before[c];
      }
      const int in_block = (f * 0x01010101u) >> 24;
      const int occ = lane == 0 ? before[0] + off - in_block
                                : pair_occ::sel5(before, lane) +
                                      static_cast<int>((f >> (8 * (lane - 1))) & 0xffu);
      K[lane * 5 + c1] = pred.c[lane] + occ;
    }
  }

  // PHASE 5: prev words from the runs, and the pair counts of each block
  unsigned prev[kSteps], prevd[kSteps];
  const auto* runs = reinterpret_cast<const unsigned char*>(sm.u.in.runs);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int b = bw + kBlocksStep * s + lane / kLanesBlock;
    const uint4 cw = sm.u.in.codes[b * (kSample / 16) + sub];
    const unsigned w[4] = {cw.x, cw.y, cw.z, cw.w};
    // at: the byte of runs that holds the prev of this lane's next row of
    // each symbol, 16 bits each (A, C, G, T from the low end); a row takes
    // its symbol's field by a byte permute and moves it on by one.  '$' rows
    // and the padding read T's field and move nothing; they are masked below
    const unsigned ac = (run_at[0] + (rank_lo[s] & 0xffffu)) | (run_at[1] + (rank_hi[s] & 0xffffu)) << 16;
    const unsigned gt = (run_at[2] + (rank_lo[s] >> 16)) | (run_at[3] + (rank_hi[s] >> 16)) << 16;
    unsigned long long at = ac | static_cast<unsigned long long>(gt) << 32;
    unsigned pw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unsigned x = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned c = (w[k] >> (8 * j)) & 0xffu;
        const unsigned q = (c + 3u) & 3u;  // symbol c's field
        const unsigned i = __byte_perm(static_cast<unsigned>(at), static_cast<unsigned>(at >> 32),
                                       q * 0x22u + 0x10u) & 0xffffu;
        at += static_cast<unsigned long long>(min(c, 1u)) << (16 * q);
        x |= static_cast<unsigned>(runs[i]) << (8 * j);
      }
      pw[k] = x;
    }
    unsigned pc, pd;
    code_words(make_uint4(pw[0], pw[1], pw[2], pw[3]), &pc, &pd);
    prev[s] = pc & ~(curd[s] * 3u);  // '$' rows and the padding: prev '$'
    prevd[s] = pd | curd[s];
    unsigned mc[5], mp[5];
    pair_occ::sym_masks(cur[s], curd[s], mc);
    pair_occ::sym_masks(prev[s], prevd[s], mp);
    unsigned cnt[4];  // word c - 1: pair (p, c) in byte p - 1
#pragma unroll
    for (int c = 1; c < 5; ++c) {
      cnt[c - 1] = __popc(mp[1] & mc[c]) | __popc(mp[2] & mc[c]) << 8 |
                   __popc(mp[3] & mc[c]) << 16 | __popc(mp[4] & mc[c]) << 24;
    }
#pragma unroll
    for (int m = 1; m < kLanesBlock; m <<= 1) {
#pragma unroll
      for (int q = 0; q < 4; ++q) cnt[q] += __shfl_xor_sync(kFull, cnt[q], m);
    }
    if (sub < 4) sm.blk_pair[b][sub] = sel4(cnt, sub);
  }
  __syncthreads();  // codes and runs are read: the rows take their place

#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    int* row = sm.u.rows + (bw + kBlocksStep * s + lane / kLanesBlock) * kCols;
    row[sub] = static_cast<int>(cur[s]);
    row[8 + sub] = static_cast<int>(prev[s]);
    row[16 + sub] = static_cast<int>(curd[s]);
    row[24 + sub] = static_cast<int>(prevd[s]);
  }
  // the pairs before each block in the tile: a warp scans word col of
  // pre_pair, lane L blocks kBlocksLane * L ..
  for (int col = warp; col < 8; col += kWarps) {
    const int q = col >> 1, h = col & 1;
    unsigned v[kBlocksLane], sum = 0;
#pragma unroll
    for (int j = 0; j < kBlocksLane; ++j) {
      const unsigned x = (sm.blk_pair[kBlocksLane * lane + j][q] >> (16 * h)) & 0xffffu;
      v[j] = (x & 0xffu) | (x >> 8) << 16;
      sum += v[j];
    }
    unsigned incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    unsigned run = incl - sum;
#pragma unroll
    for (int j = 0; j < kBlocksLane; ++j) {
      sm.pre_pair[kBlocksLane * lane + j][col] = run;
      run += v[j];
    }
    if (lane == 31) sm.tot_pair[col] = incl;
  }
  __syncthreads();

  // PHASE 6: the pairs before the tile: channel c looks back for (p, c + 1), p = 1-4
  for (int c = warp; c < 4; c += kWarps) {
    const unsigned a = sm.tot_pair[2 * c], z = sm.tot_pair[2 * c + 1];
    const uint4 agg = make_uint4(a & 0xffffu, a >> 16, z & 0xffffu, z >> 16);
    unsigned long long* ch = state + 3 * static_cast<size_t>(gridDim.x) * (1 + c);
    if (lane == 0) publish_aggregate(tile, agg, ch);
    const uint4 base = look_back(tile, lane, agg, ch);
    if (lane < 4) sm.pair_base[c * 4 + lane] = static_cast<int>(part(base, lane));
  }
  __syncthreads();

  // the checkpoints, ckpt[p * 5 + c], thread i: block i / 5, symbol c = i % 5
  for (int i = threadIdx.x; i < nb * 5; i += kThreads) {
    const int b = i / 5, c = i - 5 * (i / 5);
    int* ck = sm.u.rows + b * kCols + 32;
    if (c == 0) {
      int dollar = (b0 + b) * kSample;
#pragma unroll
      for (int q = 1; q < 5; ++q) {
        const unsigned x = sm.blk_sym[b][(q - 1) & 1] >> (16 * ((q - 1) >> 1));
        dollar -= sm.sym_base[q - 1] + static_cast<int>(x & 0xffffu);
      }
      ck[0] = dollar;
#pragma unroll
      for (int p = 1; p < 5; ++p) ck[p * 5] = 0;  // a '$' row's prev is '$'
    } else {
      const unsigned x = sm.blk_sym[b][(c - 1) & 1] >> (16 * ((c - 1) >> 1));
      int rest = sm.sym_base[c - 1] + static_cast<int>(x & 0xffffu);
#pragma unroll
      for (int p = 1; p < 5; ++p) {
        const unsigned y = sm.pre_pair[b][2 * (c - 1) + ((p - 1) >> 1)] >> (16 * ((p - 1) & 1));
        const int v = sm.pair_base[(c - 1) * 4 + p - 1] + static_cast<int>(y & 0xffffu);
        ck[p * 5 + c] = v;
        rest -= v;
      }
      ck[c] = rest;
    }
  }
  __syncthreads();

  // PHASE 7: out: the tile's rows are one stretch of the plane, 16-byte aligned
  const int ints = nb * kCols;
  auto* out = reinterpret_cast<uint4*>(plane + static_cast<size_t>(b0) * kCols);
  const auto* rows = reinterpret_cast<const uint4*>(sm.u.rows);
  for (int i = threadIdx.x; i < ints / 4; i += kThreads) out[i] = rows[i];
  for (int i = ints / 4 * 4 + static_cast<int>(threadIdx.x); i < ints; i += kThreads) {
    plane[static_cast<size_t>(b0) * kCols + i] = sm.u.rows[i];
  }
}

}  // namespace

// Ints of scratch siga_pair_plane needs for nblocks plane rows: three
// 64-bit words a channel a tile (the flag kSet in bit 63 of each), five
// channels, then the ticket.
extern "C" int siga_pair_plane_scratch(int nblocks) {
  return 2 * 3 * kChannels * tiles(nblocks) + 1;
}

// The pair plane (int32 [nblocks, 57], 16-byte aligned) and K (int32 [5, 5])
// of the BWT codes (uint8 [n], 16-byte aligned), with pred the C array and
// nblocks = n / 128 + 1; scratch (16-byte aligned) holds
// siga_pair_plane_scratch(nblocks) ints.  A memset of the scratch, then
// one launch.
extern "C" int siga_pair_plane(const void* codes, int n, int nblocks, int p0, int p1, int p2,
                               int p3, int p4, void* plane, void* K, void* scratch,
                               void* stream) {
  if (n < 0 || n > INT32_MAX - kSample || nblocks != n / kSample + 1 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(plane) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Pred pred = {{p0, p1, p2, p3, p4}};
  const int nt = tiles(nblocks);
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t bytes = sizeof(int) * static_cast<size_t>(siga_pair_plane_scratch(nblocks));
  const cudaError_t rc = cudaMemsetAsync(scratch, 0, bytes, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  pair_plane<<<nt, kThreads, 0, s>>>(static_cast<const unsigned char*>(codes), n,
                                                 nblocks, pred,
                                                 static_cast<unsigned long long*>(scratch),
                                                 static_cast<int*>(plane), static_cast<int*>(K));
  return static_cast<int>(cudaGetLastError());
}
