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
// The torch-ops version takes 86-88 ms a direction in 143 device
// operations, 74 ms of them one int64 cumsum of the blocks' pair counts
// along the blocks.  LF needs
// each symbol's global ordinal, a scan over the whole text, so the build is
// a reduce-then-scan in five launches over tiles of kTile blocks:
//  1. count_tiles: each tile's symbol counts (16-byte loads, all in flight);
//  2. scan_tiles: their exclusive scan, one block;
//  3. plane_rows: a tile's codes into shared memory; a lane serves 16 rows
//     of a block (one word of each bit plane), eight lanes a block: each
//     block's symbol counts, scanned within the tile from the tile's base
//     plus C; a row's LF is that base plus its rank, an exclusive prefix of
//     8-bit counters over the block's lanes and a running count within the
//     lane; prev is a byte gather (LF rises within each symbol, so a block's
//     gathers fall in about four short runs), 16 a lane in flight; the
//     lane's four words are put together from the bytes by bit tricks and
//     stored; the pair counts go to a shared histogram, scanned within the
//     tile into columns 32-56, and the tile's totals out; warp c1 writes
//     column c1 of K where C[c1] falls in its tile;
//  4. scan_tiles again, over the tiles' pair totals;
//  5. add_pair_base: each tile's base added to its columns 32-56.
// The first design (a warp a block, 4 rows a lane, its words put together
// by shuffles) spent many integer instructions on every row; trials on the
// card led to this one, which serves 16 rows a lane so that a row costs a
// few operations and the words come from the bytes whole.  On an NVIDIA
// H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md) a build takes
// 0.149-0.151 ms a direction at the 1 Mb x 25x index, 0.082 ms of it in
// plane_rows; what splits plane_rows' time (its gathers, whose 32 lanes read
// rows 16 apart, its shared atomics, its integer work) is not measured.
// Every count is an integer, so the result does not depend on the order in
// which blocks run.
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

#include "pair_occ.cuh"

namespace {

using pair_occ::kCols;
using pair_occ::kSample;
using pair_occ::sel5;

constexpr int kTile = 128;  // plane rows a block of plane_rows serves
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kPairs = 25;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kPad = 0xffu;  // a row past n, in a tile's shared codes
constexpr int kVecs = kTile * kSample / 16 / kThreads;  // 16-byte loads of a tile a thread
constexpr int kRowsLane = 16;  // rows a lane serves in plane_rows: one word of a bit plane
constexpr int kLanesBlock = kSample / kRowsLane;
constexpr int kBlocksWarp = 32 / kLanesBlock;
constexpr int kSteps = kTile / (kBlocksWarp * kWarps);  // a warp's steps over its tile
// count_tiles keeps one thread's counts in 8-bit fields
static_assert(kTile * kSample / kThreads <= 255, "count_tiles' byte counters overflow");

struct Pred {
  int c[5];
};

__device__ __forceinline__ int field(unsigned f, int c) {
  return static_cast<int>((f >> (8 * c)) & 0xffu);
}

// The sum of the four 8-bit fields (each field at most 128 here).
__device__ __forceinline__ int field_sum(unsigned f) {
  return static_cast<int>((f * 0x01010101u) >> 24);
}

// One in the 8-bit field of symbol c - 1 for a code c of 1-4; nothing for
// '$' (0) and the padding.
__device__ __forceinline__ unsigned sym_field(unsigned c) {
  return c - 1 < 4u ? 1u << (8 * (c - 1)) : 0u;
}

// The 16 codes (rows 16 sub .. 16 sub + 15) of block b of a tile's words.
__device__ __forceinline__ uint4 lane_codes(const unsigned* words, int b, int sub) {
  return reinterpret_cast<const uint4*>(words)[b * (kSample / 16) + sub];
}

// The counts of symbols 1-4 in 16 codes, 8-bit fields; `valid` gets the
// codes that are not padding.
__device__ __forceinline__ unsigned sym_fields(uint4 cw, int* valid) {
  const unsigned w[4] = {cw.x, cw.y, cw.z, cw.w};
  unsigned f = 0;
  int v = 0;
#pragma unroll
  for (int j = 0; j < kRowsLane; ++j) {
    const unsigned c = (w[j / 4] >> (8 * (j % 4))) & 0xffu;
    f += sym_field(c);
    v += c != kPad;
  }
  *valid = v;
  return f;
}

// 2-bit fields from the low two bits of each byte of x: byte k to bits 2k.
__device__ __forceinline__ unsigned pack2(unsigned x) {
  return (x & 0x3u) | ((x >> 6) & 0xcu) | ((x >> 12) & 0x30u) | ((x >> 18) & 0xc0u);
}

// Bytes of w that hold the padding as 0xff, the others (codes 0-4) as 0.
__device__ __forceinline__ unsigned pad_bytes(unsigned w) {
  return ((w >> 7) & 0x01010101u) * 0xffu;
}

// 8 bits of a bit-plane word from 4 codes: rank - 1 for ranks 1-4, 0 for
// '$' and the padding, 2 bits a code.
__device__ __forceinline__ unsigned code_bits(unsigned w) {
  // a one in each byte that is not 0 (codes are at most 4, or 0xff), so
  // w - nz takes one from every code but '$', with no borrow between bytes
  const unsigned nz = (w | (w >> 1) | (w >> 2)) & 0x01010101u;
  return pack2((w - nz) & ~pad_bytes(w));
}

// 8 bits of a '$'-mask word from 4 codes: bit 2k where code k is '$' or the
// padding.
__device__ __forceinline__ unsigned dollar_bits(unsigned w) {
  const unsigned nz = (w | (w >> 1) | (w >> 2)) & 0x01010101u;
  return pack2((nz ^ 0x01010101u) | (pad_bytes(w) & 0x01010101u));
}

// Codes of rows 4w .. 4w+3, row 4w in the low byte; rows past n read kPad.
__device__ __forceinline__ unsigned load_word(const unsigned char* codes, int n, int w) {
  const int r = 4 * w;
  if (r + 4 <= n) return __ldg(reinterpret_cast<const unsigned*>(codes) + w);
  unsigned v = 0;
  for (int j = 0; j < 4; ++j) v |= (r + j < n ? static_cast<unsigned>(codes[r + j]) : kPad) << (8 * j);
  return v;
}

// Exclusive scan down each column of the row-major int array a[rows, cols]
// (global or shared), in place, by the whole block: every thread calls it,
// and cols <= blockDim.x.  `base` (or null) is added to each column and
// `total` (or null) receives each column's sum, base included.  `part` is
// shared scratch of blockDim.x ints.  The rows are cut into segments, one a
// thread, summed with eight loads in flight, the segment sums scanned by one
// thread a column, then each segment written.
__device__ void scan_columns(int* a, int rows, int cols, const int* base, int* total, int* part) {
  const int t = threadIdx.x;
  const int segs = max(1, min(static_cast<int>(blockDim.x) / cols, rows / 16));
  const int k = t % cols, s = t / cols;
  const int len = (rows + segs - 1) / segs;
  const int r0 = min(s * len, rows), r1 = min(r0 + len, rows);
  const bool mine = s < segs;
  if (mine) {
    int sum = 0;
    for (int r = r0; r < r1; r += 8) {
      int v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = r + u < r1 ? a[(r + u) * cols + k] : 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) sum += v[u];
    }
    part[t] = sum;
  }
  __syncthreads();
  if (t < cols) {
    int run = base != nullptr ? base[t] : 0;
    for (int q = 0; q < segs; ++q) {
      const int v = part[q * cols + t];
      part[q * cols + t] = run;
      run += v;
    }
    if (total != nullptr) total[t] = run;
  }
  __syncthreads();
  if (mine) {
    int run = part[t];
    for (int r = r0; r < r1; r += 8) {
      int v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = r + u < r1 ? a[(r + u) * cols + k] : 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (r + u < r1) {
          a[(r + u) * cols + k] = run;
          run += v[u];
        }
      }
    }
  }
  __syncthreads();
}

// 1. Each tile's count of each symbol over its rows below n: kVecs 16-byte
// loads a thread, all in flight.
__global__ void __launch_bounds__(kThreads)
count_tiles(const unsigned char* codes, int n, int* tile_counts) {
  __shared__ int part[kWarps][5];
  const int r0 = blockIdx.x * kTile * kSample;
  const int r1 = min(r0 + kTile * kSample, n);
  unsigned f = 0;  // symbols 1-4, 8 bits each
  int valid = 0;
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int r = r0 + 16 * (u * kThreads + static_cast<int>(threadIdx.x));
    if (r + 16 <= r1) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(codes + r));
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned c = (w[q] >> (8 * j)) & 0xffu;
          assert(c <= 4);
          f += sym_field(c);
        }
      }
      valid += 16;
    } else {
      for (int j = r; j < r1; ++j) {
        const unsigned c = codes[j];
        assert(c <= 4);
        f += sym_field(c);
        ++valid;
      }
    }
  }
  int cnt[5];
  cnt[0] = valid - field_sum(f);
#pragma unroll
  for (int c = 1; c < 5; ++c) cnt[c] = field(f, c - 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const int s = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(cnt[c])));
    if (lane == 0) part[warp][c] = s;
  }
  __syncthreads();
  if (threadIdx.x < 5) {
    int s = 0;
    for (int q = 0; q < kWarps; ++q) s += part[q][threadIdx.x];
    tile_counts[blockIdx.x * 5 + threadIdx.x] = s;
  }
}

// 2 and 4. Exclusive scan down the columns of a[rows, cols], in one block.
__global__ void __launch_bounds__(kScanThreads) scan_tiles(int* a, int rows, int cols) {
  __shared__ int part[kScanThreads];
  scan_columns(a, rows, cols, nullptr, nullptr, part);
}

// 3. A tile of kTile blocks: columns 0-31 and K, the tile-local exclusive
// pair checkpoints into columns 32-56, the tile's pair totals out.  A lane
// serves 16 rows of a block, which make one word of each of the four bit
// planes, so eight lanes serve a block and a warp four.
__global__ void __launch_bounds__(kThreads)
plane_rows(const unsigned char* codes, int n, int nblocks, Pred pred, const int* tile_base,
           int* plane, int* tile_pairs, int* K) {
  __shared__ __align__(16) unsigned words[kTile * 32];
  __shared__ int base[kTile * 5];  // C[c] + the rows of symbol c before each block
  __shared__ int pairs[kTile * kPairs];
  __shared__ int part[kThreads];
  __shared__ int start[5];
  const int b0 = blockIdx.x * kTile;
  const int nb = min(kTile, nblocks - b0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % kLanesBlock;  // the lane's word of its block
  // the tile's codes, kVecs 16-byte loads a thread in flight (the tile
  // starts on a multiple of 16 KB of codes)
  uint4 v[kVecs];
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int i = 4 * (u * kThreads + static_cast<int>(threadIdx.x));  // a word of the tile
    const int gw = b0 * 32 + i;
    if (i >= nb * 32) continue;
    if (4 * gw + 16 <= n) {
      v[u] = __ldg(reinterpret_cast<const uint4*>(codes) + gw / 4);
    } else {
      v[u] = make_uint4(load_word(codes, n, gw), load_word(codes, n, gw + 1),
                        load_word(codes, n, gw + 2), load_word(codes, n, gw + 3));
    }
  }
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int i = 4 * (u * kThreads + static_cast<int>(threadIdx.x));
    if (i < nb * 32) reinterpret_cast<uint4*>(words)[i / 4] = v[u];
  }
  for (int i = threadIdx.x; i < nb * kPairs; i += kThreads) pairs[i] = 0;
  if (threadIdx.x < 5) start[threadIdx.x] = pred.c[threadIdx.x] + tile_base[blockIdx.x * 5 + threadIdx.x];
  __syncthreads();
  // each block's symbol counts, scanned into LF bases from the tile's start;
  // `own` keeps each lane's counts of symbols 1-4 for the ranks below
  unsigned own[kSteps];
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    const int b = (warp + kWarps * step) * kBlocksWarp + lane / kLanesBlock;
    int valid = 0;
    own[step] = b < nb ? sym_fields(lane_codes(words, b, sub), &valid) : 0u;
    unsigned tot = own[step];
#pragma unroll
    for (int m = 1; m < kLanesBlock; m <<= 1) {
      tot += __shfl_xor_sync(kFull, tot, m);
      valid += __shfl_xor_sync(kFull, valid, m);
    }
    if (b < nb && sub < 5) base[b * 5 + sub] = sub == 0 ? valid - field_sum(tot) : field(tot, sub - 1);
  }
  __syncthreads();
  scan_columns(base, nb, 5, start, nullptr, part);
  // K[c2][c1] = C[c2] + occ_c2(C[c1] - 1), by warp c1 where C[c1] falls in
  // this tile; the rows before C[c1] are all below n
  if (warp < 5 && pred.c[warp] / kSample - b0 >= 0 && pred.c[warp] / kSample - b0 < nb) {
    const int kb = pred.c[warp] / kSample - b0, off = pred.c[warp] % kSample;
    const unsigned w = words[kb * 32 + lane];
    unsigned f = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (4 * lane + j < off) f += sym_field((w >> (8 * j)) & 0xffu);
    }
    f = __reduce_add_sync(kFull, f);
    if (lane < 5) {
      K[lane * 5 + warp] = base[kb * 5 + lane] + (lane == 0 ? off - field_sum(f) : field(f, lane - 1));
    }
  }
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    const int b = (warp + kWarps * step) * kBlocksWarp + lane / kLanesBlock;
    // the lane's rank among its block's rows of each symbol 1-4: an
    // exclusive prefix of `own` over the block's lanes
    unsigned incl = own[step];
#pragma unroll
    for (int d = 1; d < kLanesBlock; d <<= 1) {
      const unsigned up = __shfl_up_sync(kFull, incl, d, kLanesBlock);
      if (sub >= d) incl += up;
    }
    if (b >= nb) continue;
    const unsigned excl = incl - own[step];
    // next[t]: the LF of this lane's next row of symbol t + 1
    int next[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) next[t] = base[b * 5 + t + 1] + field(excl, t);
    const uint4 cw = lane_codes(words, b, sub);
    const unsigned w[4] = {cw.x, cw.y, cw.z, cw.w};
    int lf[kRowsLane];
#pragma unroll
    for (int j = 0; j < kRowsLane; ++j) {
      const unsigned c = (w[j / 4] >> (8 * (j % 4))) & 0xffu;
      lf[j] = -1;  // no gather: '$' and the padding have prev 0
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (c == static_cast<unsigned>(t + 1)) lf[j] = next[t]++;
      }
    }
    unsigned p[kRowsLane];
#pragma unroll
    for (int j = 0; j < kRowsLane; ++j) p[j] = lf[j] >= 0 && lf[j] < n ? __ldg(codes + lf[j]) : 0u;
    unsigned cur = 0, curd = 0, prev = 0, prevd = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned pw = p[4 * k] | p[4 * k + 1] << 8 | p[4 * k + 2] << 16 | p[4 * k + 3] << 24;
      cur |= code_bits(w[k]) << (8 * k);
      curd |= dollar_bits(w[k]) << (8 * k);
      prev |= code_bits(pw) << (8 * k);
      prevd |= dollar_bits(pw) << (8 * k);
    }
    int* row = plane + static_cast<size_t>(b0 + b) * kCols;
    row[sub] = static_cast<int>(cur);
    row[8 + sub] = static_cast<int>(prev);
    row[16 + sub] = static_cast<int>(curd);
    row[24 + sub] = static_cast<int>(prevd);
#pragma unroll
    for (int j = 0; j < kRowsLane; ++j) {
      const unsigned c = (w[j / 4] >> (8 * (j % 4))) & 0xffu;
      if (c != kPad) atomicAdd(pairs + b * kPairs + p[j] * 5 + c, 1);
    }
  }
  __syncthreads();
  scan_columns(pairs, nb, kPairs, nullptr, tile_pairs + blockIdx.x * kPairs, part);
  for (int i = threadIdx.x; i < nb * kPairs; i += kThreads) {
    const int r = i / kPairs;
    plane[static_cast<size_t>(b0 + r) * kCols + 32 + (i - r * kPairs)] = pairs[i];
  }
}

// 5. Each tile's pair base (the pair counts of the tiles before it) added to
// its rows' checkpoints: every load of a thread in flight, then the stores.
__global__ void __launch_bounds__(kThreads)
add_pair_base(int nblocks, const int* tile_pairs, int* plane) {
  if (blockIdx.x == 0) return;  // the first tile's base is 0
  constexpr int kEach = (kTile * kPairs + kThreads - 1) / kThreads;
  const int b0 = blockIdx.x * kTile;
  const int nb = min(kTile, nblocks - b0);
  const int* add = tile_pairs + blockIdx.x * kPairs;
  int v[kEach];
#pragma unroll
  for (int u = 0; u < kEach; ++u) {
    const int i = u * kThreads + static_cast<int>(threadIdx.x);
    const int r = i / kPairs;
    if (i < nb * kPairs) v[u] = plane[static_cast<size_t>(b0 + r) * kCols + 32 + (i - r * kPairs)];
  }
#pragma unroll
  for (int u = 0; u < kEach; ++u) {
    const int i = u * kThreads + static_cast<int>(threadIdx.x);
    const int r = i / kPairs, k = i - r * kPairs;
    if (i < nb * kPairs) plane[static_cast<size_t>(b0 + r) * kCols + 32 + k] = v[u] + __ldg(add + k);
  }
}

int tiles(int nblocks) { return (nblocks + kTile - 1) / kTile; }

}  // namespace

// Ints of scratch siga_pair_plane needs for nblocks plane rows.
extern "C" int siga_pair_plane_scratch(int nblocks) { return (5 + kPairs) * tiles(nblocks); }

// The pair plane (int32 [nblocks, 57]) and K (int32 [5, 5]) of the BWT codes
// (uint8 [n], 16-byte aligned), with pred the C array and nblocks = n / 128
// + 1; scratch holds siga_pair_plane_scratch(nblocks) ints.  Five launches.
extern "C" int siga_pair_plane(const void* codes, int n, int nblocks, int p0, int p1, int p2,
                               int p3, int p4, void* plane, void* K, void* scratch,
                               void* stream) {
  if (n < 0 || n > INT32_MAX - kSample || nblocks != n / kSample + 1 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Pred pred = {{p0, p1, p2, p3, p4}};
  const int nt = tiles(nblocks);
  int* tile_counts = static_cast<int*>(scratch);
  int* tile_pairs = tile_counts + 5 * nt;
  const auto* c = static_cast<const unsigned char*>(codes);
  auto* out = static_cast<int*>(plane);
  const auto s = static_cast<cudaStream_t>(stream);
  count_tiles<<<nt, kThreads, 0, s>>>(c, n, tile_counts);
  scan_tiles<<<1, kScanThreads, 0, s>>>(tile_counts, nt, 5);
  plane_rows<<<nt, kThreads, 0, s>>>(c, n, nblocks, pred, tile_counts, out, tile_pairs,
                                     static_cast<int*>(K));
  scan_tiles<<<1, kScanThreads, 0, s>>>(tile_pairs, nt, kPairs);
  add_pair_base<<<nt, kThreads, 0, s>>>(nblocks, tile_pairs, out);
  return static_cast<int>(cudaGetLastError());
}
