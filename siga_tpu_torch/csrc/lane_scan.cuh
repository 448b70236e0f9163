// What the stage-A scans K1 (scan_pair.cu) and K3 (scan_single.cu) share: the
// lane groups' transform ids and the ballot that writes the lanes' candidate
// and substring bits; and K1's reader of the symbols a lane prepends, from
// its 2-bit packed read (K3 has its own, which loads a step ahead).
#pragma once

#include <cuda_runtime.h>

namespace lane_scan {

// Lane-group transform ids (ops/fm_device.py GROUP_*): how a lane's scan
// sequence derives from its read.
enum Group { kId = 0, kRc = 1, kRev = 2, kComp = 3 };

__device__ __forceinline__ int comp(int c) { return c == 0 ? 0 : 5 - c; }

// Symbols of one left-aligned read, read in order (ascending or descending):
// the current 2-bit word stays in a register and is reloaded every 16 symbols.
struct SymReader {
  const unsigned* words;
  int len;
  int word_i;
  unsigned word;

  __device__ __forceinline__ SymReader(const int* w, int l)
      : words(reinterpret_cast<const unsigned*>(w)), len(l), word_i(-1), word(0u) {}

  // rank 1..4 of symbol j; 0 outside [0, len)
  __device__ __forceinline__ int at(int j) {
    if (j < 0 || j >= len) return 0;
    if ((j >> 4) != word_i) {
      word_i = j >> 4;
      word = __ldg(words + word_i);
    }
    return static_cast<int>((word >> (2 * (j & 15))) & 3u) + 1;
  }
};

// The symbol prepended at step t: s'[l-2-t] of the lane's transformed read;
// t = -1 gives the first symbol s'[l-1], which opens the search interval.
__device__ __forceinline__ int step_char(SymReader& rd, int group, int t) {
  switch (group) {
    case kId: return rd.at(rd.len - 2 - t);
    case kRc: return comp(rd.at(t + 1));
    case kRev: return rd.at(t + 1);
    default: return comp(rd.at(rd.len - 2 - t));
  }
}

// OR the group leaders' candidate and substring flags into their mask words
// (zeroed by the caller).  Every thread of the warp calls it.  A warp holds
// 32 / kGroup consecutive lanes and a launch's first lane is a multiple of 32,
// so their bits are one aligned run of one mask word; `lane` is the calling
// thread's lane.
template <int kGroup>
__device__ __forceinline__ void write_lane_bits(bool leader, bool fvalid, bool substring,
                                                int lane, unsigned* candmask,
                                                unsigned* subwords) {
  const unsigned cb = __ballot_sync(0xFFFFFFFFu, leader && fvalid);
  const unsigned sb = __ballot_sync(0xFFFFFFFFu, leader && substring);
  if ((threadIdx.x & 31) == 0) {
    unsigned cbits = 0u, sbits = 0u;
#pragma unroll
    for (int k = 0; k < 32 / kGroup; ++k) {
      cbits |= ((cb >> (k * kGroup)) & 1u) << k;
      sbits |= ((sb >> (k * kGroup)) & 1u) << k;
    }
    if (cbits) atomicOr(candmask + (lane >> 5), cbits << (lane & 31));
    if (sbits) atomicOr(subwords + (lane >> 5), sbits << (lane & 31));
  }
}

}  // namespace lane_scan
