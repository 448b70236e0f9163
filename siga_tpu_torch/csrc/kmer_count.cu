// K7: batched k-mer occurrence counting on the FM-index pair plane, for sm_90a.
//
// Replaces siga_tpu/ops/kmer_count.py::_count_scan (an XLA program on the
// TPU: k-1 lockstep backward-search steps over every k-mer of a batch);
// siga_tpu_torch/ops/kmer_count.py::count_kmers_plain is the same function in
// plain PyTorch.  Each k-mer keeps its interval (lo, hi).  The last symbol
// opens it, lo = C[c] and hi = lo + occ_c(length - 1) - 1.  Then it prepends
// two symbols per step, as K1's supersteps do: the pair-plane rows at lo - 1
// and at hi give the pair counts, and K[c2][c1] + occ2((c2, c1), .) is the
// interval two symbols on.  A lone last symbol, and any step that would take
// a rank-0 symbol ('$', or N, which encodes to rank 0), goes one symbol on
// through the rows' single-symbol counts instead, since the pair counts do
// not serve c1 = 0.  A k-mer stops once its interval is empty: an empty
// interval stays empty, and the count is max(hi - lo + 1, 0).
//
// What bounds it: dependent row reads, as in K1.  A k-mer is a chain of
// about k/2 steps of two row reads each.  At 262,144 41-mers the rows they
// all read bound it; `correct` launches it on a few to ~110 k-mers at a
// time (a weak base's candidates, a read's k-mers), where one chain of ~20
// L2 round trips does.  The first design (one thread per k-mer) read
// each row as ~57 scalar loads from one thread.  This one serves a k-mer with
// a group of 8 threads (pair_occ::kGroup) and K1's group occ
// (csrc/pair_occ.cuh): coalesced row slices, both rows' loads issued before
// either is summed, only s[c1] and p[c2] summed over the group by shuffles;
// the early stop and the single steps depend on group-uniform values.
// Times on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md; chip_smoke.py and
// probes/kernel_ab.py), bit-equal to the first design: 262,144 41-mers
// 0.509-0.555 ms (the first design 0.735-0.740 ms in the same calls); 3 and
// 110 41-mers 0.016-0.017 ms a launch (the first design 0.035 and 0.058 ms).
#include <cassert>
#include <cuda_runtime.h>

#include "pair_occ.cuh"

namespace {

using pair_occ::kGroup;
using pair_occ::RowSlice;
using pair_occ::sel5;

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
kmer_count_kernel(const int* plane, const int* K, const int* pred, int length,
                  int nblocks, const unsigned char* kmers, int Q, int k, int* out) {
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = gtid & (kGroup - 1);
  const int q = gtid / kGroup;
  if (q >= Q) return;  // whole groups leave together
  const unsigned gmask = pair_occ::group_mask();
  const unsigned char* w = kmers + static_cast<size_t>(q) * k;
  int pr[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) pr[c] = __ldg(pred + c);

  RowSlice r0, r1;
  int us[5];
  const int c0 = __ldg(w + k - 1);
  assert(c0 <= 4);
  int lo = sel5(pr, c0);
  r0.load(plane, nblocks, 0, length - 1, j, false);
  pair_occ::singles(r0, j, gmask, us);
  int hi = lo + sel5(us, c0) - 1;

  int i = k - 2;  // the next symbol to prepend
  while (i >= 0 && lo <= hi) {
    const int c1 = __ldg(w + i);
    const int c2 = i > 0 ? __ldg(w + i - 1) : 0;
    assert(c1 <= 4 && c2 <= 4);
    const bool pair = c1 > 0 && c2 > 0;
    r0.load(plane, nblocks, 0, lo - 1, j, pair);
    r1.load(plane, nblocks, 0, hi, j, pair);
    const pair_occ::StepCounts L = pair_occ::step_counts<false>(r0, j, c1, c2, gmask);
    const pair_occ::StepCounts U = pair_occ::step_counts<false>(r1, j, c1, c2, gmask);
    if (pair) {
      const int kv = __ldg(K + c2 * 5 + c1);
      lo = kv + L.p_c2;
      hi = kv + U.p_c2 - 1;
      i -= 2;
    } else {
      lo = sel5(pr, c1) + L.s_c1;
      hi = sel5(pr, c1) + U.s_c1 - 1;
      i -= 1;
    }
  }
  if (j == 0) out[q] = max(hi - lo + 1, 0);
}

}  // namespace

// Counts of Q k-mers (uint8 ranks [Q, k]), kGroup threads a k-mer.
extern "C" int siga_kmer_count(const void* plane, const void* K, const void* pred,
                               int length, int nblocks, const void* kmers, int Q,
                               int k, void* out, void* stream) {
  const long long threads = static_cast<long long>(Q) * kGroup;
  const int grid = static_cast<int>((threads + kThreads - 1) / kThreads);
  kmer_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(plane), static_cast<const int*>(K),
      static_cast<const int*>(pred), length, nblocks,
      static_cast<const unsigned char*>(kmers), Q, k, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
