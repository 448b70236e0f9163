// K7: batched k-mer occurrence counting on the FM-index pair plane, for sm_90a.
//
// Replaces siga_tpu/ops/kmer_count.py::_count_scan (an XLA program on the
// TPU: k-1 lockstep backward-search steps over every k-mer of a batch);
// siga_tpu_torch/ops/kmer_count.py::count_kmers_plain is the same function in
// plain PyTorch.  One thread per k-mer keeps its interval (lo, hi) in
// registers.  The last symbol opens the interval, lo = C[c] and
// hi = lo + occ_c(length - 1) - 1.  Then the thread prepends two symbols per
// step, as K1's supersteps do: one pair-plane row read at lo - 1 and one at
// hi give the pair counts, and K[c2][c1] + occ2((c2, c1), .) is the interval
// two symbols on.  A lone last symbol, and any step that would take a rank-0
// symbol ('$', or N, which encodes to rank 0), goes one symbol on through the
// row's single-symbol counts instead, since the pair counts do not serve
// c1 = 0.  A thread stops once its interval is empty: an empty interval stays
// empty, and the count is max(hi - lo + 1, 0).
//
// What bounds it: dependent row reads, as in K1.  Each step's row addresses
// depend on the last step's counts, so a k-mer is a chain of about k/2 pairs
// of 228-byte row reads, and throughput comes from many k-mers in flight.
// A k-mer absent from the index usually empties within a dozen symbols and
// its thread stops there.
#include <cassert>
#include <cuda_runtime.h>

#include "pair_occ.cuh"

namespace {

using pair_occ::occ_row;
using pair_occ::sel5;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
kmer_count_kernel(const int* plane, const int* K, const int* pred, int length,
                  int nblocks, const unsigned char* kmers, int Q, int k, int* out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const unsigned char* w = kmers + static_cast<size_t>(q) * k;
  int pr[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) pr[c] = __ldg(pred + c);

  int ls[5], lp[5], us[5], up[5];
  const int c0 = __ldg(w + k - 1);
  assert(c0 <= 4);
  int lo = sel5(pr, c0);
  occ_row<false>(plane, nblocks, 0, length - 1, 0, us, up);
  int hi = lo + sel5(us, c0) - 1;

  int j = k - 2;  // the next symbol to prepend
  while (j >= 0 && lo <= hi) {
    const int c1 = __ldg(w + j);
    const int c2 = j > 0 ? __ldg(w + j - 1) : 0;
    assert(c1 <= 4 && c2 <= 4);
    if (c1 > 0 && c2 > 0) {
      occ_row<true>(plane, nblocks, 0, lo - 1, c1, ls, lp);
      occ_row<true>(plane, nblocks, 0, hi, c1, us, up);
      const int kv = __ldg(K + c2 * 5 + c1);
      lo = kv + sel5(lp, c2);
      hi = kv + sel5(up, c2) - 1;
      j -= 2;
    } else {
      occ_row<false>(plane, nblocks, 0, lo - 1, 0, ls, lp);
      occ_row<false>(plane, nblocks, 0, hi, 0, us, up);
      lo = sel5(pr, c1) + sel5(ls, c1);
      hi = sel5(pr, c1) + sel5(us, c1) - 1;
      j -= 1;
    }
  }
  out[q] = max(hi - lo + 1, 0);
}

}  // namespace

extern "C" int siga_kmer_count(const void* plane, const void* K, const void* pred,
                               int length, int nblocks, const void* kmers, int Q,
                               int k, void* out, void* stream) {
  const int grid = (Q + kThreads - 1) / kThreads;
  kmer_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(plane), static_cast<const int*>(K),
      static_cast<const int*>(pred), length, nblocks,
      static_cast<const unsigned char*>(kmers), Q, k, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
