// K5: batched affine-gap Smith-Waterman by anti-diagonal wavefront, sm_90a.
//
// Replaces the Pallas TPU kernel siga_tpu/ops/sw_pallas.py::_sw_kernel and
// also returns the end positions that the JAX package took from the XLA
// version (siga_tpu/ops/sw_device.py::_sw_wavefront);
// siga_tpu_torch/ops/sw.py::sw_wavefront_plain is the same function in plain
// PyTorch.  One block per (query, ref) pair, one thread per query row i
// (cells 0..M); thread i computes cell (i, d - i) of anti-diagonal d.  The H
// values of the last three diagonals and E of the last two live in shared
// memory as rings, so each diagonal costs one barrier; F stays in the
// thread's registers.
//
// What bounds it: the m + n - 1 dependent diagonal steps, each a handful of
// integer ops and one barrier.  Blocks are small (M + 1 threads rounded to a
// warp), so many pairs run on each SM at once; the reference symbols are read
// from global memory (neighbouring threads read neighbouring addresses).
//
// Ties resolve as in _sw_wavefront: the first diagonal that reaches the
// maximum, then the smallest query row on it.  Query code 0 is padding and
// never matches.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 20);

__global__ void sw_kernel(const int* __restrict__ queries,
                          const int* __restrict__ refs, int M, int N, int match,
                          int mismatch, int gap_open, int gap_extend, int* best,
                          int* qend, int* rend) {
  extern __shared__ int smem[];
  const int cp = blockDim.x;  // >= M + 1
  int* H = smem;              // [3][cp] ring: diagonals d, d-1, d-2
  int* E = H + 3 * cp;        // [2][cp] ring
  int* best_h = E + 2 * cp;   // [cp]
  int* best_d = best_h + cp;  // [cp]
  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const int* ref = refs + static_cast<size_t>(b) * N;
  const int q = (i >= 1 && i <= M) ? queries[static_cast<size_t>(b) * M + i - 1] : 0;

#pragma unroll
  for (int r = 0; r < 3; ++r) H[r * cp + i] = kNeg;
  E[i] = kNeg;
  E[cp + i] = kNeg;
  int f = kNeg;
  int bh = INT_MIN, bd = 0;
  __syncthreads();

  for (int d = 2; d <= M + N; ++d) {
    const int* Hp = H + ((d - 1) % 3) * cp;
    const int* Hp2 = H + ((d - 2) % 3) * cp;
    const int* Ep = E + ((d - 1) & 1) * cp;
    if (i <= M) {
      const int j = d - i;
      const bool valid = i >= 1 && j >= 1 && j <= N;
      const int h_up = i > 0 ? Hp[i - 1] : kNeg;
      const int e_up = i > 0 ? Ep[i - 1] : kNeg;
      int e = max(h_up - gap_open, e_up - gap_extend);
      int fv = max(Hp[i] - gap_open, f - gap_extend);
      int h_diag = i > 0 ? Hp2[i - 1] : kNeg;
      if (i == 1) h_diag = 0;               // H[0][j-1] = 0
      if (j == 1 && i >= 1) h_diag = 0;     // H[i][0] = 0
      const int r = (j >= 1 && j <= N) ? __ldg(ref + j - 1) : 0;
      const int sub = (q == r && q > 0) ? match : -mismatch;
      int h = max(max(h_diag + sub, e), fv);
      h = max(h, 0);
      if (!valid) {
        h = kNeg;
        e = kNeg;
        fv = kNeg;
      } else if (h > bh) {
        bh = h;
        bd = d;
      }
      H[(d % 3) * cp + i] = h;
      E[(d & 1) * cp + i] = e;
      f = fv;
    }
    __syncthreads();
  }

  best_h[i] = i <= M ? bh : INT_MIN;
  best_d[i] = bd;
  __syncthreads();
  if (i == 0) {
    int h = INT_MIN, dd = 0, ii = 0;
    for (int k = 0; k <= M; ++k) {
      if (best_h[k] > h || (best_h[k] == h && best_d[k] < dd)) {
        h = best_h[k];
        dd = best_d[k];
        ii = k;
      }
    }
    const bool none = h <= 0;
    best[b] = none ? 0 : h;
    qend[b] = none ? -1 : ii - 1;
    rend[b] = none ? -1 : dd - ii - 1;
  }
}

}  // namespace

extern "C" int siga_sw_wavefront(const void* queries, const void* refs, int B,
                                 int M, int N, int match, int mismatch,
                                 int gap_open, int gap_extend, void* best,
                                 void* qend, void* rend, void* stream) {
  const int threads = ((M + 1 + 31) / 32) * 32;
  if (threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(7) * threads * sizeof(int);
  sw_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(queries), static_cast<const int*>(refs), M, N,
      match, mismatch, gap_open, gap_extend, static_cast<int*>(best),
      static_cast<int*>(qend), static_cast<int*>(rend));
  return static_cast<int>(cudaGetLastError());
}
