// Gather probes G1-G4 for sm_90a: the Hopper counterparts of the Pallas
// gather probes under benchmark/probes/, which measured how fast a TPU core
// gathers rows and lanes from VMEM and HBM.  On the card they measure the
// same thing for K1 (csrc/scan_pair.cu), whose every step is a dependent read
// of one 228-byte pair-plane row.  siga_tpu_torch/probes/gather.py holds the
// wrappers and the plain PyTorch version of each kernel.
//
// G1 gather_rows: out[q, :] = plane[idx[q], :].  Replaces the row gathers
//   k_sub (probe_gather.py:174), k1, k3, k4 and k5 (pallas_gather.py:48, 95,
//   148, 172).  Bound: HBM/L2 sectors.  One warp per output row, its threads
//   on neighbouring columns, so each row costs its own ceil(4C/32) sectors
//   whatever C is; C need not be a multiple of 4 (the pair plane's 57 words
//   are 228 bytes), and no thread divides to find its row.
// G2 take_along: torch/JAX take_along_axis on a 2-D table, axis 0 or 1, with a
//   full or broadcast (stride-0) index.  Replaces k_lane (probe_gather.py:147),
//   k_a, k_b, k_c (probe3.py:121, 138, 155) and k2 (pallas_gather.py:72).
//   Bound: the random reads.  For axis 1 a block copies its table row into
//   shared memory when the row fits (8192 int32 is 32 KB), so the random reads
//   hit shared memory and device memory is read once, in order; a wider row
//   is read in place by smaller blocks, enough of them to fill the card.
// G3 gather_chain: the dependent recurrences of k_scan (probe_gather.py:201,
//   mode sum: state = (state + sum_w table[w, (state + t) % NB] + c[t % |c|])
//   % NB) and k_d (probe3.py:173, mode elem: state = (state + table[w, state]
//   + s) % N).  One thread per lane keeps its state in a register, as K1 does.
//   Bound: latency, one memory round trip per step per lane (mode sum issues a
//   step's row loads in batches of 32 before it adds them); the time per step
//   with all lanes in flight is the floor for K1's chain of row reads.
// G4 scale2: out = 2 * x, the build-and-launch check of probe2.py:67.  Bound:
//   streaming bandwidth.
//
// Arithmetic is int32 with wrap-around, as JAX's is, and `%` is the floor
// modulo of jnp.remainder / torch.remainder (non-negative for a positive
// modulus).  Every index a kernel reads (G1, G2) and every chain's initial
// state (G3) is checked against its range with a device-side assert, so a bad
// index stops the kernel and raises at the next synchronisation instead of
// reading outside the table; the wrappers never wait on the card for it.
#include <cassert>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kWarps = kThreads / 32;
constexpr int kTileShared = 8192;         // output columns per block, G2 axis 1
constexpr int kTileGlobal = 1024;
constexpr int kBatch = 32;                // G3 row loads in flight per thread
constexpr int kSmemDefault = 48 * 1024;   // above it, opt in per kernel
constexpr int kSmemMax = 227 * 1024;

int grid_for(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int wrap_add(int a, unsigned b) {
  return static_cast<int>(static_cast<unsigned>(a) + b);
}

__global__ void gather_rows_kernel(const int* __restrict__ plane,
                                   const int* __restrict__ idx, int R, int Q,
                                   int C, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  for (int q = blockIdx.x * kWarps + (threadIdx.x >> 5); q < Q;
       q += gridDim.x * kWarps) {
    const int r = idx[q];
    assert(0 <= r && r < R);
    const int* src = plane + static_cast<long long>(r) * C;
    int* dst = out + static_cast<long long>(q) * C;
    for (int c = lane; c < C; c += 32) dst[c] = src[c];
  }
}

// axis 1: out[i, j] = table[i, index[i * si0 + j * si1]]; one block per
// (row i, tile of kTile output columns)
template <bool kShared, int kTile>
__global__ void take_along1_kernel(const int* __restrict__ table,
                                   const int* __restrict__ index, int B, int Q,
                                   long long si0, long long si1,
                                   int* __restrict__ out) {
  extern __shared__ int row_smem[];
  const int i = blockIdx.y;
  const int* row = table + static_cast<long long>(i) * B;
  if (kShared) {
    for (int k = threadIdx.x; k < B; k += blockDim.x) row_smem[k] = row[k];
    __syncthreads();
    row = row_smem;
  }
  const int j0 = blockIdx.x * kTile;
  const int j1 = min(j0 + kTile, Q);
  for (int j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
    const int k = index[i * si0 + j * si1];
    assert(0 <= k && k < B);
    out[static_cast<long long>(i) * Q + j] = row[k];
  }
}

// axis 0: out[i, j] = table[index[i * si0 + j * si1], j], out [Q, B]
__global__ void take_along0_kernel(const int* __restrict__ table,
                                   const int* __restrict__ index, int A, int B,
                                   long long total, long long si0, long long si1,
                                   int* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long i = e / B;
    const int j = static_cast<int>(e - i * B);
    const int k = index[i * si0 + j * si1];
    assert(0 <= k && k < A);
    out[e] = table[static_cast<long long>(k) * B + j];
  }
}

__global__ void chain_sum_kernel(const int* __restrict__ table, long long sw,
                                 long long sx, int W, int NB,
                                 const int* __restrict__ init,
                                 const int* __restrict__ c, int Lc, int steps,
                                 int L, int* __restrict__ out) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  int state = init[l];
  assert(0 <= state && state < NB);
  for (int t = 0; t < steps; ++t) {
    const int* col = table + static_cast<long long>((state + t) % NB) * sx;
    unsigned acc = static_cast<unsigned>(c[t % Lc]);
    for (int w0 = 0; w0 < W; w0 += kBatch) {
      unsigned v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        v[k] = w0 + k < W ? static_cast<unsigned>(col[(w0 + k) * sw]) : 0u;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) acc += v[k];
    }
    state = floor_mod(wrap_add(state, acc), NB);
  }
  out[l] = state;
}

__global__ void chain_elem_kernel(const int* __restrict__ table, long long sw,
                                  long long sx, int N, const int* __restrict__ init,
                                  int M, long long total, int steps,
                                  int* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int* row = table + (e / M) * sw;
  int state = init[e];
  assert(0 <= state && state < N);
  for (int s = 0; s < steps; ++s) {
    const unsigned g = static_cast<unsigned>(row[state * sx]);
    state = floor_mod(wrap_add(state, g + static_cast<unsigned>(s)), N);
  }
  out[e] = state;
}

__global__ void scale2_kernel(const int* __restrict__ x, long long n,
                              int* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += stride) {
    out[e] = static_cast<int>(static_cast<unsigned>(x[e]) * 2u);
  }
}

}  // namespace

extern "C" int siga_gather_rows(const void* plane, const void* idx, int R, int Q,
                                int C, void* out, void* stream) {
  const int blocks = (Q + kWarps - 1) / kWarps;
  gather_rows_kernel<<<blocks < kMaxBlocks ? blocks : kMaxBlocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(plane), static_cast<const int*>(idx), R, Q, C,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int siga_take_along(const void* table, const void* index, int A, int B,
                               int Q, long long si0, long long si1, int axis,
                               void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* ix = static_cast<const int*>(index);
  int* o = static_cast<int*>(out);
  if (axis == 0) {
    const long long total = static_cast<long long>(Q) * B;
    take_along0_kernel<<<grid_for(total), kThreads, 0, s>>>(t, ix, A, B, total,
                                                            si0, si1, o);
    return static_cast<int>(cudaGetLastError());
  }
  if (A > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = static_cast<long long>(B) * sizeof(int);
  if (smem <= kSmemMax) {
    if (smem > kSmemDefault) {
      const cudaError_t rc = cudaFuncSetAttribute(
          take_along1_kernel<true, kTileShared>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    const dim3 grid((Q + kTileShared - 1) / kTileShared, A);
    take_along1_kernel<true, kTileShared><<<grid, kThreads * 4, smem, s>>>(
        t, ix, B, Q, si0, si1, o);
  } else {
    const dim3 grid((Q + kTileGlobal - 1) / kTileGlobal, A);
    take_along1_kernel<false, kTileGlobal><<<grid, kThreads, 0, s>>>(
        t, ix, B, Q, si0, si1, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int siga_gather_chain_sum(const void* table, long long sw, long long sx,
                                     int W, int NB, const void* init,
                                     const void* c, int Lc, int steps, int L,
                                     void* out, void* stream) {
  chain_sum_kernel<<<(L + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), sw, sx, W, NB,
      static_cast<const int*>(init), static_cast<const int*>(c), Lc, steps, L,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int siga_gather_chain_elem(const void* table, long long sw, long long sx,
                                      int W, int N, const void* init, int M,
                                      int steps, void* out, void* stream) {
  const long long total = static_cast<long long>(W) * M;
  const long long blocks = (total + kThreads - 1) / kThreads;
  chain_elem_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), sw, sx, N, static_cast<const int*>(init), M,
      total, steps, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int siga_scale2(const void* x, long long n, void* out, void* stream) {
  scale2_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), n, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
