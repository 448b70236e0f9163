// Gather probes G1-G4 for sm_90a: the Hopper counterparts of the Pallas
// gather probes under benchmark/probes/, which measured how fast a TPU core
// gathers rows and lanes from VMEM and HBM.  On the card they measure the
// same thing for K1 (csrc/scan_pair.cu), whose every step is a dependent read
// of one 228-byte pair-plane row.  siga_tpu_torch/probes/gather.py holds the
// wrappers and the plain PyTorch version of each kernel.
//
// G1 gather_rows: out[q, :] = plane[idx[q], :].  Replaces the row gathers
//   k_sub (probe_gather.py:174), k1, k3, k4 and k5 (pallas_gather.py:48, 95,
//   148, 172).  Bound: HBM/L2 sectors.  The output is a flat run of items,
//   one a thread: 16-byte vectors where a row is (C % 4 == 0 and the plane
//   and out 16-byte aligned: C / 4 threads a row, 32 / (C / 4) rows a warp
//   at C = 16), else words (the pair plane's 57-word, 228-byte rows, or a
//   plane 4 bytes off the boundary), so no lane idles whatever C is and
//   each warp's loads and stores cover whole runs of neighbouring rows.  The
//   grid covers the items up to 8 blocks an SM (the SM count read at each
//   launch), beyond that a thread takes several, four indices and loads in
//   flight before its stores.
// G2 take_along: torch/JAX take_along_axis on a 2-D table, axis 0 or 1, with a
//   full or broadcast (stride-0) index.  Replaces k_lane (probe_gather.py:147),
//   k_a, k_b, k_c (probe3.py:121, 138, 155) and k2 (pallas_gather.py:72).
//   Bound: the random reads (each fetches a 32-byte sector for 4 bytes) and
//   the output writes.  The wrapper (`gather.take_along_plan`) picks the form
//   and the block's shape; the grid follows from them here:
//   - axis 1, shared (k_lane, k2): a 1024-thread block copies its table row
//     into shared memory, eight loads a thread in flight, then serves a tile
//     of at least a quarter of the row's width from it: the row costs B / 8
//     sectors in order instead of one sector an output.  Only where the row
//     fits and the tiles give at least a block for every two SMs;
//   - axis 1, direct (k_a, k_c, the transposed pair plane, rows wider than
//     shared memory): one output a thread, the table word read in place,
//     as many blocks as the outputs need.  A thread that walked the rows for
//     one index column, its index read once, was slower than this form at
//     every probe shape tried: independent loads hide their latency better
//     than a thread's chain of rows;
//   - axis 0 (k_b): one output a thread of a grid-stride loop.
// G3 gather_chain: the dependent recurrences of k_scan (probe_gather.py:201,
//   mode sum: state = (state + sum_w table[w, (state + t) % NB] + c[t % |c|])
//   % NB) and k_d (probe3.py:173, mode elem: state = (state + table[w, state]
//   + s) % N).  Bound: latency, one memory round trip per step per lane; the
//   time per step with all lanes in flight is the floor for K1's chain of
//   row reads.
//   - mode sum spreads a lane's step over a group of G threads (G = 1, 2, 4
//     or 8, a template width that gather.py's chain_plan picks).  Where a
//     row's W words are contiguous (sw == 1: the pair plane's transpose,
//     K1's 228-byte row at any 4-byte offset), the group reads the aligned
//     16-byte vectors covering [row, row + W) with the edge words masked, G
//     vectors in flight a round (15 vectors for K1's row); strided words
//     (k_scan's [24, 8192] table) go out as scalar loads, G a round.  Every
//     load of a round is issued before the first add, so a step of up to 16
//     vectors or 32 words costs one round trip; the group sums with
//     __shfl_xor_sync and each of its threads then holds the same state.
//     The step's index (state + t) % NB and c's index are kept as counters,
//     and the floor modulo of the new state is Lemire's multiply-high
//     remainder with a constant the host computes, so the chain holds no
//     division.  Readings of every G: PERF.md (chip_smoke.py's sweep).
//   - mode elem keeps one thread a lane with its state in a register, in one
//     of two forms that gather.py's chain_elem_plan picks.  Shared (k_d): a
//     block for each (table row, 512 lanes) stages the row in shared memory
//     by cp.async (16-byte vectors where it is contiguous and aligned, else
//     words), each word reduced to its floor modulo N on the way, so that a
//     step is one shared load, an add and a three-way minimum (a mask where
//     N is a power of two); a row with a word near INT_MAX, whose int32 sum
//     may wrap, is staged again as it is and takes the exact step.  A step
//     then costs the shared memory's bank conflicts, not a round trip.
//     Direct (strided rows, rows past shared memory, too few lanes to pay
//     for a row): one single-word gather in place a step, as K1 reads.
// G4 scale2: out = 2 * x, the build-and-launch check of probe2.py:67.  Bound:
//   streaming bandwidth, each byte read once and written once.  A thread
//   moves one 16-byte int4 vector and exits; the grid covers the vectors
//   and the hardware deals blocks to SMs as they free up.  A grid capped at
//   8 blocks an SM striding over the data was slower on the pair plane, and
//   2-8 vectors in flight a thread no faster (PERF.md).  The wrapper
//   (`gather.scale2`) places out at x's offset within 16 bytes and
//   `gather.scale2_plan` splits the elements: a scalar head up to the first
//   16-byte boundary, the vectors, then a scalar tail; the scalars go one a
//   thread to the first threads.  Every load and store carries the
//   streaming hint (ld/st.global.cs), since no byte is read twice.  On the
//   90 MB pair plane (H100 80GB HBM3, 700 W; chip_smoke.py, PERF.md) the
//   kernel took 0.0617 and 0.0620 ms with the hints against 0.0621 and
//   0.0625 ms without them, in the same rounds of two runs.
//
// Arithmetic is int32 with wrap-around, as JAX's is, and `%` is the floor
// modulo of jnp.remainder / torch.remainder (non-negative for a positive
// modulus).  Every index a kernel reads (G1, G2) and every chain's initial
// state (G3) is checked against its range with a device-side assert, so a bad
// index stops the kernel and raises at the next synchronisation instead of
// reading outside the table; the wrappers never wait on the card for it.
#include <cassert>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kSharedThreads = 1024;      // G2 blocks that copy a row to shared memory
constexpr int kCopyInFlight = 8;          // G2 row-copy loads in flight per thread
constexpr int kSmemDefault = 48 * 1024;   // above it, opt in per kernel

// G2 forms, as gather.py's take_along_plan numbers them
enum TakeForm { kAxis0 = 0, kShared = 1, kDirect = 2 };

__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int wrap_add(int a, unsigned b) {
  return static_cast<int>(static_cast<unsigned>(a) + b);
}

// G1 over n items of `per_row` a row (16-byte vectors T = uint4, or words T
// = int): item g of the output is item g % per_row of row idx[g / per_row].
// A grid-stride loop, kRowsInFlight items a thread a round, their indices
// and loads issued before the first store.
constexpr int kRowsInFlight = 4;

template <typename T, typename I>
__global__ void gather_rows_kernel(const T* __restrict__ plane, const int* __restrict__ idx, int R,
                                   I n, I per_row, T* __restrict__ out) {
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  for (I g0 = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x; g0 < n;
       g0 += kRowsInFlight * stride) {
    T v[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const I g = g0 + u * stride;
      if (g < n) {
        const I q = g / per_row;
        const int r = __ldg(idx + q);
        assert(0 <= r && r < R);
        v[u] = __ldg(plane + static_cast<I>(r) * per_row + (g - q * per_row));
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const I g = g0 + u * stride;
      if (g < n) out[g] = v[u];
    }
  }
}

template <typename T>
void launch_gather_rows(const void* plane, const void* idx, int R, long long n, long long per_row,
                        void* out, int sms, cudaStream_t s) {
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
  const T* p = static_cast<const T*>(plane);
  const int* ix = static_cast<const int*>(idx);
  T* o = static_cast<T*>(out);
  if (n <= 0xFFFFFFFFLL - static_cast<long long>(blocks) * kThreads * kRowsInFlight) {
    gather_rows_kernel<T, unsigned><<<blocks, kThreads, 0, s>>>(
        p, ix, R, static_cast<unsigned>(n), static_cast<unsigned>(per_row), o);
  } else {
    gather_rows_kernel<T, unsigned long long><<<blocks, kThreads, 0, s>>>(
        p, ix, R, static_cast<unsigned long long>(n), static_cast<unsigned long long>(per_row), o);
  }
}

// axis 1: out[i, j] = table[i, index[i * si0 + j * si1]] (si0 = 0: one index
// row for every table row); block b serves row b / tiles, columns
// [(b % tiles) * tile, +tile).  kSharedRow: the row is first copied to shared
// memory (B words) and read there.
template <bool kSharedRow>
__global__ void take_along1_kernel(const int* __restrict__ table,
                                   const int* __restrict__ index, int B, int Q,
                                   long long si0, long long si1, int tile,
                                   int tiles, int* __restrict__ out) {
  extern __shared__ int row_smem[];
  const int i = blockIdx.x / tiles;
  const int j0 = blockIdx.x % tiles * tile;
  const int j1 = min(j0 + tile, Q);
  const int* row = table + static_cast<long long>(i) * B;
  if (kSharedRow) {
    // kCopyInFlight loads a thread before their stores, so that the copy
    // waits for about one memory round trip, not one a word
    for (int k0 = 0; k0 < B; k0 += kCopyInFlight * blockDim.x) {
      int v[kCopyInFlight];
#pragma unroll
      for (int r = 0; r < kCopyInFlight; ++r) {
        const int k = k0 + threadIdx.x + r * blockDim.x;
        if (k < B) v[r] = row[k];
      }
#pragma unroll
      for (int r = 0; r < kCopyInFlight; ++r) {
        const int k = k0 + threadIdx.x + r * blockDim.x;
        if (k < B) row_smem[k] = v[r];
      }
    }
    __syncthreads();
    row = row_smem;
  }
  const int* ix = index + i * si0;
  int* o = out + static_cast<long long>(i) * Q;
  for (int j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
    const int k = ix[j * si1];
    assert(0 <= k && k < B);
    o[j] = row[k];
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

// floor_mod(v, NB) for any int32 v: (v + 2^31) mod NB by Lemire's
// multiply-high remainder (magic = 2^64 / NB rounded up, exact for every
// 32-bit dividend), less 2^31 mod NB, back into [0, NB)
struct FloorMod {
  unsigned long long magic;
  unsigned nb, bias;  // NB and 2^31 mod NB
};

__device__ __forceinline__ int floor_mod_fast(int v, const FloorMod& m) {
  const unsigned u = static_cast<unsigned>(v) ^ 0x80000000u;
  const unsigned r = static_cast<unsigned>(__umul64hi(m.magic * u, m.nb));
  return r >= m.bias ? static_cast<int>(r - m.bias) : static_cast<int>(r + m.nb - m.bias);
}

// sum of x[0..n) as a tree (n a power of two), so the adds are log n deep;
// a recursion, since a halving loop is not unrolled and its array would go
// to local memory
template <int n, int size>
__device__ __forceinline__ unsigned tree_sum(unsigned (&x)[size]) {
  if constexpr (n == 1) {
    return x[0];
  } else {
#pragma unroll
    for (int k = 0; k < n / 2; ++k) x[k] += x[k + n / 2];
    return tree_sum<n / 2>(x);
  }
}

// The words [0, W) of a step's row or column, this thread's share: with
// kRows the aligned 16-byte vectors covering the contiguous row (words
// outside it masked), kV a thread a round; else the strided words, kS a
// thread a round.
template <int G, bool kRows>
__device__ __forceinline__ unsigned step_share(const int* __restrict__ at, long long sw, int W,
                                               int g) {
  unsigned acc = 0;
  if (kRows) {
    constexpr int kV = 16 / G;
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(at);
    const int4* vec = reinterpret_cast<const int4*>(a0 & ~static_cast<uintptr_t>(15));
    const int off = static_cast<int>((a0 >> 2) & 3);  // words before the row in its first vector
    const int nv = (off + W + 3) >> 2;
    for (int base = 0; base < nv; base += G * kV) {
      int4 v[kV];
#pragma unroll
      for (int m = 0; m < kV; ++m) {
        const int vi = base + g + m * G;
        v[m] = vi < nv ? __ldg(vec + vi) : make_int4(0, 0, 0, 0);
      }
      unsigned part[kV];
#pragma unroll
      for (int m = 0; m < kV; ++m) {
        const unsigned w0 = static_cast<unsigned>((base + g + m * G) * 4 - off);
        const unsigned uw = static_cast<unsigned>(W);
        part[m] = (w0 < uw ? static_cast<unsigned>(v[m].x) : 0u) +
                  (w0 + 1 < uw ? static_cast<unsigned>(v[m].y) : 0u) +
                  (w0 + 2 < uw ? static_cast<unsigned>(v[m].z) : 0u) +
                  (w0 + 3 < uw ? static_cast<unsigned>(v[m].w) : 0u);
      }
      acc += tree_sum<kV>(part);
    }
  } else {
    constexpr int kS = 32 / G;
    for (int base = 0; base < W; base += G * kS) {
      unsigned v[kS];
#pragma unroll
      for (int m = 0; m < kS; ++m) {
        const int w = base + g + m * G;
        v[m] = w < W ? static_cast<unsigned>(__ldg(at + w * sw)) : 0u;
      }
      acc += tree_sum<kS>(v);
    }
  }
  return acc;
}

// Mode sum: lane l is threads [l G, (l + 1) G) of the grid.
template <int G, bool kRows>
__global__ void chain_sum_kernel(const int* __restrict__ table, long long sw, long long sx,
                                 int W, int NB, FloorMod fm, const int* __restrict__ init,
                                 const int* __restrict__ c, int Lc, int steps, int L,
                                 int* __restrict__ out) {
  const long long gt = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long l = gt / G;
  if (l >= L) return;  // the whole group
  const int g = static_cast<int>(gt % G);
  const unsigned group = G == 1 ? 1u : ((1u << G) - 1) << ((threadIdx.x & 31) & ~(G - 1));
  int state = init[l];
  assert(0 <= state && state < NB);
  const unsigned nb = static_cast<unsigned>(NB);
  unsigned tm = 0;  // t % NB
  int tc = 0;       // t % Lc
  for (int t = 0; t < steps; ++t) {
    unsigned x = static_cast<unsigned>(state) + tm;
    x = x >= nb ? x - nb : x;
    unsigned acc = step_share<G, kRows>(table + static_cast<long long>(x) * sx, sw, W, g);
#pragma unroll
    for (int off = G / 2; off > 0; off /= 2) acc += __shfl_xor_sync(group, acc, off);
    acc += static_cast<unsigned>(c[tc]);
    state = floor_mod_fast(wrap_add(state, acc), fm);
    tm = tm + 1 == nb ? 0 : tm + 1;
    tc = tc + 1 == Lc ? 0 : tc + 1;
  }
  if (g == 0) out[l] = state;
}

template <int G>
int launch_chain_sum(bool rows, const int* table, long long sw, long long sx, int W, int NB,
                     const int* init, const int* c, int Lc, int steps, int L, int* out,
                     cudaStream_t s) {
  const unsigned long long nb = static_cast<unsigned long long>(NB);
  const FloorMod fm{~0ull / nb + 1, static_cast<unsigned>(NB),
                    static_cast<unsigned>((1ull << 31) % nb)};
  const long long threads = static_cast<long long>(L) * G;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (rows) {
    chain_sum_kernel<G, true><<<grid, kThreads, 0, s>>>(table, sw, sx, W, NB, fm, init, c, Lc,
                                                        steps, L, out);
  } else {
    chain_sum_kernel<G, false><<<grid, kThreads, 0, s>>>(table, sw, sx, W, NB, fm, init, c, Lc,
                                                         steps, L, out);
  }
  return static_cast<int>(cudaGetLastError());
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

// G3 mode elem, shared form: block b serves table row w = b / tiles, lanes
// [(b % tiles) * blockDim.x, +blockDim.x) of it, one thread a lane, each
// lane's chain walked in shared memory with its state in a register.
//
// Staging (stage_row): each lane's initial state is loaded first, so that
// its latency hides behind the copies; the row's N words go to shared
// memory by cp.async, 16-byte vectors where the row is contiguous and
// 16-byte aligned, single words for the rest and for a strided or
// misaligned row, all issued before the one wait.  Each thread then turns
// the words it copied into their floor modulo N times 4, the byte offset
// each adds to a state, so that a step is x = state + e + (s mod N) (byte
// offsets, x < 3 N) and the least of x, x - N and x - 2 N that does not
// wrap below zero: one shared load, an add of three and a three-way
// minimum, with s mod N a counter that restarts every N steps.  Where N is
// a power of two (kPow2) the reduction is a shift and a mask, and a step
// ends in a mask.  The reduced step holds while no sum state + g + s passes
// INT_MAX, that is while no word g exceeds g_lim = INT_MAX - (N - 1) -
// (steps - 1); a power of two N never minds (the int32 wrap leaves the low
// bits as they are).  A row with a larger word (a block-wide vote) is
// staged again as it is and takes the exact int32 step, wrap_add and the
// floor modulo, as the direct form does.
//
// At k_d's [8, 8192] x 100 the 512 lanes of a block on each of 128 SMs
// load from shared memory in about 3.4 wavefronts a warp's load (bank
// conflicts of 32 random words), which, not the load's latency, bounds a
// step (chip_smoke.py, PERF.md).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// floor_mod(v, NB) by a 32-bit reciprocal, recip = (2^32 - 1) / NB: for u =
// v + 2^31 the quotient umulhi(u, recip) is floor(u / NB) or one less (its
// error is below u / 2^32 < 1), so u - q NB lies in [0, 2 NB) and one
// conditional subtraction (an unsigned minimum) gives u mod NB; less 2^31
// mod NB, back into [0, NB).  Exact for every int32 v and NB < 2^31, in
// 32-bit operations only.
__device__ __forceinline__ unsigned floor_mod_recip(int v, unsigned recip, const FloorMod& m) {
  const unsigned u = static_cast<unsigned>(v) ^ 0x80000000u;
  unsigned r = u - __umulhi(u, recip) * m.nb;
  r = min(r, r - m.nb) - m.bias;
  return min(r, r + m.nb);
}

// The byte offset word g adds to a state: 4 floor_mod(g, N); with kPow2 (N a
// power of two) the low bits, g & (N - 1), as a shift and a mask (mask4 = 4
// (N - 1))
template <bool kPow2>
__device__ __forceinline__ int reduced_word(int g, unsigned recip, const FloorMod& fm,
                                            unsigned mask4) {
  return static_cast<int>(kPow2 ? (static_cast<unsigned>(g) << 2) & mask4
                                : floor_mod_recip(g, recip, fm) * 4);
}

// Row w's N words into row_s: as they are (kReduced false), or reduced, with
// `wraps` set where a word exceeds g_lim (never for a power of two N, whose
// low bits the int32 wrap leaves as they are).  Every copy is issued before
// the first wait: 16-byte vectors where the row is contiguous and 16-byte
// aligned, single words (4-byte cp.async) for the rest and for a strided or
// misaligned row; each thread then reduces the words it copied.
template <bool kReduced, bool kPow2>
__device__ __forceinline__ void stage_row(const int* __restrict__ row, long long sx, int N,
                                          unsigned recip, const FloorMod& fm, unsigned mask4,
                                          int g_lim, int* row_s, bool& wraps) {
  const bool vectors = sx == 1 && (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  const int nvec = vectors ? N >> 2 : 0;
  for (int k = threadIdx.x; k < nvec; k += blockDim.x) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(row_s + 4 * k)),
                 "l"(row + 4 * k)
                 : "memory");
  }
  for (int k = 4 * nvec + threadIdx.x; k < N; k += blockDim.x) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(row_s + k)),
                 "l"(row + k * sx)
                 : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (!kReduced) return;
  int4* vec_s = reinterpret_cast<int4*>(row_s);
  for (int k = threadIdx.x; k < nvec; k += blockDim.x) {
    const int4 v = vec_s[k];
    if (!kPow2) wraps |= max(max(v.x, v.y), max(v.z, v.w)) > g_lim;
    vec_s[k] = make_int4(reduced_word<kPow2>(v.x, recip, fm, mask4),
                         reduced_word<kPow2>(v.y, recip, fm, mask4),
                         reduced_word<kPow2>(v.z, recip, fm, mask4),
                         reduced_word<kPow2>(v.w, recip, fm, mask4));
  }
  for (int k = 4 * nvec + threadIdx.x; k < N; k += blockDim.x) {
    const int g = row_s[k];
    if (!kPow2) wraps |= g > g_lim;
    row_s[k] = reduced_word<kPow2>(g, recip, fm, mask4);
  }
}

template <bool kPow2>
__global__ void chain_elem_shared_kernel(const int* __restrict__ table, long long sw,
                                         long long sx, int N, unsigned recip, FloorMod fm,
                                         int g_lim, const int* __restrict__ init, int M,
                                         int tiles, int steps, int* __restrict__ out) {
  extern __shared__ __align__(16) int row_s[];
  const int w = blockIdx.x / tiles;
  const int m = blockIdx.x % tiles * blockDim.x + threadIdx.x;
  const long long e = static_cast<long long>(w) * M + m;
  int state = m < M ? init[e] : 0;
  const int* row = table + w * sw;
  const unsigned n4 = 4u * static_cast<unsigned>(N), n8 = 2 * n4, mask4 = n4 - 4;
  bool wraps = false;
  stage_row<true, kPow2>(row, sx, N, recip, fm, mask4, g_lim, row_s, wraps);
  if (__syncthreads_or(wraps)) {  // a word near INT_MAX: the row as it is, the exact step
    stage_row<false, kPow2>(row, sx, N, recip, fm, mask4, g_lim, row_s, wraps);
    __syncthreads();
    if (m >= M) return;
    assert(0 <= state && state < N);
    for (int s = 0; s < steps; ++s) {
      const unsigned g = static_cast<unsigned>(row_s[state]);
      state = static_cast<int>(
          floor_mod_recip(wrap_add(state, g + static_cast<unsigned>(s)), recip, fm));
    }
    out[e] = state;
    return;
  }
  if (m >= M) return;
  assert(0 <= state && state < N);
  const char* base = reinterpret_cast<const char*>(row_s);
  unsigned x4 = static_cast<unsigned>(state) * 4;  // the state as a byte offset
  for (int s0 = 0; s0 < steps; s0 += N) {          // s mod N restarts at 0 every N steps
    const int run = min(steps - s0, N);
    unsigned s4 = 0;  // (s mod N) * 4
#pragma unroll 4
    for (int j = 0; j < run; ++j) {
      const unsigned x = x4 + *reinterpret_cast<const unsigned*>(base + x4) + s4;
      x4 = kPow2 ? x & mask4 : __vimin3_u32(x, x - n4, x - n8);
      s4 += 4;
    }
  }
  out[e] = static_cast<int>(x4 >> 2);
}

__device__ __forceinline__ int twice(int v) {
  return static_cast<int>(static_cast<unsigned>(v) * 2u);
}

// Thread g doubles vector g of [head, head + 4 * nvec) (x + head and out +
// head are 16-byte aligned) and the g-th element of the rest, [0, head) then
// [head + 4 * nvec, n).
__global__ void scale2_kernel(const int* __restrict__ x, long long n,
                              long long head, long long nvec,
                              int* __restrict__ out) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g < nvec) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(x + head) + g);
    __stcs(reinterpret_cast<int4*>(out + head) + g,
           make_int4(twice(a.x), twice(a.y), twice(a.z), twice(a.w)));
  }
  const long long body = 4 * nvec;
  if (g < n - body) {
    const long long e = g < head ? g : g + body;
    out[e] = twice(x[e]);
  }
}

// The launch floor: a kernel that does nothing, timed as the kernels are.
__global__ void launch_floor_kernel() {}

}  // namespace

// G1: rows of C words; 16-byte vectors where C % 4 == 0 and the plane and
// out are 16-byte aligned, else words.  The grid covers the items, one a
// thread, up to 8 blocks an SM (then each thread takes several).
extern "C" int siga_gather_rows(const void* plane, const void* idx, int R, int Q,
                                int C, void* out, void* stream) {
  if (Q <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vectors = C % 4 == 0 && reinterpret_cast<std::uintptr_t>(plane) % 16 == 0 &&
                       reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  if (vectors) {
    launch_gather_rows<uint4>(plane, idx, R, static_cast<long long>(Q) * (C / 4), C / 4, out,
                              sms, s);
  } else {
    launch_gather_rows<int>(plane, idx, R, static_cast<long long>(Q) * C, C, out, sms, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// `form` and `tile` come from gather.py's take_along_plan: tile is the threads
// a block (kAxis0, kDirect) or the output columns a block (kShared).  Axis 1
// takes a block for each (table row, tile of columns); axis 0 a grid-stride
// loop of at most kMaxBlocks blocks.
extern "C" int siga_take_along(const void* table, const void* index, int A, int B,
                               int Q, long long si0, long long si1, int axis,
                               int form, int tile, void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* ix = static_cast<const int*>(index);
  int* o = static_cast<int*>(out);
  const int tiles = Q > 0 && tile > 0 ? (Q - 1) / tile + 1 : 0;
  const long long row_blocks = static_cast<long long>(A) * tiles;
  if ((form == kAxis0) != (axis == 0) || A < 1 || B < 1 || Q < 1 || tile < 1 ||
      (form != kShared && tile > kSharedThreads) || row_blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (form) {
    case kAxis0: {
      const long long total = static_cast<long long>(Q) * B;
      const long long blocks = (total + tile - 1) / tile;
      const unsigned grid = static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
      take_along0_kernel<<<grid, tile, 0, s>>>(t, ix, A, B, total, si0, si1, o);
      break;
    }
    case kShared: {
      const int smem = B * static_cast<int>(sizeof(int));
      if (smem > kSmemDefault) {
        const cudaError_t rc = cudaFuncSetAttribute(
            take_along1_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (rc != cudaSuccess) return static_cast<int>(rc);
      }
      take_along1_kernel<true><<<static_cast<unsigned>(row_blocks), kSharedThreads, smem, s>>>(
          t, ix, B, Q, si0, si1, tile, tiles, o);
      break;
    }
    case kDirect:
      take_along1_kernel<false><<<static_cast<unsigned>(row_blocks), tile, 0, s>>>(
          t, ix, B, Q, si0, si1, tile, tiles, o);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// `group` (1, 2, 4 or 8 threads a lane) comes from gather.py's chain_plan;
// rows whose words are contiguous (sw == 1) are read as 16-byte vectors.
extern "C" int siga_gather_chain_sum(const void* table, long long sw, long long sx,
                                     int W, int NB, const void* init,
                                     const void* c, int Lc, int steps, int L, int group,
                                     void* out, void* stream) {
  if (W < 1 || NB < 1 || Lc < 1 || L < 1 || steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* t = static_cast<const int*>(table);
  const auto* i = static_cast<const int*>(init);
  const auto* cc = static_cast<const int*>(c);
  auto* o = static_cast<int*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool rows = sw == 1;
  switch (group) {
    case 1: return launch_chain_sum<1>(rows, t, sw, sx, W, NB, i, cc, Lc, steps, L, o, s);
    case 2: return launch_chain_sum<2>(rows, t, sw, sx, W, NB, i, cc, Lc, steps, L, o, s);
    case 4: return launch_chain_sum<4>(rows, t, sw, sx, W, NB, i, cc, Lc, steps, L, o, s);
    case 8: return launch_chain_sum<8>(rows, t, sw, sx, W, NB, i, cc, Lc, steps, L, o, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// `form` (kShared or kDirect) comes from gather.py's chain_elem_plan, `tile`
// (the lanes, and threads, of a shared block) from chain_elem_tile.  The
// shared form takes a block for each (table row, tile of lanes) and 4 N
// bytes of shared memory, which the card refuses past its limit; the direct
// form one thread a lane, kThreads a block.
extern "C" int siga_gather_chain_elem(const void* table, long long sw, long long sx,
                                      int W, int N, const void* init, int M,
                                      int steps, int form, int tile, void* out, void* stream) {
  if (W < 1 || N < 1 || M < 1 || steps < 0 ||
      static_cast<long long>(N) + steps >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* t = static_cast<const int*>(table);
  const auto* i = static_cast<const int*>(init);
  auto* o = static_cast<int*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (form == kDirect) {
    const long long total = static_cast<long long>(W) * M;
    const long long blocks = (total + kThreads - 1) / kThreads;
    chain_elem_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(t, sw, sx, N, i, M,
                                                                        total, steps, o);
    return static_cast<int>(cudaGetLastError());
  }
  if (form != kShared || tile < 1 || tile > kSharedThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (M - 1) / tile + 1;
  const long long blocks = static_cast<long long>(W) * tiles;
  const long long smem = 4LL * N;
  if (blocks > INT_MAX || smem > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long nb = static_cast<unsigned long long>(N);
  const FloorMod fm{~0ull / nb + 1, static_cast<unsigned>(N),
                    static_cast<unsigned>((1ull << 31) % nb)};
  const int g_lim = steps == 0 ? INT_MAX
                               : static_cast<int>(INT_MAX - (static_cast<long long>(N) - 1) -
                                                  (steps - 1));
  const auto kernel = (N & (N - 1)) == 0 ? chain_elem_shared_kernel<true>
                                          : chain_elem_shared_kernel<false>;
  if (smem > kSmemDefault) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) {
      cudaGetLastError();  // so that the next launch does not report it
      return static_cast<int>(rc);
    }
  }
  kernel<<<static_cast<unsigned>(blocks), tile, static_cast<size_t>(smem), s>>>(
      t, sw, sx, N, 0xFFFFFFFFu / static_cast<unsigned>(N), fm, g_lim, i, M, tiles, steps, o);
  return static_cast<int>(cudaGetLastError());
}

// `head` and `nvec` come from gather.py's scale2_plan; when there are
// vectors, x + head and out + head must be 16-byte aligned.  A thread for
// each vector and for each scalar.
extern "C" int siga_scale2(const void* x, long long n, long long head,
                           long long nvec, void* out, void* stream) {
  const int* xi = static_cast<const int*>(x);
  int* o = static_cast<int*>(out);
  const long long rest = n - 4 * nvec;
  const bool aligned = nvec == 0 || (reinterpret_cast<uintptr_t>(xi + head) % 16 == 0 &&
                                     reinterpret_cast<uintptr_t>(o + head) % 16 == 0);
  const long long blocks = ((nvec > rest ? nvec : rest) + kThreads - 1) / kThreads;
  if (n < 1 || head < 0 || nvec < 0 || head > rest || !aligned || blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  scale2_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(xi, n, head, nvec, o);
  return static_cast<int>(cudaGetLastError());
}

// One block of one thread that does nothing: the least a launch costs.
extern "C" int siga_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
