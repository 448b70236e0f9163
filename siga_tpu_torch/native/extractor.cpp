// Irreducible-block extraction engine (native runtime component).
//
// Replicates the semantics of the reference IrreducibleBlockListExtractor
// (reference src/overlap_builder.cpp:706-836) — lockstep right-extension
// of overlap-block groups with '$'-terminal emission, unique-extension
// continuation, and branch splitting — over MANY per-read tasks, each
// processed to completion, OpenMP-parallel across tasks.
//
// occ(c, i) is O(1): cumulative checkpoint counts every 64 symbols plus a
// popcount scan of 2-bit-packed symbol words (and a '$' bitmask plane) —
// the same layout the device occ kernel uses (ops/fm_device.py), a few ns
// per query instead of a binary search.  Each block round computes one occ
// pair reused for both ext() and updateR, like the batched Python extractor.
//
// Block record layout (int64 x 10):
//   [0..3] capped pair: lo, hi, rlo, rhi
//   [4..7] raw pair (immutable)
//   [8]    overlap length
//   [9]    align flags (bit0 query-rev, bit1 target-rev, bit2 query-comp)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int QUERYCOMP_BIT = 2;
constexpr int TARGETREV_BIT = 1;
constexpr int REC = 10;

// 64 symbols per checkpoint block: 2 x u64 symbol words (2-bit codes,
// '$' aliases A), 1 x u64 '$' bitmask, 5 x i64 cumulative counts.
constexpr int64_t OCC_SAMPLE = 64;

struct Index {
  const uint64_t* words;    // [nblocks*2]
  const uint64_t* dollars;  // [nblocks]
  const int64_t* ckpt;      // [nblocks*5]
  const int64_t* pred;      // [5]
  int64_t n;
};

static inline int64_t count2(uint64_t w, uint64_t pattern, uint64_t mask2) {
  uint64_t x = w ^ pattern;
  uint64_t matched = ~(x | (x >> 1)) & 0x5555555555555555ULL;
  return (int64_t)__builtin_popcountll(matched & mask2);
}

// inclusive occ counts of all 5 symbols at position i (occ(c, -1) == 0)
static inline void occ_all(const Index& ix, int64_t i, int64_t* out) {
  const int64_t pos = i + 1;
  const int64_t block = pos >> 6;
  const int64_t tail = pos & 63;  // 0..63
  const int64_t* base = ix.ckpt + block * 5;
  const uint64_t w0 = ix.words[block * 2];
  const uint64_t w1 = ix.words[block * 2 + 1];
  const int64_t v0 = tail < 32 ? tail : 32;
  const int64_t v1 = tail > 32 ? tail - 32 : 0;
  const uint64_t m0 = v0 == 32 ? ~0ULL : ((1ULL << (2 * v0)) - 1);
  const uint64_t m1 = v1 ? ((1ULL << (2 * v1)) - 1) : 0ULL;
  const uint64_t dmask = (tail == 64) ? ~0ULL : ((1ULL << tail) - 1);
  const int64_t nd = (int64_t)__builtin_popcountll(ix.dollars[block] & dmask);
  const uint64_t LO = 0x5555555555555555ULL;
  out[0] = base[0] + nd;
  out[1] = base[1] + count2(w0, 0ULL, m0) + count2(w1, 0ULL, m1) - nd;
  out[2] = base[2] + count2(w0, LO, m0) + count2(w1, LO, m1);
  out[3] = base[3] + count2(w0, 0xAAAAAAAAAAAAAAAAULL, m0) +
           count2(w1, 0xAAAAAAAAAAAAAAAAULL, m1);
  out[4] = base[4] + count2(w0, ~0ULL, m0) + count2(w1, ~0ULL, m1);
}

// count of symbol c at positions <= i  (occ(c, -1) == 0)
static inline int64_t occ(const Index& ix, int c, int64_t i) {
  int64_t all[5];
  occ_all(ix, i, all);
  return all[c];
}

// count of '$' at positions <= i without the 4-symbol popcount work
static inline int64_t occ_dollar(const Index& ix, int64_t i) {
  const int64_t pos = i + 1;
  const int64_t block = pos >> 6;
  const int64_t tail = pos & 63;
  const uint64_t dmask = (tail == 64) ? ~0ULL : ((1ULL << tail) - 1);
  return ix.ckpt[block * 5] +
         (int64_t)__builtin_popcountll(ix.dollars[block] & dmask);
}

struct Block {
  int64_t v[REC];
  int64_t l[5], u[5];  // cached occ counts at (rlo-1, rhi) for this round
  bool tr, qc;
};

// stable insertion sort for the tiny per-read block lists (std::stable_sort
// allocates a merge buffer per call; lists here are ~2-16 blocks)
template <typename It, typename Less>
static inline void stable_insertion_sort(It first, It last, Less less) {
  for (It i = first; i != last; ++i) {
    It j = i;
    while (j != first && less(*i, *(j - 1))) --j;
    if (j != i) {
      auto tmp = std::move(*i);
      std::move_backward(j, i, i + 1);
      *j = std::move(tmp);
    }
  }
}

static inline void fill_counts(Block& b, const Index& fwd, const Index& rev) {
  const Index& ix = b.tr ? fwd : rev;
  occ_all(ix, b.v[2] - 1, b.l);
  occ_all(ix, b.v[3], b.u);
}

static inline void ext_counts(const Block& b, int64_t* e) {
  int64_t d[5];
  for (int c = 0; c < 5; ++c) d[c] = b.u[c] - b.l[c];
  if (b.qc) {
    e[0] = d[0]; e[1] = d[4]; e[2] = d[3]; e[3] = d[2]; e[4] = d[1];
  } else {
    for (int c = 0; c < 5; ++c) e[c] = d[c];
  }
}

static const int COMP[5] = {0, 4, 3, 2, 1};

// capped.updateR(c) from cached counts; returns validity
static inline bool update_right(Block& b, int c_rank, const Index& fwd,
                                const Index& rev) {
  int cr = b.qc ? COMP[c_rank] : c_rank;
  const Index& ix = b.tr ? fwd : rev;
  int64_t below = 0;
  for (int c = 0; c < cr; ++c) below += b.u[c] - b.l[c];
  int64_t dc = b.u[cr] - b.l[cr];
  int64_t nlo = b.v[0] + below;
  int64_t nhi = nlo + dc - 1;
  b.v[0] = nlo;
  b.v[1] = nhi;
  b.v[2] = ix.pred[cr] + b.l[cr];
  b.v[3] = ix.pred[cr] + b.u[cr] - 1;
  return nhi >= nlo && nhi >= 0 && b.v[3] >= b.v[2] && b.v[3] >= 0;
}

// One task: extract irreducible blocks; returns false on substring failure.
static bool run_task(const int64_t* in_blocks, int64_t n_in, const Index& fwd,
                     const Index& rev, std::vector<int64_t>* out) {
  std::vector<Block> init(n_in);
  for (int64_t i = 0; i < n_in; ++i) {
    std::memcpy(init[i].v, in_blocks + i * REC, sizeof(init[i].v));
    init[i].tr = (init[i].v[9] >> TARGETREV_BIT) & 1;
    init[i].qc = (init[i].v[9] >> QUERYCOMP_BIT) & 1;
  }
  // stable sort by descending length
  stable_insertion_sort(init.begin(), init.end(),
                          [](const Block& a, const Block& b) { return a.v[8] > b.v[8]; });

  thread_local std::vector<std::vector<Block>> pool;
  auto acquire = [&]() {
    if (pool.empty()) return std::vector<Block>();
    auto v = std::move(pool.back());
    pool.pop_back();
    v.clear();
    return v;
  };
  std::vector<std::vector<Block>> groups;
  groups.push_back(std::move(init));

  while (!groups.empty()) {
    // refresh occ counts for every live block
    for (auto& g : groups)
      for (auto& b : g) fill_counts(b, fwd, rev);

    std::vector<std::vector<Block>> incomings;
    size_t gi = 0;
    while (gi < groups.size()) {
      std::vector<Block>& blocklist = groups[gi];
      bool erase_group = true;
      if (!blocklist.empty()) {
        int64_t top_length = blocklist[0].v[8];
        int64_t exts[5] = {0, 0, 0, 0, 0};
        for (const auto& b : blocklist) {
          if (b.v[8] != top_length) break;
          int64_t e[5];
          ext_counts(b, e);
          for (int c = 0; c < 5; ++c) exts[c] += e[c];
        }
        if (exts[0] > 0) {
          for (const auto& b : blocklist) {
            if (b.v[8] != top_length) break;
            int64_t e[5];
            ext_counts(b, e);
            if (e[0] == 0) return false;  // substring read: run rmdup first
            Block branched = b;
            update_right(branched, 0, fwd, rev);
            out->insert(out->end(), branched.v, branched.v + REC);
          }
        } else {
          for (const auto& b : blocklist) {
            if (b.v[8] < top_length) {
              int64_t e[5];
              ext_counts(b, e);
              for (int c = 0; c < 5; ++c) exts[c] += e[c];
            }
          }
          int nonzero = 0, only = -1;
          for (int c = 0; c < 5; ++c)
            if (exts[c] > 0) { ++nonzero; only = c; }
          if (nonzero == 1) {
            size_t w = 0;
            for (auto& b : blocklist)
              if (update_right(b, only, fwd, rev)) {
                if (w != (size_t)(&b - blocklist.data())) blocklist[w] = b;
                ++w;
              }
            blocklist.resize(w);
            erase_group = false;
          } else {
            for (int c = 0; c < 5; ++c) {
              if (exts[c] <= 0) continue;
              auto branched = acquire();
              branched.reserve(blocklist.size());
              for (const auto& b : blocklist) {
                Block nb = b;
                if (update_right(nb, c, fwd, rev)) branched.push_back(nb);
              }
              incomings.push_back(std::move(branched));
            }
          }
        }
      }
      if (erase_group) {
        pool.push_back(std::move(groups[gi]));
        groups.erase(groups.begin() + gi);
        gi += 1;  // reference loop skips the group after an erase
      } else {
        gi += 2;  // reference loop double-advances
      }
    }
    for (auto& g : incomings) groups.push_back(std::move(g));
  }
  return true;
}

}  // namespace

extern "C" {

// Returns total emitted int64s (n_blocks*10), or -1 if out_cap insufficient.
int64_t siga_extract_irreducible(
    int64_t n_tasks, const int64_t* task_offsets,  // [n_tasks+1]
    const int64_t* blocks,                         // [task_offsets[n_tasks]*10]
    const uint64_t* fwd_words, const uint64_t* fwd_dollars,
    const int64_t* fwd_ckpt, const int64_t* fwd_pred, int64_t fwd_n,
    const uint64_t* rev_words, const uint64_t* rev_dollars,
    const int64_t* rev_ckpt, const int64_t* rev_pred, int64_t rev_n,
    int64_t out_cap,                               // capacity in int64s
    int64_t* out_blocks,                           // [out_cap]
    int64_t* out_counts,                           // [n_tasks] blocks emitted
    uint8_t* out_failed,                           // [n_tasks]
    int64_t n_threads) {
  Index fwd{fwd_words, fwd_dollars, fwd_ckpt, fwd_pred, fwd_n};
  Index rev{rev_words, rev_dollars, rev_ckpt, rev_pred, rev_n};

  std::vector<std::vector<int64_t>> outs(n_tasks);
#ifdef _OPENMP
  if (n_threads > 0) omp_set_num_threads((int)n_threads);
#pragma omp parallel for schedule(dynamic)
#endif
  for (int64_t t = 0; t < n_tasks; ++t) {
    const int64_t* in = blocks + task_offsets[t] * REC;
    int64_t n_in = task_offsets[t + 1] - task_offsets[t];
    bool ok = run_task(in, n_in, fwd, rev, &outs[t]);
    out_failed[t] = ok ? 0 : 1;
    out_counts[t] = (int64_t)(outs[t].size() / REC);
  }

  int64_t total = 0;
  for (int64_t t = 0; t < n_tasks; ++t) total += (int64_t)outs[t].size();
  if (total > out_cap) return -1;
  int64_t off = 0;
  for (int64_t t = 0; t < n_tasks; ++t) {
    std::memcpy(out_blocks + off, outs[t].data(), outs[t].size() * sizeof(int64_t));
    off += (int64_t)outs[t].size();
  }
  return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full per-read processing: build orientation block lists from raw scan
// arrays, containment classification, submaximal filtering (reference
// SubMaximalBlockFilter, src/overlap_builder.cpp:914-1092 incl. the rare
// remap path), containment-length removal, then irreducible extraction.
// One call processes a whole chunk of reads, OpenMP-parallel.
// ---------------------------------------------------------------------------

namespace {

constexpr int AF_SP = 0b000;
constexpr int AF_SS = 0b110;
constexpr int AF_PP = 0b101;
constexpr int AF_PS = 0b011;

// BWT symbol rank at position i, from the packed planes
static inline int get_char(const Index& ix, int64_t i) {
  const int64_t block = i >> 6;
  const int64_t off = i & 63;
  if ((ix.dollars[block] >> off) & 1) return 0;
  const uint64_t w = ix.words[block * 2 + (off >> 5)];
  return (int)((w >> (2 * (off & 31))) & 3) + 1;
}

// IntervalPair::updateL(c, index): v = [lo,hi,rlo,rhi]
static inline void update_left_pair(int64_t* v, int c, const Index& index) {
  int64_t l[5], u[5];
  occ_all(index, v[0] - 1, l);
  occ_all(index, v[1], u);
  int64_t below = 0;
  for (int i = 0; i < c; ++i) below += u[i] - l[i];
  v[2] = v[2] + below;
  v[3] = v[2] + (u[c] - l[c]) - 1;
  v[0] = index.pred[c] + l[c];
  v[1] = index.pred[c] + u[c] - 1;
}

// IntervalPair::updateR(c, rindex)
static inline void update_right_pair(int64_t* v, int c, const Index& rindex) {
  int64_t l[5], u[5];
  occ_all(rindex, v[2] - 1, l);
  occ_all(rindex, v[3], u);
  int64_t below = 0;
  for (int i = 0; i < c; ++i) below += u[i] - l[i];
  v[0] = v[0] + below;
  v[1] = v[0] + (u[c] - l[c]) - 1;
  v[2] = rindex.pred[c] + l[c];
  v[3] = rindex.pred[c] + u[c] - 1;
}

// FMIndex::Interval::update on a single interval
static inline void update_interval(int64_t* lo, int64_t* hi, int c,
                                   const Index& index) {
  int64_t a = occ(index, c, *lo - 1);
  int64_t b = occ(index, c, *hi);
  *lo = index.pred[c] + a;
  *hi = index.pred[c] + b - 1;
}

static inline bool pair_valid(const int64_t* v) {
  return v[1] >= v[0] && v[1] >= 0 && v[3] >= v[2] && v[3] >= 0;
}

typedef std::vector<Block> BlockList;

static inline bool intersecting(int64_t s1, int64_t e1, int64_t s2, int64_t e2) {
  return !(s1 > e2 || s2 > e1);
}

// reference SubMaximalBlockFilter::resolve
static void resolve_blocks(const Block& x, const Block& y, const Index& fmi,
                           const Index& rfmi, BlockList* resolved) {
  const Block* higher = &x;
  const Block* lower = &y;
  if (higher->v[8] < lower->v[8]) std::swap(higher, lower);
  resolved->push_back(*higher);
  if (higher->v[8] == lower->v[8]) {
    return;  // same length implies same coordinates
  }
  if (lower->v[0] < higher->v[0] || lower->v[1] > higher->v[1]) {
    // rare remap path: map each reverse position to its forward position by
    // walking the reverse index until '$'
    std::vector<std::pair<int64_t, int64_t>> used;  // (key, next) map
    auto used_get = [&](int64_t k) -> int64_t {
      for (auto& kv : used)
        if (kv.first == k) return kv.second;
      return k;
    };
    auto used_set = [&](int64_t k, int64_t v2) {
      for (auto& kv : used)
        if (kv.first == k) { kv.second = v2; return; }
      used.emplace_back(k, v2);
    };
    std::vector<std::pair<int64_t, int64_t>> tracing;  // (forward, reverse)
    for (int64_t j = lower->v[2]; j <= lower->v[3]; ++j) {
      int64_t ranges[4] = {lower->v[4], lower->v[5], lower->v[6], lower->v[7]};
      int64_t tlo = j, thi = j;
      while (true) {
        int c = get_char(rfmi, tlo);
        bool done = (c == 0);
        if (done) update_left_pair(ranges, 0, fmi);
        update_interval(&tlo, &thi, c, rfmi);
        update_right_pair(ranges, c, rfmi);
        if (done) break;
      }
      int64_t fwd_pos;
      if (ranges[0] == ranges[1]) {
        fwd_pos = ranges[0];
      } else {
        int64_t k = ranges[0];
        int64_t idx = used_get(k);
        fwd_pos = idx;
        used_set(k, idx + 1);
      }
      tracing.emplace_back(fwd_pos, j);
    }
    for (auto& fr : tracing) {
      if (!intersecting(fr.first, fr.first, higher->v[0], higher->v[1])) {
        Block split = *lower;
        split.v[0] = fr.first;
        split.v[1] = fr.first;
        split.v[2] = fr.second;
        split.v[3] = fr.second;
        resolved->push_back(split);
      }
    }
  }
}

// reference SubMaximalBlockFilter::filter
static void submaximal_filter(BlockList* blocks, const Index& fmi,
                              const Index& rfmi) {
  if (blocks->empty()) return;
  stable_insertion_sort(blocks->begin(), blocks->end(),
                          [](const Block& a, const Block& b) { return a.v[0] < b.v[0]; });
  size_t prev = 0;
  while (prev + 1 < blocks->size()) {
    size_t curr = prev + 1;
    Block& x = (*blocks)[prev];
    Block& y = (*blocks)[curr];
    if (intersecting(x.v[0], x.v[1], y.v[0], y.v[1])) {
      BlockList resolved;
      resolve_blocks(x, y, fmi, rfmi, &resolved);
      stable_insertion_sort(resolved.begin(), resolved.end(),
                              [](const Block& a, const Block& b) { return a.v[0] < b.v[0]; });
      blocks->erase(blocks->begin() + curr);
      blocks->erase(blocks->begin() + prev);
      // stable merge keeps sorted order
      BlockList merged;
      merged.reserve(blocks->size() + resolved.size());
      size_t i = 0, j = 0;
      while (i < blocks->size() && j < resolved.size()) {
        if (resolved[j].v[0] < (*blocks)[i].v[0]) merged.push_back(resolved[j++]);
        else merged.push_back((*blocks)[i++]);
      }
      for (; i < blocks->size(); ++i) merged.push_back((*blocks)[i]);
      for (; j < resolved.size(); ++j) merged.push_back(resolved[j]);
      blocks->swap(merged);
      prev = 0;
    } else {
      ++prev;
    }
  }
}

static inline Block make_block(const int64_t* data8, int64_t length, int af) {
  Block b;
  for (int i = 0; i < 8; ++i) b.v[i] = data8[i];
  b.v[8] = length;
  b.v[9] = af;
  b.tr = (af >> TARGETREV_BIT) & 1;
  b.qc = (af >> QUERYCOMP_BIT) & 1;
  return b;
}

// Block from a raw 4-col scan record (lo, hi, rlo, rhi); the capped
// '$'-probe pair is the closed form plo = occ_$(lo-1), phi = occ_$(hi)-1,
// prlo = rlo, prhi = rlo + psize - 1 (ops/search.py::_with_probe moved
// native so the Python hot path skips a per-chunk searchsorted pass).
static inline Block make_block4(const int64_t* d4, int64_t length, int af,
                                const Index& own) {
  Block b;
  const int64_t l0 = occ_dollar(own, d4[0] - 1);
  const int64_t u0 = occ_dollar(own, d4[1]);
  b.v[0] = l0;
  b.v[1] = u0 - 1;
  b.v[2] = d4[2];
  b.v[3] = d4[2] + (u0 - l0) - 1;
  for (int i = 0; i < 4; ++i) b.v[4 + i] = d4[i];
  b.v[8] = length;
  b.v[9] = af;
  b.tr = (af >> TARGETREV_BIT) & 1;
  b.qc = (af >> QUERYCOMP_BIT) & 1;
  return b;
}

struct ScanLane {
  const int64_t* t;      // block t values (sorted per lane)
  const int64_t* data;   // block 8-int records
  int64_t begin, end;    // block index range for this lane
};

// containment classification for one lane; returns true if a contain block
// was produced in *out
static bool containment_for_lane(const int64_t* final8, uint8_t lext_has_dna,
                                 int64_t seqlen, int af, const Index& other,
                                 bool* substring, Block* out,
                                 int lext_precomputed) {
  if (lext_has_dna) { *substring = true; return false; }
  if (!lext_precomputed) {
    // lext flag covers only the own-index half; check the other index's
    // right-extension here
    int64_t l[5], u[5];
    occ_all(other, final8[2] - 1, l);
    occ_all(other, final8[3], u);
    int64_t dna = 0;
    for (int c = 1; c < 5; ++c) dna += (u[c] - l[c]);
    if (dna > 0) { *substring = true; return false; }
  }
  int64_t probe[4] = {final8[4], final8[5], final8[6], final8[7]};
  if (!pair_valid(probe)) return false;
  update_right_pair(probe, 0, other);
  Block b;
  b.v[0] = probe[0]; b.v[1] = probe[1]; b.v[2] = probe[2]; b.v[3] = probe[3];
  b.v[4] = final8[0]; b.v[5] = final8[1]; b.v[6] = final8[2]; b.v[7] = final8[3];
  b.v[8] = seqlen;
  b.v[9] = af;
  b.tr = (af >> TARGETREV_BIT) & 1;
  b.qc = (af >> QUERYCOMP_BIT) & 1;
  *out = b;
  return true;
}

}  // namespace

extern "C" {

// Process a chunk of reads end-to-end (stages B+C).  Block data arrives as
// raw 4-col records (lo, hi, rlo, rhi); the capped '$'-probe pair derives
// in make_block4.  Returns total emitted int64s or -1 if out_cap
// insufficient.
int64_t siga_process_chunk(
    int64_t n_reads, const int64_t* read_lens, int rc, int irreducible,
    // lext_precomputed: the per-lane lext flags already include the other
    // index's rext half (full substring flags computed device-side)
    int lext_precomputed,
    int64_t lane_stride,
    // fwd scanner arrays (lanes: [0..n) SP, [stride..stride+n) PP)
    const int64_t* f_starts,  // [2*lane_stride+1] block range per lane
    const int64_t* f_t, const int64_t* f_data,
    const int64_t* f_final, const uint8_t* f_lext,
    // rev scanner arrays (lanes: PS, SS)
    const int64_t* r_starts, const int64_t* r_t, const int64_t* r_data,
    const int64_t* r_final, const uint8_t* r_lext,
    // indexes
    const uint64_t* fwd_words, const uint64_t* fwd_dollars,
    const int64_t* fwd_ckpt, const int64_t* fwd_pred, int64_t fwd_n,
    const uint64_t* rev_words, const uint64_t* rev_dollars,
    const int64_t* rev_ckpt, const int64_t* rev_pred, int64_t rev_n,
    // outputs
    int64_t out_cap, int64_t* out_blocks, int64_t* out_counts,
    uint8_t* out_substring, uint8_t* out_failed, int64_t n_threads) {
  Index fwd{fwd_words, fwd_dollars, fwd_ckpt, fwd_pred, fwd_n};
  Index rev{rev_words, rev_dollars, rev_ckpt, rev_pred, rev_n};

  std::vector<std::vector<int64_t>> outs(n_reads);
#ifdef _OPENMP
  if (n_threads > 0) omp_set_num_threads((int)n_threads);
#pragma omp parallel for schedule(dynamic)
#endif
  for (int64_t k = 0; k < n_reads; ++k) {
    int64_t seqlen = read_lens[k];
    bool substring = false;
    // reused per-thread lists: fresh vectors per read cost ~6 allocs/read
    thread_local BlockList suffixfwd, suffixrev, prefixfwd, prefixrev,
        containfwd, containrev;
    suffixfwd.clear(); suffixrev.clear(); prefixfwd.clear();
    prefixrev.clear(); containfwd.clear(); containrev.clear();

    auto load_lane = [&](const int64_t* starts, const int64_t* t,
                         const int64_t* data, int64_t lane, int af,
                         const Index& own, BlockList* out_list) {
      for (int64_t i = starts[lane]; i < starts[lane + 1]; ++i)
        out_list->push_back(make_block4(data + i * 4, t[i] + 1, af, own));
    };
    load_lane(f_starts, f_t, f_data, k, AF_SP, fwd, &suffixfwd);
    load_lane(r_starts, r_t, r_data, k, AF_PS, rev, &prefixrev);
    if (rc) {
      load_lane(f_starts, f_t, f_data, lane_stride + k, AF_PP, fwd, &prefixfwd);
      load_lane(r_starts, r_t, r_data, lane_stride + k, AF_SS, rev, &suffixrev);
    }

    Block cb;
    // containment order: SP, PP -> containfwd; PS, SS -> containrev
    if (containment_for_lane(f_final + k * 8, f_lext[k], seqlen, AF_SP, rev,
                             &substring, &cb, lext_precomputed))
      containfwd.push_back(cb);
    if (rc && containment_for_lane(f_final + (lane_stride + k) * 8,
                                   f_lext[lane_stride + k], seqlen, AF_PP, rev,
                                   &substring, &cb, lext_precomputed))
      containfwd.push_back(cb);
    if (containment_for_lane(r_final + k * 8, r_lext[k], seqlen, AF_PS, fwd,
                             &substring, &cb, lext_precomputed))
      containrev.push_back(cb);
    if (rc && containment_for_lane(r_final + (lane_stride + k) * 8,
                                   r_lext[lane_stride + k], seqlen, AF_SS, fwd,
                                   &substring, &cb, lext_precomputed))
      containrev.push_back(cb);

    // stage B: copy containments in, filter, drop full-length blocks
    for (const auto& b : containfwd) { suffixfwd.push_back(b); prefixfwd.push_back(b); }
    for (const auto& b : containrev) { suffixrev.push_back(b); prefixrev.push_back(b); }
    submaximal_filter(&suffixfwd, fwd, rev);
    submaximal_filter(&prefixfwd, fwd, rev);
    submaximal_filter(&suffixrev, rev, fwd);
    submaximal_filter(&prefixrev, rev, fwd);
    auto drop_full = [&](BlockList* l) {
      l->erase(std::remove_if(l->begin(), l->end(),
                              [&](const Block& b) { return b.v[8] == seqlen; }),
               l->end());
    };
    drop_full(&suffixfwd);
    drop_full(&prefixfwd);
    drop_full(&suffixrev);
    drop_full(&prefixrev);

    std::vector<int64_t>& out = outs[k];
    for (const auto& b : containfwd) out.insert(out.end(), b.v, b.v + REC);
    for (const auto& b : containrev) out.insert(out.end(), b.v, b.v + REC);

    // join suffix/prefix lists
    for (const auto& b : suffixrev) suffixfwd.push_back(b);
    for (const auto& b : prefixrev) prefixfwd.push_back(b);

    bool failed = false;
    if (irreducible) {
      auto run_list = [&](BlockList& list) {
        thread_local std::vector<int64_t> flat;
        flat.resize(list.size() * REC);
        for (size_t i = 0; i < list.size(); ++i)
          std::memcpy(flat.data() + i * REC, list[i].v, sizeof(list[i].v));
        if (!run_task(flat.data(), (int64_t)list.size(), fwd, rev, &out))
          failed = true;
      };
      run_list(suffixfwd);
      run_list(prefixfwd);
    } else {
      for (const auto& b : suffixfwd) out.insert(out.end(), b.v, b.v + REC);
      for (const auto& b : prefixfwd) out.insert(out.end(), b.v, b.v + REC);
    }
    out_substring[k] = substring ? 1 : 0;
    out_failed[k] = failed ? 1 : 0;
    out_counts[k] = (int64_t)(out.size() / REC);
  }

  int64_t total = 0;
  for (int64_t k = 0; k < n_reads; ++k) total += (int64_t)outs[k].size();
  if (total > out_cap) return -1;
  int64_t off = 0;
  for (int64_t k = 0; k < n_reads; ++k) {
    std::memcpy(out_blocks + off, outs[k].data(), outs[k].size() * sizeof(int64_t));
    off += (int64_t)outs[k].size();
  }
  return total;
}

// Text serialization of hit records (the .hits.gz lines the Python
// Hit.serialize writes, overlap/builder.py): one line per read,
// "idx substring nblocks " then per block 9 ints + a 3-char binary af,
// every token followed by one space, '\n' terminated.  Python string
// formatting of ~50k blocks/chunk costs ~85 ms on this host; this is <5 ms.
static inline char* fmt_i64(char* p, int64_t v) {
  if (v < 0) { *p++ = '-'; v = -v; }
  char tmp[20];
  int n = 0;
  do { tmp[n++] = (char)('0' + (v % 10)); v /= 10; } while (v);
  while (n) *p++ = tmp[--n];
  return p;
}

int64_t siga_format_hits(
    int64_t n_reads, const int64_t* idxs, const uint8_t* substring,
    const int64_t* counts, const int64_t* blocks,
    int64_t out_cap, char* out, int64_t* line_offsets) {
  // worst case ~21 bytes/token: header 3 tokens + 10 tokens/block
  int64_t total_blocks = 0;
  for (int64_t k = 0; k < n_reads; ++k) total_blocks += counts[k];
  const int64_t worst = n_reads * (3 * 21 + 2) + total_blocks * 10 * 21;
  if (worst > out_cap) return -1;
  char* p = out;
  const int64_t* b = blocks;
  for (int64_t k = 0; k < n_reads; ++k) {
    line_offsets[k] = (int64_t)(p - out);
    p = fmt_i64(p, idxs[k]); *p++ = ' ';
    *p++ = substring[k] ? '1' : '0'; *p++ = ' ';
    p = fmt_i64(p, counts[k]); *p++ = ' ';
    for (int64_t j = 0; j < counts[k]; ++j, b += REC) {
      for (int c = 0; c < 9; ++c) { p = fmt_i64(p, b[c]); *p++ = ' '; }
      const int64_t af = b[9];
      *p++ = (char)('0' + ((af >> 2) & 1));
      *p++ = (char)('0' + ((af >> 1) & 1));
      *p++ = (char)('0' + (af & 1));
      *p++ = ' ';
    }
    *p++ = '\n';
  }
  line_offsets[n_reads] = (int64_t)(p - out);
  return (int64_t)(p - out);
}

// Build the native occ planes from raw BWT rank codes in one pass
// (replaces a ~0.5 s/10Mchar numpy packing on the `siga overlap` path).
// words: u64[nblocks*2], dollars: u64[nblocks], ckpt: i64[nblocks*5].
void siga_pack_planes(const uint8_t* codes, int64_t n, uint64_t* words,
                      uint64_t* dollars, int64_t* ckpt) {
  const int64_t nblocks = n / OCC_SAMPLE + 1;
  int64_t running[5] = {0, 0, 0, 0, 0};
  for (int64_t b = 0; b < nblocks; ++b) {
    for (int c = 0; c < 5; ++c) ckpt[b * 5 + c] = running[c];
    uint64_t w0 = 0, w1 = 0, d = 0;
    const int64_t base = b * OCC_SAMPLE;
    const int64_t lim = std::min(n - base, OCC_SAMPLE);
    for (int64_t j = 0; j < lim; ++j) {
      const uint8_t s = codes[base + j];
      ++running[s];
      const uint64_t two = s == 0 ? 0 : (uint64_t)(s - 1);
      if (j < 32) w0 |= two << (2 * j);
      else        w1 |= two << (2 * (j - 32));
      if (s == 0) d |= 1ULL << j;
    }
    words[b * 2] = w0;
    words[b * 2 + 1] = w1;
    dollars[b] = d;
  }
}

// Build the pair-step device plane (ops/fm_device.py layout: 8 cur-symbol
// u32 words | 8 prev words | 8 cur-'$' even-bit words | 8 prev-'$' words |
// 25 exclusive pair checkpoints) for sample=128 blocks, plus the K table
// K[c2][c1] = C(c2) + occ_{c2}(C(c1)-1).  One LF pass + one block pass —
// the numpy version cost ~0.3 s / 10 Mchar on the overlap load path.
// plane: i32[nblocks*57]; K: i64[25].  nblocks = n/128 + 1.
void siga_pack_pair_plane(const uint8_t* codes, int64_t n, int32_t* plane,
                          int64_t* K) {
  constexpr int64_t S = 128;
  constexpr int COLS = 57;
  const int64_t nblocks = n / S + 1;
  int64_t totals[5] = {0, 0, 0, 0, 0};
  for (int64_t i = 0; i < n; ++i) ++totals[codes[i]];
  int64_t pred[5], cursor[5];
  pred[0] = 0;
  for (int c = 1; c < 5; ++c) pred[c] = pred[c - 1] + totals[c - 1];
  for (int c = 0; c < 5; ++c) cursor[c] = pred[c];
  // prev[r] = codes[LF(r)] via counting cursors ('$' rows never queried)
  std::vector<uint8_t> prev(n);
  {
    std::vector<int64_t> lf(n);
    for (int64_t i = 0; i < n; ++i) lf[i] = cursor[codes[i]]++;
    for (int64_t i = 0; i < n; ++i)
      prev[i] = codes[i] == 0 ? 0 : codes[lf[i]];
  }
  // K[c2*5+c1] = pred[c2] + occ_{c2}(pred[c1]-1): snapshot running single
  // counts at the 5 C-boundaries (pred[] is ascending)
  {
    int64_t run[5] = {0, 0, 0, 0, 0};
    int64_t occ_at[5][5];
    int bi = 0;
    for (int64_t i = 0; i <= n; ++i) {
      while (bi < 5 && pred[bi] == i) {
        for (int c = 0; c < 5; ++c) occ_at[bi][c] = run[c];
        ++bi;
      }
      if (i < n) ++run[codes[i]];
    }
    while (bi < 5) {
      for (int c = 0; c < 5; ++c) occ_at[bi][c] = run[c];
      ++bi;
    }
    for (int c2 = 0; c2 < 5; ++c2)
      for (int c1 = 0; c1 < 5; ++c1)
        K[c2 * 5 + c1] = pred[c2] + occ_at[c1][c2];
  }
  int64_t pair_run[25] = {0};
  for (int64_t b = 0; b < nblocks; ++b) {
    int32_t* row = plane + b * COLS;
    for (int p = 0; p < 25; ++p) row[32 + p] = (int32_t)pair_run[p];
    uint32_t curw[8] = {0}, prevw[8] = {0}, curd[8] = {0}, prevd[8] = {0};
    const int64_t base = b * S;
    const int64_t lim = std::min(n - base, S);
    for (int64_t j = 0; j < lim; ++j) {
      const uint8_t c = codes[base + j];
      const uint8_t p = prev[base + j];
      ++pair_run[(int)p * 5 + c];
      const int w = (int)(j >> 4);
      const int sh = 2 * ((int)j & 15);
      curw[w] |= (uint32_t)(c == 0 ? 0 : c - 1) << sh;
      prevw[w] |= (uint32_t)(p == 0 ? 0 : p - 1) << sh;
      if (c == 0) curd[w] |= 1u << sh;
      if (p == 0) prevd[w] |= 1u << sh;
    }
    // pad positions read as '$' (matches the numpy zero-padding; always
    // masked out by the tail mask at query time)
    for (int64_t j = std::max<int64_t>(lim, 0); j < S; ++j) {
      curd[j >> 4] |= 1u << (2 * ((int)j & 15));
      prevd[j >> 4] |= 1u << (2 * ((int)j & 15));
    }
    for (int w = 0; w < 8; ++w) {
      row[w] = (int32_t)curw[w];
      row[8 + w] = (int32_t)prevw[w];
      row[16 + w] = (int32_t)curd[w];
      row[24 + w] = (int32_t)prevd[w];
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host suffix-array builder for texts beyond the single-device program limit
// (E. coli-scale indexes).  Same order as the device builder
// (index/sa.py::_sa_build_v3): rank by the first 64 symbols in one sort
// ('$'-masked 2-bit packing, sentinel-distance tiebreak, then text position),
// then global prefix-doubling rounds that only re-sort still-tied groups —
// at short-read coverage almost everything resolves in the seed, so the
// doubling rounds touch a tiny fraction of suffixes.
// ---------------------------------------------------------------------------

#include <parallel/algorithm>

namespace {
struct SeedRec {
  uint64_t k0, k1, tail;  // tail = sentpos<<57 | idx
  bool operator<(const SeedRec& o) const {
    if (k0 != o.k0) return k0 < o.k0;
    if (k1 != o.k1) return k1 < o.k1;
    return tail < o.tail;
  }
};
}  // namespace

extern "C" {

void siga_build_sa(const uint8_t* codes, int64_t n, int64_t* sa_out) {
  if (n <= 0) return;
  if (n == 1) { sa_out[0] = 0; return; }
  const int64_t n16 = (n + 15) / 16;
  // 16-symbol packed words, big-endian within word ('$' packs as 0)
  std::vector<uint32_t> w16(n16 + 5, 0);
  for (int64_t b = 0; b < n16; ++b) {
    uint32_t w = 0;
    const int64_t base = b * 16;
    const int64_t lim = std::min<int64_t>(n - base, 16);
    for (int64_t j = 0; j < lim; ++j) {
      const uint8_t c = codes[base + j];
      w |= (uint32_t)(c == 0 ? 0 : c - 1) << (30 - 2 * j);
    }
    w16[b] = w;
  }
  // sentinel distance capped at 64
  std::vector<SeedRec> rec(n);
  {
    int64_t next_s = n + 64;
    for (int64_t i = n - 1; i >= 0; --i) {
      if (codes[i] == 0) next_s = i;
      const int64_t sp = std::min<int64_t>(next_s - i, 64);
      const int64_t blk = i / 16;
      const uint32_t o = (uint32_t)(i & 15);
      uint64_t ks[4];
      for (int j = 0; j < 4; ++j) {
        const uint32_t wa = w16[blk + j];
        const uint32_t wb = w16[blk + j + 1];
        uint32_t w = o == 0 ? wa : ((wa << (2 * o)) | (wb >> (32 - 2 * o)));
        const int64_t vj = std::max<int64_t>(
            0, std::min<int64_t>(sp - 16 * j, 16));
        const uint32_t mask =
            vj == 0 ? 0u
                    : (vj == 16 ? 0xFFFFFFFFu
                                : (0xFFFFFFFFu << (32 - 2 * vj)));
        ks[j] = w & mask;
      }
      rec[i].k0 = (ks[0] << 32) | ks[1];
      rec[i].k1 = (ks[2] << 32) | ks[3];
      rec[i].tail = ((uint64_t)sp << 57) | (uint64_t)i;
    }
  }
  __gnu_parallel::sort(rec.begin(), rec.end());

  // seed ranks: run-start position for ties (only sentpos==64 runs can tie)
  std::vector<int64_t> rank(n);
  std::vector<std::pair<int64_t, int64_t>> groups;  // unresolved [start, len)
  {
    int64_t i = 0;
    while (i < n) {
      int64_t j = i + 1;
      const int64_t sp_i = (int64_t)(rec[i].tail >> 57);
      if (sp_i == 64) {
        while (j < n && rec[j].k0 == rec[i].k0 && rec[j].k1 == rec[i].k1 &&
               (int64_t)(rec[j].tail >> 57) == 64)
          ++j;
      }
      for (int64_t k = i; k < j; ++k)
        rank[rec[k].tail & ((1ULL << 57) - 1)] = i;
      if (j - i > 1) groups.emplace_back(i, j - i);
      i = j;
    }
  }
  std::vector<int64_t> sa(n);
  for (int64_t i = 0; i < n; ++i) sa[i] = (int64_t)(rec[i].tail & ((1ULL << 57) - 1));
  rec.clear();
  rec.shrink_to_fit();

  // global doubling rounds over the still-tied groups only.  Ranks are
  // frozen for the whole round: each group's keys are computed once, used
  // for both the sort and the subrun split, and the rank updates are
  // buffered and applied after every group is processed (an in-place
  // update would leak refined ranks into later groups' keys mid-round).
  int64_t h = 64;
  std::vector<std::pair<int64_t, int64_t>> next_groups;
  std::vector<std::pair<int64_t, int64_t>> tmp;        // (key2, idx)
  std::vector<std::pair<int64_t, int64_t>> rank_upd;   // (text idx, rank)
  while (!groups.empty()) {
    next_groups.clear();
    rank_upd.clear();
    for (const auto& g : groups) {
      const int64_t s = g.first, len = g.second;
      tmp.resize(len);
      for (int64_t k = 0; k < len; ++k) {
        const int64_t idx = sa[s + k];
        tmp[k] = {idx + h < n ? rank[idx + h] : -1, idx};
      }
      std::sort(tmp.begin(), tmp.end());
      int64_t k = 0;
      while (k < len) {
        int64_t j = k + 1;
        while (j < len && tmp[j].first == tmp[k].first) ++j;
        for (int64_t m = k; m < j; ++m) {
          sa[s + m] = tmp[m].second;
          rank_upd.emplace_back(tmp[m].second, s + k);
        }
        if (j - k > 1) next_groups.emplace_back(s + k, j - k);
        k = j;
      }
    }
    for (const auto& u : rank_upd) rank[u.first] = u.second;
    groups.swap(next_groups);
    h *= 2;
  }
  std::memcpy(sa_out, sa.data(), sizeof(int64_t) * n);
}

}  // extern "C"
