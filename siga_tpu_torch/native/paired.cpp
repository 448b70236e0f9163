// Native PairedReadVisitor core: the per-vertex bounded BFS + link table +
// confirmation loop of pe-mode=1 assembly.
//
// Mirrors graph/visitors.py::PairedReadVisitor (itself a port of
// reference src/bigraph_visitors.cpp:669-969) and
// graph/search.py::build (reference src/bigraph_search.cpp:8-110)
// exactly — same queue order, truncation rules, visited keys, stable sorts
// and link emission order — so the Python object-graph implementation stays
// the differential oracle (tests/test_assemble_pe.py, test_paired_native).
// The reference threads this same loop via parallel::foreach
// (src/bigraph_visitors.cpp:894-914); here phase 1 (read-only per-vertex
// BFS) runs under OpenMP and phase 2 (order-sensitive link table) is
// serial, preserving sequential semantics.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <unordered_set>
#include <algorithm>
#include <vector>

namespace {

struct Attr {
  int64_t distance;
  int8_t dir;   // 0 = ED_SENSE, 1 = ED_ANTISENSE
  int8_t comp;  // 0 = EC_SAME, 1 = EC_REVERSE
};

static inline Attr attr_twin(const Attr& a) {
  Attr o = a;
  if (a.comp == 0) o.dir = (int8_t)(1 - a.dir);
  return o;
}

static inline Attr attr_link2(const Attr& e1, const Attr& e2) {
  Attr e;
  e.distance = e2.distance - e1.distance;
  e.dir = (e1.comp == 0) ? e1.dir : (int8_t)(1 - e1.dir);
  Attr t1 = attr_twin(e1), t2 = attr_twin(e2);
  e.comp = (t1.dir == t2.dir) ? 0 : 1;
  return e;
}

static inline Attr attr_link1(const Attr& e1) {
  Attr e0{0, (int8_t)(e1.distance < 0 ? 1 : 0), 0};
  return attr_link2(e0, e1);
}

static inline bool diff_dir(const Attr& a, const Attr& b) {
  return (a.distance < 0 || b.distance < 0) &&
         (a.distance >= 0 || b.distance >= 0);
}

struct Graph {
  int64_t nv;
  const uint8_t* seq;
  const int64_t* soff;
  const int64_t* eptr;
  const int32_t* eend;
  const uint8_t* edir;
  const uint8_t* ecomp;
  const int32_t* edist;
  const uint8_t* eext;
  const int32_t* mate;

  inline int64_t len(int32_t v) const { return soff[v + 1] - soff[v]; }
  inline const uint8_t* s(int32_t v) const { return seq + soff[v]; }
};

static inline uint8_t complement(uint8_t c) {
  switch (c) {
    case 'A': return 'T';
    case 'C': return 'G';
    case 'G': return 'C';
    case 'T': return 'A';
    case 'a': return 't';
    case 'c': return 'g';
    case 'g': return 'c';
    case 't': return 'a';
    default: return c;
  }
}

// seq2' = comp ? reverse_complement(seq2) : seq2, accessed lazily
static inline uint8_t at2(const Graph& g, int32_t v2, int64_t j, bool rc) {
  const uint8_t* p = g.s(v2);
  int64_t n = g.len(v2);
  return rc ? complement(p[n - 1 - j]) : p[j];
}

static bool has_link(const Graph& g, int32_t v1, int32_t v2, int64_t distance,
                     int dir, int comp) {
  if (distance < 0) {
    if (comp == 0) return has_link(g, v2, v1, -distance, 1 - dir, comp);
    return has_link(g, v2, v1, -distance, dir, comp);
  }
  int64_t n1 = g.len(v1), n2 = g.len(v2);
  bool rc = comp == 1;
  if (dir == 0) {
    // seq2'.startswith(seq1[distance:])
    if (distance >= n1) return false;
    int64_t m = n1 - distance;
    if (n2 < m) return false;
    const uint8_t* p1 = g.s(v1) + distance;
    for (int64_t j = 0; j < m; ++j)
      if (at2(g, v2, j, rc) != p1[j]) return false;
    return true;
  }
  // dir == ANTISENSE: seq1.startswith(seq2'[distance:])
  if (distance >= n2) return false;
  int64_t m = n2 - distance;
  if (n1 < m) return false;
  const uint8_t* p1 = g.s(v1);
  for (int64_t j = 0; j < m; ++j)
    if (p1[j] != at2(g, v2, distance + j, rc)) return false;
  return true;
}

static bool has_link_pair(const Graph& g, int32_t v1, Attr e1, int32_t v2,
                          Attr e2) {
  int64_t a1 = e1.distance < 0 ? -e1.distance : e1.distance;
  int64_t a2 = e2.distance < 0 ? -e2.distance : e2.distance;
  if (a1 > a2) return has_link_pair(g, v2, e2, v1, e1);
  Attr e = attr_link2(e1, e2);
  return has_link(g, v1, v2, e.distance, e.dir, e.comp);
}

struct QNode {
  int32_t v;
  int64_t d;
  int8_t dir;
  int8_t comp;
  int8_t flag;  // +1 / -1, fixed by the initial edge
};

enum FilterMode { FILTER_EXT = 0, FILTER_DIR = 1 };

// Reusable open-addressing visited set: BFS visited sets are tiny
// (<= queue cap ~5*max_distance), so a pow2 probe table reused across the
// millions of per-vertex BFS calls beats a fresh unordered_set each time.
struct VisitedSet {
  std::vector<int64_t> slots;
  std::vector<uint32_t> stamp;
  uint32_t gen = 0;
  size_t mask = 0;

  void begin(size_t expect) {
    size_t want = 64;
    while (want < expect * 2) want <<= 1;
    if (slots.size() < want) {
      slots.assign(want, 0);
      stamp.assign(want, 0);
      gen = 0;
    }
    mask = slots.size() - 1;
    if (++gen == 0) {  // stamp wrap: clear once per 4G generations
      std::fill(stamp.begin(), stamp.end(), 0u);
      gen = 1;
    }
  }

  bool insert(int64_t key) {
    size_t h = (size_t)((uint64_t)key * 0x9E3779B97F4A7C15ull) & mask;
    for (;;) {
      if (stamp[h] != gen) {
        stamp[h] = gen;
        slots[h] = key;
        return true;
      }
      if (slots[h] == key) return false;
      h = (h + 1) & mask;
    }
  }
};

// graph/search.py::build — identical queue order and truncation rules
static int bfs(const Graph& g, int32_t start, FilterMode fmode,
               int filter_dir, int32_t end, int64_t min_distance,
               int64_t max_distance, int max_nodes,
               std::vector<QNode>& queue, VisitedSet& visited,
               std::vector<QNode>& leaves) {
  queue.clear();
  for (int64_t e = g.eptr[start]; e < g.eptr[start + 1]; ++e) {
    int8_t flag = g.edir[e] == 0 ? 1 : -1;
    bool pass = fmode == FILTER_EXT ? (g.eext[e] != 0)
                                    : ((int)g.edir[e] == filter_dir);
    if (pass)
      queue.push_back({g.eend[e], (int64_t)flag * g.edist[e],
                       (int8_t)g.edir[e], (int8_t)g.ecomp[e], flag});
  }
  int num = 0;
  visited.begin((size_t)(5 * max_distance + 16));
  size_t qi = 0;
  while (qi < queue.size() && num < max_nodes &&
         (int64_t)(queue.size() - qi) < 5 * max_distance) {
    QNode node = queue[qi++];
    int64_t key = ((int64_t)node.v << 32) ^ (uint32_t)(int32_t)node.d;
    if (!visited.insert(key)) continue;
    int64_t ad = node.d < 0 ? -node.d : node.d;
    if (ad < max_distance) {
      if (ad >= min_distance) {
        if (end < 0) {
          if (node.d != 0) {
            ++num;
            leaves.push_back(node);
          }
        } else if (end == node.v) {
          ++num;
          leaves.push_back(node);
          break;
        }
      }
      int dir = node.dir;
      if (node.comp == 1) dir = 1 - dir;
      for (int64_t e = g.eptr[node.v]; e < g.eptr[node.v + 1]; ++e) {
        if ((int)g.edir[e] == dir)
          queue.push_back({g.eend[e], node.d + (int64_t)node.flag * g.edist[e],
                           (int8_t)dir, (int8_t)g.ecomp[e], node.flag});
      }
    }
  }
  return num;
}

// PairedReadVisitor._process; scratch buffers are per-thread and reused
struct Scratch {
  std::vector<QNode> queue, adjacents, far;
  VisitedSet visited;
};

static void process_vertex(const Graph& g, int32_t v1, int64_t max_distance,
                           int max_nodes, int64_t insert_delta, Scratch& sc,
                           std::vector<QNode>& linklist) {
  int32_t pv1 = g.mate[v1];
  if (pv1 < 0) return;
  sc.adjacents.clear();
  if (g.len(v1) > max_distance)
    bfs(g, v1, FILTER_EXT, 0, -1, 0, max_distance, max_nodes, sc.queue,
        sc.visited, sc.adjacents);
  std::stable_sort(sc.adjacents.begin(), sc.adjacents.end(),
                   [](const QNode& a, const QNode& b) {
                     return std::llabs(a.d) < std::llabs(b.d);
                   });
  for (const QNode& node1 : sc.adjacents) {
    int32_t pv2 = g.mate[node1.v];
    if (pv2 < 0) continue;
    sc.far.clear();
    for (int dir = 0; dir < 2 && sc.far.empty(); ++dir)
      bfs(g, pv1, FILTER_DIR, dir, pv2, 0,
          std::llabs(node1.d) + insert_delta * 4, 1, sc.queue, sc.visited,
          sc.far);
    for (size_t k = 0; k < sc.far.size(); ++k) linklist.push_back(node1);
  }
  std::stable_sort(linklist.begin(), linklist.end(),
                   [](const QNode& a, const QNode& b) {
                     return std::llabs(a.d) < std::llabs(b.d);
                   });
}

struct LinkTable {
  struct Entry {
    int32_t v1, v2;
    Attr a;
  };
  std::vector<Entry> entries;
  std::unordered_map<int64_t, size_t> pos;
  std::vector<int32_t> v1_order;                      // first-insertion order
  std::unordered_map<int32_t, std::vector<size_t>> per_v1;

  void add(int32_t v1, int32_t v2, Attr e) {
    if (e.distance < 0) {
      Attr t = attr_twin(e);
      t.distance = -t.distance;
      add(v2, v1, t);
      return;
    }
    int64_t key = ((int64_t)v1 << 32) | (uint32_t)v2;
    auto it = pos.find(key);
    if (it == pos.end()) {
      pos.emplace(key, entries.size());
      auto pit = per_v1.find(v1);
      if (pit == per_v1.end()) {
        v1_order.push_back(v1);
        per_v1[v1].push_back(entries.size());
      } else {
        pit->second.push_back(entries.size());
      }
      entries.push_back({v1, v2, e});
    } else if (entries[it->second].a.distance > e.distance) {
      entries[it->second].a = e;
    }
  }
};

}  // namespace

extern "C" {

// Returns the number of confirmed create-edge rows; rows are written to a
// malloc'd int64 buffer [n * 5]: v1, v2, distance, dir, comp (free with
// siga_paired_free).
int64_t siga_paired_links(
    int64_t nv, const uint8_t* seq, const int64_t* soff, const int64_t* eptr,
    const int32_t* eend, const uint8_t* edir, const uint8_t* ecomp,
    const int32_t* edist, const uint8_t* eext, const int32_t* mate,
    const int32_t* order, int64_t n_order, int64_t max_distance,
    int64_t max_nodes, int64_t insert_delta, int64_t threads,
    int64_t** out_rows) {
  Graph g{nv, seq, soff, eptr, eend, edir, ecomp, edist, eext, mate};

  // phase 1: per-vertex BFS (read-only, parallel)
  std::vector<std::vector<QNode>> linklists(n_order);
#pragma omp parallel num_threads(threads > 0 ? (int)threads : 2)
  {
    Scratch sc;
#pragma omp for schedule(dynamic, 64)
    for (int64_t i = 0; i < n_order; ++i)
      process_vertex(g, order[i], max_distance, (int)max_nodes, insert_delta,
                     sc, linklists[i]);
  }

  // phase 2: link table in visit order (sequential semantics)
  LinkTable tbl;
  for (int64_t i = 0; i < n_order; ++i) {
    int32_t v1 = order[i];
    auto& ll = linklists[i];
    for (size_t a = 0; a < ll.size(); ++a) {
      Attr xa{ll[a].d, ll[a].dir, ll[a].comp};
      tbl.add(v1, ll[a].v, attr_link1(xa));
      for (size_t b = a + 1; b < ll.size(); ++b) {
        Attr xb{ll[b].d, ll[b].dir, ll[b].comp};
        if (diff_dir(xa, xb) || xa.distance == xb.distance) continue;
        Attr e = attr_link2(xa, xb);
        if (has_link(g, ll[a].v, ll[b].v, e.distance, e.dir, e.comp))
          tbl.add(ll[a].v, ll[b].v, e);
      }
    }
  }

  // phase 3: confirmation loop, emitting unconfirmed links in order
  std::vector<int64_t> rows;
  for (int32_t v1 : tbl.v1_order) {
    auto idxs = tbl.per_v1[v1];
    std::stable_sort(idxs.begin(), idxs.end(), [&](size_t x, size_t y) {
      return tbl.entries[x].a.distance < tbl.entries[y].a.distance;
    });
    for (size_t j = 0; j < idxs.size(); ++j) {
      const auto& ej = tbl.entries[idxs[j]];
      bool confirmed = false;
      for (size_t k = 0; k < j && !confirmed; ++k) {
        const auto& ek = tbl.entries[idxs[k]];
        if (ek.a.dir == ej.a.dir &&
            has_link_pair(g, ek.v2, ek.a, ej.v2, ej.a))
          confirmed = true;
      }
      if (!confirmed) {
        rows.push_back(ej.v1);
        rows.push_back(ej.v2);
        rows.push_back(ej.a.distance);
        rows.push_back(ej.a.dir);
        rows.push_back(ej.a.comp);
      }
    }
  }

  int64_t n = (int64_t)rows.size() / 5;
  int64_t* buf = (int64_t*)malloc(rows.size() * sizeof(int64_t));
  if (!rows.empty()) memcpy(buf, rows.data(), rows.size() * sizeof(int64_t));
  *out_rows = buf;
  return n;
}

void siga_paired_free(int64_t* p) { free(p); }

}  // extern "C"

extern "C" {

// Host-side 2-bit left-aligned read packing (ops/fm_device.py::
// pack_reads_2bit): ASCII reads -> (n, maxlen/16) int32 words, symbol j in
// bits [2*(j%16), +2) of word j/16.  Returns -1 if any byte is not ACGT
// (caller falls back to the checked numpy path for the error message).
int64_t siga_pack_reads_2bit(const uint8_t* bytes, const int64_t* offsets,
                             int64_t n_seqs, int64_t n_rows, int64_t maxlen,
                             int32_t* out_words, int32_t* out_lens) {
  static int8_t lut[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; ++i) lut[i] = -1;
    lut['A'] = 0; lut['C'] = 1; lut['G'] = 2; lut['T'] = 3;
    lut['a'] = 0; lut['c'] = 1; lut['g'] = 2; lut['t'] = 3;
    init = true;
  }
  int64_t w = maxlen / 16;
  memset(out_words, 0, (size_t)(n_rows * w) * sizeof(int32_t));
  int64_t bad = 0;
#pragma omp parallel for schedule(static) reduction(+:bad)
  for (int64_t i = 0; i < n_rows; ++i) {
    if (i >= n_seqs) {
      out_lens[i] = 1;
      continue;
    }
    const uint8_t* s = bytes + offsets[i];
    int64_t L = offsets[i + 1] - offsets[i];
    out_lens[i] = (int32_t)(L > 0 ? L : 1);
    uint32_t* row = (uint32_t*)(out_words + i * w);
    for (int64_t j = 0; j < L; ++j) {
      int8_t c = lut[s[j]];
      if (c < 0) { ++bad; c = 0; }
      row[j >> 4] |= (uint32_t)c << (2 * (j & 15));
    }
  }
  return bad ? -1 : 0;
}

}  // extern "C"
