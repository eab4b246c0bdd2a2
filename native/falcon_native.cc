// falcon-tpu native host library.
//
// First-party replacements for the third-party native components the
// reference relies on (SURVEY.md §2.3):
//   - fastcluster (C++): O(n^2) condensed-matrix agglomerative linkage for
//     single/complete/average via Müllner's nearest-neighbor-chain
//     algorithm (reference call site: falcon/cluster/cluster.py:285).
//   - scipy.cluster.hierarchy.fcluster(..., "distance"): flat-cluster
//     extraction by cutting the sorted linkage at a threshold (reference:
//     falcon/cluster/cluster.py:283-290, 413-421).
//   - union-find connected components for the density-clustering (DBSCAN
//     with min_samples) engine of the published algorithm.
//
// Exposed via a plain C ABI for ctypes binding (no pybind11 dependency).
//
// Build: make -C native   ->  native/libfalcon_native.so

#include <algorithm>
#include <cctype>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <functional>
#include <limits>
#include <numeric>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// Condensed index for i < j in an n x n matrix.
inline int64_t condensed_index(int64_t n, int64_t i, int64_t j) {
  return n * i + j - ((i + 2) * (i + 1)) / 2;
}

enum Method { SINGLE = 0, COMPLETE = 1, AVERAGE = 2 };

struct Merge {
  int64_t a, b;   // representative point indices of the merged clusters
  double dist;
};

// Union-find with scipy-style cluster labeling: each union gets label
// n + t for merge step t.
class LabeledUnionFind {
 public:
  explicit LabeledUnionFind(int64_t n)
      : parent_(2 * n - 1, -1), next_label_(n) {}

  int64_t find(int64_t x) {
    int64_t root = x;
    while (parent_[root] != -1) root = parent_[root];
    while (parent_[x] != -1) {  // path compression
      int64_t next = parent_[x];
      parent_[x] = root;
      x = next;
    }
    return root;
  }

  // Merge the clusters containing points a, b; returns their labels.
  void merge(int64_t root_a, int64_t root_b) {
    parent_[root_a] = next_label_;
    parent_[root_b] = next_label_;
    ++next_label_;
  }

 private:
  std::vector<int64_t> parent_;
  int64_t next_label_;
};

}  // namespace

namespace {

// Agglomerative clustering of a condensed distance matrix.
//
//   d: condensed upper-triangle distances, length n*(n-1)/2 (float64),
//      CLOBBERED as workspace.
//   n: number of observations (n >= 2).
//   method: 0 = single, 1 = complete, 2 = average.
//   z_out: (n-1) * 4 doubles, scipy linkage format — rows sorted by merge
//      distance; columns (cluster_a, cluster_b, distance, size) with
//      original observations 0..n-1 and merged cluster t labeled n+t.
//
// Returns 0 on success, 1 on bad arguments, 2 if the distances are not
// all finite (NaN/inf break the nearest-neighbor comparisons below —
// the chain walk would index out of bounds, so they are rejected up
// front, matching scipy's finiteness contract for linkage inputs).
int fc_linkage_impl(double* d, int64_t n, int method, double* z_out) {
  if (n < 2 || method < 0 || method > 2) return 1;
  const int64_t n_dists = n * (n - 1) / 2;
  for (int64_t i = 0; i < n_dists; ++i) {
    if (!std::isfinite(d[i])) return 2;
  }

  std::vector<int64_t> size(n, 1);
  std::vector<uint8_t> active(n, 1);
  std::vector<int64_t> chain;
  chain.reserve(n);
  std::vector<Merge> merges;
  merges.reserve(n - 1);

  auto dget = [&](int64_t i, int64_t j) -> double& {
    return i < j ? d[condensed_index(n, i, j)]
                 : d[condensed_index(n, j, i)];
  };

  int64_t first_active = 0;
  for (int64_t step = 0; step < n - 1; ++step) {
    if (chain.empty()) {
      while (!active[first_active]) ++first_active;
      chain.push_back(first_active);
    }
    int64_t a, b;
    double min_dist;
    for (;;) {
      a = chain.back();
      // Nearest active neighbor of a; prefer the chain predecessor so
      // reciprocal pairs terminate the walk (Müllner 2011, nn_chain).
      if (chain.size() > 1) {
        b = chain[chain.size() - 2];
        min_dist = dget(a, b);
      } else {
        b = -1;
        min_dist = kInf;
      }
      for (int64_t i = 0; i < n; ++i) {
        if (!active[i] || i == a) continue;
        double dist = dget(a, i);
        if (dist < min_dist) {
          min_dist = dist;
          b = i;
        }
      }
      if (chain.size() > 1 && b == chain[chain.size() - 2]) break;
      if (b < 0) return 3;  // unreachable with finite d; never index by it
      chain.push_back(b);
    }
    // Merge a and b (reciprocal nearest neighbors).
    chain.pop_back();
    chain.pop_back();
    merges.push_back({a, b, min_dist});

    // Lance-Williams update into b's row; deactivate a.
    int64_t sa = size[a], sb = size[b];
    for (int64_t i = 0; i < n; ++i) {
      if (!active[i] || i == a || i == b) continue;
      double da = dget(a, i), db = dget(b, i);
      double nd;
      switch (method) {
        case SINGLE:
          nd = da < db ? da : db;
          break;
        case COMPLETE:
          nd = da > db ? da : db;
          break;
        default:  // AVERAGE
          nd = (static_cast<double>(sa) * da +
                static_cast<double>(sb) * db) /
               static_cast<double>(sa + sb);
      }
      dget(b, i) = nd;
    }
    size[b] = sa + sb;
    active[a] = 0;
  }

  // Sort merges by distance (stable: preserves merge order on ties) and
  // relabel with a union-find, as fastcluster/scipy do.
  std::vector<int64_t> order(merges.size());
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t x, int64_t y) {
                     return merges[x].dist < merges[y].dist;
                   });
  LabeledUnionFind uf(n);
  std::vector<int64_t> root_label(2 * n - 1);
  std::iota(root_label.begin(), root_label.end(), 0);
  std::vector<int64_t> cluster_size(2 * n - 1, 1);
  for (size_t t = 0; t < order.size(); ++t) {
    const Merge& m = merges[order[t]];
    int64_t ra = uf.find(m.a), rb = uf.find(m.b);
    int64_t la = root_label[ra], lb = root_label[rb];
    if (la > lb) std::swap(la, lb);
    int64_t new_size = cluster_size[ra] + cluster_size[rb];
    z_out[4 * t + 0] = static_cast<double>(la);
    z_out[4 * t + 1] = static_cast<double>(lb);
    z_out[4 * t + 2] = m.dist;
    z_out[4 * t + 3] = static_cast<double>(new_size);
    uf.merge(ra, rb);
    int64_t new_root = uf.find(m.a);
    root_label[new_root] = n + static_cast<int64_t>(t);
    cluster_size[new_root] = new_size;
  }
  return 0;
}

// Flat clusters by cutting a linkage at a distance threshold, matching
// scipy's fcluster(Z, t, criterion="distance") for monotone linkages:
// observations whose cophenetic distance is <= t share a flat cluster.
// Labels are 0-based and numbered by first occurrence in leaf order
// (scipy numbers 1..k by leaf traversal; callers only rely on grouping,
// cf. falcon/cluster/cluster.py:283-311 which re-sorts by label).
//
//   z: (n-1) x 4 linkage, rows sorted ascending by distance.
//   labels_out: n int32 labels.
// Returns the number of flat clusters, or -1 on error.
int64_t fc_fcluster_impl(const double* z, int64_t n, double t,
                    int32_t* labels_out) {
  if (n < 1) return -1;
  if (n == 1) {
    labels_out[0] = 0;
    return 1;
  }
  // Union merges with distance <= t.  Linkage rows refer to cluster ids;
  // map cluster id -> current flat root via parent table.
  std::vector<int64_t> parent(2 * n - 1);
  std::iota(parent.begin(), parent.end(), 0);
  std::function<int64_t(int64_t)> find = [&](int64_t x) {
    int64_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int64_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  };
  for (int64_t row = 0; row < n - 1; ++row) {
    double dist = z[4 * row + 2];
    if (dist > t) break;  // rows sorted ascending
    int64_t node = n + row;
    // Bounds-check the cluster ids BEFORE casting/indexing: a corrupt
    // Z (NaN or out-of-range id) must error, not index out of bounds.
    // NaN fails both comparisons, so it is rejected here too.
    double fa = z[4 * row + 0], fb = z[4 * row + 1];
    if (!(fa >= 0 && fa < static_cast<double>(node)) ||
        !(fb >= 0 && fb < static_cast<double>(node))) {
      return -1;
    }
    int64_t a = static_cast<int64_t>(fa);
    int64_t b = static_cast<int64_t>(fb);
    parent[find(a)] = node;
    parent[find(b)] = node;
  }
  // Number flat clusters by first occurrence over observations.
  std::vector<int32_t> root_to_label(2 * n - 1, -1);
  int32_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = find(i);
    if (root_to_label[r] < 0) root_to_label[r] = next++;
    labels_out[i] = root_to_label[r];
  }
  return next;
}

namespace {

// Natural-order comparison of two strings with Python-tuple semantics
// matching falcon_tpu/utils/natsort.py: strings split into digit / text
// runs; a digit run sorts before a text run at the same position; digit
// runs compare numerically (leading zeros ignored; numerically equal
// runs are a tie); text runs compare bytewise (UTF-8 bytes == code-point
// order); exhausted string sorts first.
int nat_compare(const char* a, const char* a_end,
                const char* b, const char* b_end) {
  while (true) {
    bool a_done = a == a_end, b_done = b == b_end;
    if (a_done && b_done) return 0;
    if (a_done) return -1;
    if (b_done) return 1;
    bool a_digit = std::isdigit(static_cast<unsigned char>(*a));
    bool b_digit = std::isdigit(static_cast<unsigned char>(*b));
    if (a_digit != b_digit) return a_digit ? -1 : 1;  // (0, n) < (1, s)
    if (a_digit) {
      const char* a0 = a;
      const char* b0 = b;
      while (a < a_end && std::isdigit(static_cast<unsigned char>(*a)))
        ++a;
      while (b < b_end && std::isdigit(static_cast<unsigned char>(*b)))
        ++b;
      while (a0 < a && *a0 == '0') ++a0;  // strip leading zeros
      while (b0 < b && *b0 == '0') ++b0;
      int64_t la = a - a0, lb = b - b0;
      if (la != lb) return la < lb ? -1 : 1;
      int c = std::memcmp(a0, b0, static_cast<size_t>(la));
      if (c != 0) return c < 0 ? -1 : 1;
      // Numerically equal (possibly different leading zeros): tie.
    } else {
      while (a < a_end && b < b_end
             && !std::isdigit(static_cast<unsigned char>(*a))
             && !std::isdigit(static_cast<unsigned char>(*b))) {
        if (*a != *b) {
          return static_cast<unsigned char>(*a)
                         < static_cast<unsigned char>(*b) ? -1 : 1;
        }
        ++a;
        ++b;
      }
      // One (or both) text run ended: if one still has text while the
      // other moved to digit/end *within the same tuple element*, the
      // longer text string compares greater (Python str order decided
      // the element).
      bool a_text = a < a_end
                    && !std::isdigit(static_cast<unsigned char>(*a));
      bool b_text = b < b_end
                    && !std::isdigit(static_cast<unsigned char>(*b));
      if (a_text != b_text) return b_text ? -1 : 1;
    }
  }
}

}  // namespace

// Stable natural-order argsort of (primary, secondary) string pairs.
//   bytes_a/offs_a: concatenated primary strings + n+1 offsets; same for
//   the secondary column.  order_out: n int64 indices.
// Returns 0 on success.
int fc_natsort_pairs_impl(const char* bytes_a, const int64_t* offs_a,
                     const char* bytes_b, const int64_t* offs_b,
                     int64_t n, int64_t* order_out) {
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t x, int64_t y) {
    int c = nat_compare(bytes_a + offs_a[x], bytes_a + offs_a[x + 1],
                        bytes_a + offs_a[y], bytes_a + offs_a[y + 1]);
    if (c != 0) return c < 0;
    return nat_compare(bytes_b + offs_b[x], bytes_b + offs_b[x + 1],
                       bytes_b + offs_b[y], bytes_b + offs_b[y + 1]) < 0;
  });
  std::memcpy(order_out, order.data(), n * sizeof(int64_t));
  return 0;
}

namespace {

// UTF-32 (numpy U-dtype) natural-order comparison, same semantics as
// nat_compare above; code-point order == UTF-8 byte order, so the two
// paths sort identically (parity enforced by tests/test_utils.py and
// tests/test_export.py).
inline bool u32_digit(uint32_t c) { return c >= '0' && c <= '9'; }

// True end of a NUL-padded fixed-width slot.
inline const uint32_t* u32_trim(const uint32_t* s, int64_t width) {
  const uint32_t* e = s + width;
  while (e > s && e[-1] == 0) --e;
  return e;
}

int nat_compare_u32(const uint32_t* a, const uint32_t* a_end,
                    const uint32_t* b, const uint32_t* b_end) {
  while (true) {
    bool a_done = a == a_end, b_done = b == b_end;
    if (a_done && b_done) return 0;
    if (a_done) return -1;
    if (b_done) return 1;
    bool a_digit = u32_digit(*a);
    bool b_digit = u32_digit(*b);
    if (a_digit != b_digit) return a_digit ? -1 : 1;  // (0, n) < (1, s)
    if (a_digit) {
      const uint32_t* a0 = a;
      const uint32_t* b0 = b;
      while (a < a_end && u32_digit(*a)) ++a;
      while (b < b_end && u32_digit(*b)) ++b;
      while (a0 < a && *a0 == '0') ++a0;  // strip leading zeros
      while (b0 < b && *b0 == '0') ++b0;
      int64_t la = a - a0, lb = b - b0;
      if (la != lb) return la < lb ? -1 : 1;
      for (; a0 < a; ++a0, ++b0)
        if (*a0 != *b0) return *a0 < *b0 ? -1 : 1;
      // Numerically equal (possibly different leading zeros): tie.
    } else {
      while (a < a_end && b < b_end && !u32_digit(*a) && !u32_digit(*b)) {
        if (*a != *b) return *a < *b ? -1 : 1;
        ++a;
        ++b;
      }
      bool a_text = a < a_end && !u32_digit(*a);
      bool b_text = b < b_end && !u32_digit(*b);
      if (a_text != b_text) return b_text ? -1 : 1;
    }
  }
}

// Run task(0..t-1) on worker threads.  Thread construction can throw
// std::system_error (EAGAIN near the process thread limit); an
// exception escaping the extern "C"/ctypes boundary would
// std::terminate() the embedding Python process, so any tasks whose
// thread failed to start run serially on this thread instead.  Tasks
// operate on disjoint chunks, so serial-after-parallel is safe.
// Exceptions thrown INSIDE a pool thread (e.g. std::bad_alloc in a
// sort buffer) are captured per-thread and the first one rethrown on
// the calling thread after every thread has joined — an uncaught
// exception in a std::thread would std::terminate() regardless of the
// callers' noexcept barriers.
inline void run_chunked(int t, const std::function<void(int)>& task) {
  std::vector<std::thread> pool;
  std::vector<std::exception_ptr> errors(t);
  int started = 0;
  try {
    pool.reserve(t);
    for (; started < t; ++started) {
      int idx = started;
      pool.emplace_back([&task, &errors, idx] {
        try {
          task(idx);
        } catch (...) {
          errors[idx] = std::current_exception();
        }
      });
    }
  } catch (...) {
  }
  try {
    for (int i = started; i < t; ++i) task(i);
  } catch (...) {
    // Join the already-started pool threads before rethrowing: letting
    // the exception unwind past joinable std::thread destructors would
    // std::terminate() the process.
    for (auto& th : pool) th.join();
    throw;
  }
  for (auto& th : pool) th.join();
  for (auto& e : errors) {
    if (e) std::rethrow_exception(e);
  }
}

}  // namespace

// Stable natural-order argsort over numpy U-dtype (fixed-width UTF-32,
// NUL-padded) string columns, passed as raw buffers with widths in code
// units.  Same ordering semantics as fc_natsort_pairs; this entry point
// skips the per-string Python-object repacking (tens of seconds at the
// 25M-row export scale).  threads > 1 sorts contiguous index chunks on
// worker threads and stably merges pairwise (left before right, so the
// order is IDENTICAL to the single-threaded sort — parity enforced by
// tests/test_utils.py with a forced thread count); the 1-CPU dev box
// can only verify correctness, the speedup is for multicore hosts.
// Returns 0 on success.
int fc_natsort_pairs_u32_impl(const uint32_t* data_a, int64_t width_a,
                         const uint32_t* data_b, int64_t width_b,
                         int64_t n, int64_t* order_out, int threads) {
  std::vector<const uint32_t*> end_a(n), end_b(n);
  for (int64_t i = 0; i < n; ++i) {
    end_a[i] = u32_trim(data_a + i * width_a, width_a);
    end_b[i] = u32_trim(data_b + i * width_b, width_b);
  }
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  auto less = [&](int64_t x, int64_t y) {
    int c = nat_compare_u32(data_a + x * width_a, end_a[x],
                            data_a + y * width_a, end_a[y]);
    if (c != 0) return c < 0;
    return nat_compare_u32(data_b + x * width_b, end_b[x],
                           data_b + y * width_b, end_b[y]) < 0;
  };
  if (threads <= 1 || n < (1 << 16)) {
    std::stable_sort(order.begin(), order.end(), less);
  } else {
    int t = std::min<int64_t>(threads, n);
    std::vector<int64_t> bounds(t + 1);
    for (int i = 0; i <= t; ++i) bounds[i] = n * i / t;
    run_chunked(t, [&](int i) {
      std::stable_sort(order.begin() + bounds[i],
                       order.begin() + bounds[i + 1], less);
    });
    // Pairwise stable merges until one run remains.
    while (bounds.size() > 2) {
      std::vector<int64_t> next;
      next.push_back(bounds[0]);
      int n_merges = static_cast<int>((bounds.size() - 1) / 2);
      for (int m = 0; m < n_merges; ++m) next.push_back(bounds[2 * m + 2]);
      run_chunked(n_merges, [&](int m) {
        size_t i = static_cast<size_t>(2 * m);
        std::inplace_merge(order.begin() + bounds[i],
                           order.begin() + bounds[i + 1],
                           order.begin() + bounds[i + 2], less);
      });
      if (bounds.size() % 2 == 0)  // odd run count: last carries over
        next.push_back(bounds.back());
      bounds = std::move(next);
    }
  }
  std::memcpy(order_out, order.data(), n * sizeof(int64_t));
  return 0;
}

// Connected components over an undirected edge list.
//   u, v: edge endpoints (n_edges), nodes in [0, n_nodes).
//   labels_out: n_nodes int32 component ids, numbered by first occurrence.
// Returns the number of components.
int64_t fc_connected_components_impl(const int64_t* u, const int64_t* v,
                                int64_t n_edges, int64_t n_nodes,
                                int32_t* labels_out) {
  if (n_nodes < 0 || n_edges < 0) return -1;
  for (int64_t e = 0; e < n_edges; ++e) {
    // An out-of-range endpoint would index the parent table out of
    // bounds; reject the edge list instead.
    if (u[e] < 0 || u[e] >= n_nodes || v[e] < 0 || v[e] >= n_nodes) {
      return -1;
    }
  }
  std::vector<int64_t> parent(n_nodes);
  std::iota(parent.begin(), parent.end(), 0);
  std::function<int64_t(int64_t)> find = [&](int64_t x) {
    int64_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int64_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  };
  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t ru = find(u[e]), rv = find(v[e]);
    if (ru != rv) parent[ru] = rv;
  }
  std::vector<int32_t> root_to_label(n_nodes, -1);
  int32_t next = 0;
  for (int64_t i = 0; i < n_nodes; ++i) {
    int64_t r = find(i);
    if (root_to_label[r] < 0) root_to_label[r] = next++;
    labels_out[i] = root_to_label[r];
  }
  return next;
}

}  // namespace

namespace {

// Append Python's repr of a float (CPython float_repr /
// PyOS_double_to_string('r') semantics, which csv.writer reaches via
// str()): shortest round-trip digits; fixed-point notation when the
// decimal point lands in (-4, 16], otherwise scientific with a signed,
// at-least-two-digit exponent; nan/inf spelled Python-style.  The
// shortest digit string comes from std::to_chars (both it and CPython
// produce the unique shortest correctly-rounded representation);
// byte-for-byte parity with str(float) is enforced by
// tests/test_export.py.
// Shortest round-trip digit string of a positive finite value via
// std::to_chars scientific; sets decpt so that value = 0.<digits> *
// 10^decpt.  Returns the digit count.
template <typename T>
int shortest_digits(T v, char* digits, int* decpt) {
  char buf[48];
  auto res = std::to_chars(buf, buf + sizeof(buf), v,
                           std::chars_format::scientific);
  const char* e = std::find(static_cast<const char*>(buf),
                            static_cast<const char*>(res.ptr), 'e');
  int n_digits = 0;
  for (const char* p = buf; p != e; ++p)
    if (*p != '.') digits[n_digits++] = *p;
  const char* p = e + 1;
  bool neg_exp = *p == '-';
  if (*p == '-' || *p == '+') ++p;
  int exp10 = 0;
  while (p != res.ptr) exp10 = exp10 * 10 + (*p++ - '0');
  if (neg_exp) exp10 = -exp10;
  *decpt = exp10 + 1;
  return n_digits;
}

// Assemble a repr from shortest digits: positional with a guaranteed
// fractional part (trailing ".0"), or scientific with a signed,
// zero-padded, at-least-two-digit exponent — the shared shape of
// CPython's and numpy's float formatting.
void assemble_float_repr(std::string& out, const char* digits,
                         int n_digits, int decpt, bool positional) {
  if (!positional) {  // scientific
    out += digits[0];
    if (n_digits > 1) {
      out += '.';
      out.append(digits + 1, n_digits - 1);
    }
    out += 'e';
    int ex = decpt - 1;
    out += ex < 0 ? '-' : '+';
    ex = std::abs(ex);
    char eb[8];
    auto er = std::to_chars(eb, eb + sizeof(eb), ex);
    if (er.ptr - eb < 2) out += '0';
    out.append(eb, er.ptr - eb);
  } else if (decpt <= 0) {  // 0.00<digits>
    out += "0.";
    out.append(-decpt, '0');
    out.append(digits, n_digits);
  } else if (decpt >= n_digits) {  // <digits>00.0
    out.append(digits, n_digits);
    out.append(decpt - n_digits, '0');
    out += ".0";
  } else {  // <dig.its>
    out.append(digits, decpt);
    out += '.';
    out.append(digits + decpt, n_digits - decpt);
  }
}

void append_py_float_repr(std::string& out, double v) {
  if (std::isnan(v)) {
    out += "nan";
    return;
  }
  if (std::isinf(v)) {
    out += v < 0 ? "-inf" : "inf";
    return;
  }
  if (v == 0.0) {
    out += std::signbit(v) ? "-0.0" : "0.0";
    return;
  }
  if (v < 0) {
    out += '-';
    v = -v;
  }
  char digits[24];
  int decpt;
  int n_digits = shortest_digits(v, digits, &decpt);
  // CPython: positional iff the decimal point lands in (-4, 16].
  assemble_float_repr(out, digits, n_digits, decpt,
                      decpt > -4 && decpt <= 16);
}

// str(np.float32(v)): shortest digits that round-trip in FLOAT32 (not
// the widened double), positional iff 1e-4 <= |v| < 1e16 — numpy
// decides on the VALUE, unlike CPython's decimal-point rule, so e.g.
// np.float32(1e-4) (= 9.9999997e-05) prints '1e-04' where its shortest
// digits alone would say '0.0001'.  Neither threshold is exactly
// representable in float32, so the comparison never lands on the
// boundary.  Parity with str(np.float32) is fuzzed in
// tests/test_export.py.
void append_np_f32_repr(std::string& out, float v) {
  if (std::isnan(v)) {
    out += "nan";
    return;
  }
  if (std::isinf(v)) {
    out += v < 0 ? "-inf" : "inf";
    return;
  }
  if (v == 0.0f) {
    out += std::signbit(v) ? "-0.0" : "0.0";
    return;
  }
  if (v < 0) {
    out += '-';
    v = -v;
  }
  char digits[16];
  int decpt;
  int n_digits = shortest_digits(v, digits, &decpt);
  double a = static_cast<double>(v);
  assemble_float_repr(out, digits, n_digits, decpt,
                      a >= 1e-4 && a < 1e16);
}

inline void append_utf8(std::string& out, uint32_t c) {
  if (c < 0x80) {
    out += static_cast<char>(c);
  } else if (c < 0x800) {
    out += static_cast<char>(0xC0 | (c >> 6));
    out += static_cast<char>(0x80 | (c & 0x3F));
  } else if (c < 0x10000) {
    out += static_cast<char>(0xE0 | (c >> 12));
    out += static_cast<char>(0x80 | ((c >> 6) & 0x3F));
    out += static_cast<char>(0x80 | (c & 0x3F));
  } else {
    out += static_cast<char>(0xF0 | (c >> 18));
    out += static_cast<char>(0x80 | ((c >> 12) & 0x3F));
    out += static_cast<char>(0x80 | ((c >> 6) & 0x3F));
    out += static_cast<char>(0x80 | (c & 0x3F));
  }
}

// csv.QUOTE_MINIMAL: quote a field iff it contains the delimiter, the
// quote char, or a CR/LF (CPython checks '\r' and '\n' regardless of
// the configured lineterminator — verified empirically); embedded
// quotes are doubled.  Input is UTF-32 code points, output UTF-8.
void append_csv_str_field(std::string& out, const uint32_t* s,
                          const uint32_t* end) {
  bool quote = false;
  for (const uint32_t* p = s; p != end; ++p) {
    uint32_t c = *p;
    if (c == ',' || c == '"' || c == '\n' || c == '\r') {
      quote = true;
      break;
    }
  }
  if (quote) out += '"';
  for (const uint32_t* p = s; p != end; ++p) {
    if (*p == '"') out += '"';
    append_utf8(out, *p);
  }
  if (quote) out += '"';
}

void append_int64(std::string& out, int64_t v) {
  char buf[24];
  auto r = std::to_chars(buf, buf + sizeof(buf), v);
  out.append(buf, r.ptr - buf);
}

}  // namespace

namespace {

// Format cluster-assignment CSV rows
// (filename,spectrum_id,precursor_charge,precursor_mz,retention_time,
// cluster) byte-for-byte like csv.writer(lineterminator="\n") fed str()
// of the same values (the export path's Python fallback).  String
// columns arrive as numpy U-dtype buffers (fixed-width UTF-32,
// NUL-padded, widths in code units); charge == null_charge renders as
// an empty field.  The float columns keep their storage precision:
// mz_f32/rt_f32 select str(np.float32) formatting (the store holds
// float32, falcon_tpu/store/store.py) vs str(float).  Allocates the
// exact-size UTF-8 output into *out_buf (caller frees with
// fc_buffer_free) and returns its byte length, or -1 on allocation
// failure.
int64_t fc_csv_format_rows_u32_impl(const uint32_t* fn_data, int64_t fn_width,
                               const uint32_t* id_data, int64_t id_width,
                               const int64_t* charge, int64_t null_charge,
                               const void* mz, int mz_f32, const void* rt,
                               int rt_f32, const int64_t* cluster,
                               int64_t n, char** out_buf, int threads) {
  auto format_rows = [&](int64_t lo, int64_t hi, std::string& out) {
    out.reserve(static_cast<size_t>(hi - lo) * 64);
    for (int64_t i = lo; i < hi; ++i) {
      const uint32_t* fn = fn_data + i * fn_width;
      append_csv_str_field(out, fn, u32_trim(fn, fn_width));
      out += ',';
      const uint32_t* id = id_data + i * id_width;
      append_csv_str_field(out, id, u32_trim(id, id_width));
      out += ',';
      if (charge[i] != null_charge) append_int64(out, charge[i]);
      out += ',';
      if (mz_f32)
        append_np_f32_repr(out, static_cast<const float*>(mz)[i]);
      else
        append_py_float_repr(out, static_cast<const double*>(mz)[i]);
      out += ',';
      if (rt_f32)
        append_np_f32_repr(out, static_cast<const float*>(rt)[i]);
      else
        append_py_float_repr(out, static_cast<const double*>(rt)[i]);
      out += ',';
      append_int64(out, cluster[i]);
      out += '\n';
    }
  };
  // Rows are independent: format contiguous chunks on worker threads
  // and concatenate in order (byte-identical to the serial pass; the
  // speedup is for multicore hosts).
  int t = (threads <= 1 || n < (1 << 16))
              ? 1 : static_cast<int>(std::min<int64_t>(threads, n));
  std::vector<std::string> parts(t);
  if (t == 1) {
    format_rows(0, n, parts[0]);
  } else {
    run_chunked(t, [&](int i) {
      format_rows(n * i / t, n * (i + 1) / t, parts[i]);
    });
  }
  size_t total = 0;
  for (const auto& p : parts) total += p.size();
  char* buf = static_cast<char*>(std::malloc(total ? total : 1));
  if (buf == nullptr) return -1;
  size_t off = 0;
  for (const auto& p : parts) {
    std::memcpy(buf + off, p.data(), p.size());
    off += p.size();
  }
  *out_buf = buf;
  return static_cast<int64_t>(total);
}

}  // namespace

// ---------------------------------------------------------------------------
// Public C ABI.  Each exported entry point is a noexcept exception barrier
// around its _impl: a C++ exception (std::bad_alloc from a vector/string,
// std::system_error from thread spawn) escaping a ctypes call would
// std::terminate() the embedding Python process, so the wrappers translate
// any throw into the function's error-return convention instead
// (falcon_tpu/native.py raises RuntimeError on these codes).
// ---------------------------------------------------------------------------

extern "C" {

int fc_linkage(double* d, int64_t n, int method, double* z_out) noexcept {
  try {
    return fc_linkage_impl(d, n, method, z_out);
  } catch (...) {
    return 4;  // internal error (e.g. allocation failure)
  }
}

int64_t fc_fcluster(const double* z, int64_t n, double t,
                    int32_t* labels_out) noexcept {
  try {
    return fc_fcluster_impl(z, n, t, labels_out);
  } catch (...) {
    return -1;
  }
}

int fc_natsort_pairs(const char* bytes_a, const int64_t* offs_a,
                     const char* bytes_b, const int64_t* offs_b,
                     int64_t n, int64_t* order_out) noexcept {
  try {
    return fc_natsort_pairs_impl(bytes_a, offs_a, bytes_b, offs_b, n,
                                 order_out);
  } catch (...) {
    return 4;
  }
}

int fc_natsort_pairs_u32(const uint32_t* data_a, int64_t width_a,
                         const uint32_t* data_b, int64_t width_b,
                         int64_t n, int64_t* order_out,
                         int threads) noexcept {
  try {
    return fc_natsort_pairs_u32_impl(data_a, width_a, data_b, width_b, n,
                                     order_out, threads);
  } catch (...) {
    return 4;
  }
}

int64_t fc_connected_components(const int64_t* u, const int64_t* v,
                                int64_t n_edges, int64_t n_nodes,
                                int32_t* labels_out) noexcept {
  try {
    return fc_connected_components_impl(u, v, n_edges, n_nodes, labels_out);
  } catch (...) {
    return -1;
  }
}

int64_t fc_csv_format_rows_u32(const uint32_t* fn_data, int64_t fn_width,
                               const uint32_t* id_data, int64_t id_width,
                               const int64_t* charge, int64_t null_charge,
                               const void* mz, int mz_f32, const void* rt,
                               int rt_f32, const int64_t* cluster,
                               int64_t n, char** out_buf,
                               int threads) noexcept {
  try {
    return fc_csv_format_rows_u32_impl(fn_data, fn_width, id_data, id_width,
                                       charge, null_charge, mz, mz_f32, rt,
                                       rt_f32, cluster, n, out_buf, threads);
  } catch (...) {
    return -1;
  }
}

void fc_buffer_free(char* p) noexcept { std::free(p); }

}  // extern "C"
