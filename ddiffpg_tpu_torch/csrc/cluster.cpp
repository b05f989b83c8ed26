// Host clustering kernels of the port, a copy of the JAX package's
// runtime/cluster.cpp:
//  - linkage_average, for the recluster (ddiffpg_tpu_torch/modes/
//    linkage.py): O(N^2) nearest-neighbor-chain algorithm with the
//    Lance-Williams average update; merges sorted by height and relabeled
//    like scipy.cluster.hierarchy.linkage;
//  - dtw_batch, a float64 DTW of materialised pairs on the host
//    (modes/_native.py:dtw_batch). The recluster computes its distances
//    with ops/dtw.py and, on a card, csrc/dtw.cu; this loop is their
//    float64 reference.
//
// Built by modes/_native.py at first use:
//   g++ -O3 -shared -fPIC csrc/cluster.cpp -o build/torch_ext/cluster_<hash>.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Average-linkage agglomerative clustering via the nearest-neighbor-chain
// algorithm with the Lance-Williams update. dist: n*n row-major. Output Z:
// (n-1) rows of (cluster1, cluster2, height, size), merges sorted by height
// and relabeled exactly like scipy.cluster.hierarchy.linkage.
int linkage_average(const double* dist, int n, double* Z) {
  if (n < 2) return 0;
  const double INF = 1e300;
  std::vector<double> D(dist, dist + (size_t)n * n);
  for (int i = 0; i < n; ++i) D[(size_t)i * n + i] = INF;
  std::vector<double> size(n, 1.0);
  std::vector<char> active(n, 1);
  std::vector<int64_t> label(n);
  std::iota(label.begin(), label.end(), 0);

  struct Merge { int64_t c1, c2; double h, s; };
  std::vector<Merge> merges;
  merges.reserve(n - 1);
  std::vector<int> chain;
  chain.reserve(n);

  int n_merges = 0;
  while (n_merges < n - 1) {
    if (chain.empty()) {
      for (int i = 0; i < n; ++i)
        if (active[i]) { chain.push_back(i); break; }
    }
    int a = chain.back();
    // nearest active neighbor of a
    int b = -1;
    double best = INF;
    const double* row = &D[(size_t)a * n];
    for (int j = 0; j < n; ++j) {
      if (j != a && active[j] && row[j] < best) { best = row[j]; b = j; }
    }
    if (chain.size() > 1 && b == chain[chain.size() - 2]) {
      // reciprocal nearest neighbors -> merge
      double h = D[(size_t)a * n + b];
      double na = size[a], nb = size[b];
      merges.push_back({label[a], label[b], h, na + nb});
      for (int x = 0; x < n; ++x) {
        double v = (na * D[(size_t)a * n + x] + nb * D[(size_t)b * n + x]) /
                   (na + nb);
        D[(size_t)a * n + x] = v;
        D[(size_t)x * n + a] = v;
      }
      D[(size_t)a * n + a] = INF;
      active[b] = 0;
      size[a] = na + nb;
      label[a] = n + n_merges;
      ++n_merges;
      chain.pop_back();
      chain.pop_back();
    } else {
      chain.push_back(b);
    }
  }

  // sort by height (stable), relabel merge nodes like scipy
  std::vector<int> order(merges.size());
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int x, int y) {
    return merges[x].h < merges[y].h;
  });
  std::vector<int64_t> remap(2 * n, -1);
  for (size_t new_i = 0; new_i < order.size(); ++new_i)
    remap[n + order[new_i]] = n + (int64_t)new_i;
  for (size_t i = 0; i < order.size(); ++i) {
    const Merge& m = merges[order[i]];
    int64_t c1 = m.c1 >= n ? remap[m.c1] : m.c1;
    int64_t c2 = m.c2 >= n ? remap[m.c2] : m.c2;
    Z[i * 4 + 0] = (double)std::min(c1, c2);
    Z[i * 4 + 1] = (double)std::max(c1, c2);
    Z[i * 4 + 2] = m.h;
    Z[i * 4 + 3] = m.s;
  }
  return 0;
}

// Multivariate DTW, dtaidistance dtw_ndim semantics: cell cost = squared
// Euclidean distance, unconstrained warping, distance = sqrt(D[la][lb]).
// a: [P, Lmax, D], b likewise; la, lb: per-pair valid lengths; out: [P].
int dtw_batch(const double* a, const double* b, const int32_t* la,
              const int32_t* lb, int P, int Lmax, int D, double* out) {
  const double INF = 1e300;
  std::vector<double> prev(Lmax + 1), cur(Lmax + 1);
  for (int p = 0; p < P; ++p) {
    const double* A = a + (size_t)p * Lmax * D;
    const double* B = b + (size_t)p * Lmax * D;
    int n = la[p], m_ = lb[p];
    std::fill(prev.begin(), prev.end(), INF);
    prev[0] = 0.0;
    for (int i = 1; i <= n; ++i) {
      cur[0] = INF;
      const double* ai = A + (size_t)(i - 1) * D;
      for (int j = 1; j <= m_; ++j) {
        const double* bj = B + (size_t)(j - 1) * D;
        double c = 0.0;
        for (int d = 0; d < D; ++d) {
          double t = ai[d] - bj[d];
          c += t * t;
        }
        double m3 = std::min(prev[j], std::min(cur[j - 1], prev[j - 1]));
        cur[j] = c + m3;
      }
      for (int j = m_ + 1; j <= Lmax; ++j) cur[j] = INF;
      std::swap(prev, cur);
    }
    out[p] = std::sqrt(prev[m_]);
  }
  return 0;
}

}  // extern "C"
