// Jonker-Volgenant linear assignment solver (dense, rectangular), the
// port's copy of the JAX package's native/lap.cpp: the same arithmetic, so
// both give the same pairs, ties and gated costs included.
//
// It replaces the reference's external C dependency (lapsolver via
// motmetrics; import sites: mmtrack/models/mot/trackers/sort_tracker.py:4,
// core/evaluation/eval_mot.py:10). The tracking loop is host-side and
// sequential; this solver runs per frame on the CPU while the nets run on
// the card. Built with g++ by ops/lap.py, not with nvcc.
//
// Algorithm: shortest augmenting path (JV) on the RECTANGULAR problem
// directly — augmenting only the smaller side, O(min^2 * max) on the
// row-major cost matrix (no square padding). Exposed with C linkage for
// ctypes.

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// Solve min-cost assignment. cost: n_rows x n_cols row-major doubles.
// row_to_col / col_to_row: output assignments (-1 = unassigned).
// Returns total assignment cost over assigned pairs.
double lap_solve(const double* cost, int32_t n_rows, int32_t n_cols,
                 int32_t* row_to_col, int32_t* col_to_row) {
  // Solve the RECTANGULAR problem directly, augmenting only the smaller
  // side: O(min^2 * max). The previous version padded to square and paid
  // O(max^3) — at tracking shapes (hundreds of tracks x 100 detections,
  // heavily gated with 1e6 costs) that was ~40-1000 ms/frame and dominated
  // the whole MOT loop; this is sub-millisecond.
  const double INF = std::numeric_limits<double>::infinity();
  const bool transposed = n_rows > n_cols;
  const int nr = transposed ? n_cols : n_rows;  // small (augmented) side
  const int nc = transposed ? n_rows : n_cols;

  // contiguous small-side-major copy; +inf entries become a large finite
  // cost (still assignable, stripped from the result below)
  double maxc = 0.0;
  const int64_t total_n = (int64_t)n_rows * n_cols;
  for (int64_t i = 0; i < total_n; ++i) {
    if (cost[i] < INF && cost[i] > maxc) maxc = cost[i];
  }
  const double BIG = (maxc + 1.0) * 2.0;
  std::vector<double> a((size_t)nr * nc);
  for (int r = 0; r < nr; ++r) {
    for (int c = 0; c < nc; ++c) {
      double v0 = transposed ? cost[(int64_t)c * n_cols + r]
                             : cost[(int64_t)r * n_cols + c];
      a[(size_t)r * nc + c] = v0 < INF ? v0 : BIG;
    }
  }

  // JV / shortest augmenting path over nr rows (Jonker & Volgenant 1987)
  std::vector<double> u(nr, 0.0), v(nc, 0.0);
  std::vector<int> p(nc + 1, -1);  // p[c] = row assigned to col c; p[nc] virtual
  std::vector<int> way(nc, 0);
  std::vector<double> minv(nc);
  std::vector<char> used(nc + 1);

  for (int i = 0; i < nr; ++i) {
    std::fill(minv.begin(), minv.end(), INF);
    std::fill(used.begin(), used.end(), 0);
    int j0 = nc;  // virtual start col
    p[nc] = i;
    do {
      used[j0] = 1;
      const int i0 = p[j0];
      const double ui = u[i0];
      const double* row = &a[(size_t)i0 * nc];
      int j1 = -1;
      double delta = INF;
      for (int j = 0; j < nc; ++j) {
        if (used[j]) continue;
        const double cur = row[j] - ui - v[j];
        if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
        if (minv[j] < delta) { delta = minv[j]; j1 = j; }
      }
      for (int j = 0; j <= nc; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          if (j < nc) v[j] -= delta;
        } else if (j < nc) {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != -1);
    // augmenting path back-walk
    do {
      const int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0 != nc);
  }

  for (int r = 0; r < n_rows; ++r) row_to_col[r] = -1;
  for (int c = 0; c < n_cols; ++c) col_to_row[c] = -1;
  double total = 0.0;
  for (int c = 0; c < nc; ++c) {
    const int r = p[c];
    if (r < 0) continue;
    const int orow = transposed ? c : r;
    const int ocol = transposed ? r : c;
    const double v0 = cost[(int64_t)orow * n_cols + ocol];
    if (v0 < INF) {
      row_to_col[orow] = ocol;
      col_to_row[ocol] = orow;
      total += v0;
    }
  }
  return total;
}

// Greedy IoU matching (SORT fallback path): repeatedly take the global
// minimum. cost as above; pairs below `thr` only.
int32_t greedy_solve(const double* cost, int32_t n_rows, int32_t n_cols,
                     double thr, int32_t* row_to_col, int32_t* col_to_row) {
  std::vector<char> rused(n_rows, 0), cused(n_cols, 0);
  for (int r = 0; r < n_rows; ++r) row_to_col[r] = -1;
  for (int c = 0; c < n_cols; ++c) col_to_row[c] = -1;
  int matched = 0;
  while (true) {
    double best = thr;
    int br = -1, bc = -1;
    for (int r = 0; r < n_rows; ++r) {
      if (rused[r]) continue;
      for (int c = 0; c < n_cols; ++c) {
        if (cused[c]) continue;
        double v = cost[r * n_cols + c];
        if (v < best) { best = v; br = r; bc = c; }
      }
    }
    if (br < 0) break;
    rused[br] = 1; cused[bc] = 1;
    row_to_col[br] = bc; col_to_row[bc] = br;
    ++matched;
  }
  return matched;
}

}  // extern "C"
