// Native host split kernel — the C++ tier of the host fast path.
//
// The reference's native substrate is NumPy's C core plus OpenMPI
// (SURVEY.md §2.2); this framework's host tier replaces both with a
// first-party kernel: a level-synchronous split search over all frontier
// nodes that runs in O(rows·features + occupied_bins) per level, using an
// incremental impurity sweep instead of the dense (nodes × features ×
// classes × bins) tensor the vectorized numpy fallback materializes
// (host_builder.py). The win is largest with many classes — e.g. the
// reference's published benchmark workload, where every sample is its own
// class (reference: experiments.ipynb cell 5).
//
// Exposed via ctypes (no pybind11 in this environment): plain C ABI, arrays
// passed as raw pointers with explicit shapes. Compiled on first use by
// native/__init__.py (g++ into a cached .so).
//
// Semantics contract (must match ops/impurity.py and the reference):
//   - candidate b means "x_binned <= b", thresholds ascending per feature;
//   - cost = (n_l*H(l) + n_r*H(r)) / n, H = entropy (bits) or Gini;
//   - per feature: lowest-cost bin wins, ties -> lowest bin;
//   - across features: lowest cost wins, ties -> lowest feature index
//     (reference: mpitree/tree/decision_tree.py:88-91,140);
//   - candidates with an empty side are invalid;
//   - all accumulation in double; cost comparisons in double.
//
// Multi-root frontiers (the hybrid build's batched deep tail,
// core/hybrid_builder.py): every frontier node may descend from a different
// subtree with its own exact local binning, so the valid-candidate count can
// vary per (node, feature). `n_cand_per_slot != 0` switches `n_cand` from
// (n_feat,) shared to (n_slots, n_feat) row-major per-slot.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

inline double xlogx(double x) { return x > 0.0 ? x * std::log2(x) : 0.0; }

// Integer-count fast path: entropy sweeps spend nearly all their time in
// log2 (4 calls per row move). When every sample weight is integral (the
// common unweighted / bootstrap-count case) all running class counts are
// integers, so n*log2(n) comes from a lazily grown lookup table instead.
// tab[i] = xlogx((double)i) exactly — results are bit-identical to the
// direct computation, so tie-breaking cannot drift between the paths.
// thread_local: ctypes releases the GIL, so concurrent calls from two
// Python threads must not share the growth.
constexpr int64_t kXlogxTabCap = int64_t(1) << 22;  // 33 MB ceiling
thread_local std::vector<double> g_xlogx_tab;

inline const double* xlogx_tab_ensure(int64_t n) {
  if ((int64_t)g_xlogx_tab.size() < n + 1) {
    int64_t old = g_xlogx_tab.size();
    g_xlogx_tab.resize(n + 1);
    for (int64_t i = old; i < (int64_t)g_xlogx_tab.size(); ++i)
      g_xlogx_tab[i] = xlogx((double)i);
  }
  return g_xlogx_tab.data();
}

// Compact feature-major uint16 gather of the LIVE rows in bucket order:
// per-(slot, feature) sweep passes then read a contiguous run of 2-byte
// bins (indexed by bucket position) instead of 216-byte-strided int32
// loads — the row-major layout costs a full cache line per row per
// feature. Gathering only live rows keeps the rebuild proportional to the
// level\'s work (the hybrid refine\'s live set shrinks every level; a
// full-matrix transpose there cost more than it saved). nullptr when bins
// exceed uint16 (exact binning on very-high-cardinality data); callers
// fall back to the strided int32 reads.
// Cap mirrors g_xlogx_tab's: the buffer persists thread_local between
// levels (reallocating 60 MB per level would thrash); past the cap the
// callers simply keep their strided-int32 fallback reads.
constexpr int64_t kXbtCapBytes = int64_t(1) << 27;  // 128 MB ceiling
thread_local std::vector<uint16_t> g_xbt;

// y / w companions to the bin gather: the sweep touches each row's label
// and weight once per FEATURE (54x per level at covtype), so leaving them
// at their original indices costs 54 random reads per row into
// multi-megabyte arrays; in bucket order the per-slot slices are
// L1-resident. Filled once per call, beside the bins.
thread_local std::vector<int32_t> g_y_local;
thread_local std::vector<float> g_yv_local;
thread_local std::vector<double> g_w_local;

inline const int32_t* gather_labels(const int32_t* y,
                                    const std::vector<int64_t>& rows) {
  g_y_local.resize(rows.size());
  for (size_t i = 0; i < rows.size(); ++i) g_y_local[i] = y[rows[i]];
  return g_y_local.data();
}

inline const float* gather_targets(const float* yv,
                                   const std::vector<int64_t>& rows) {
  g_yv_local.resize(rows.size());
  for (size_t i = 0; i < rows.size(); ++i) g_yv_local[i] = yv[rows[i]];
  return g_yv_local.data();
}

inline const double* gather_weights(const double* w,
                                    const std::vector<int64_t>& rows) {
  if (!w) return nullptr;
  g_w_local.resize(rows.size());
  for (size_t i = 0; i < rows.size(); ++i) g_w_local[i] = w[rows[i]];
  return g_w_local.data();
}

inline const uint16_t* gather_bins(const int32_t* xb,
                                   const std::vector<int64_t>& rows_by_slot,
                                   int32_t n_feat, int32_t n_bins) {
  if (n_bins > 65535) return nullptr;
  const int64_t live = (int64_t)rows_by_slot.size();
  if (live * n_feat * 2 > kXbtCapBytes) return nullptr;
  g_xbt.resize((size_t)live * n_feat);
  uint16_t* out = g_xbt.data();
  auto gather_range = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int32_t* row = xb + rows_by_slot[i] * n_feat;
      for (int32_t f = 0; f < n_feat; ++f)
        out[(size_t)f * live + i] = (uint16_t)row[f];
    }
  };
  // Same thread budget as the sweep (the gather is the sweep's serial
  // prologue — leaving it single-threaded would Amdahl-cap multicore
  // hosts now that the dense sweep itself is cheap). Row ranges write
  // disjoint [lo, hi) runs of every column, so no synchronization.
  int nt = 0;
  if (const char* env = std::getenv("MPITREE_TPU_NATIVE_THREADS")) {
    nt = std::abs(std::atoi(env));
  }
  if (nt <= 0) nt = (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (live < (int64_t)1 << 16) nt = 1;  // below this, spawn cost dominates
  if (nt == 1) {
    gather_range(0, live);
    return out;
  }
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t)
    threads.emplace_back(gather_range, live * t / nt, live * (t + 1) / nt);
  for (auto& th : threads) th.join();
  return out;
}

// Strictly-better test with relative tolerance: the incremental sweep's cost
// differs from the reference's dense formula by last-ULP rounding, and exact
// mathematical ties (symmetric splits) must resolve to the lowest
// (feature, bin) as the reference's first-argmin does
// (mpitree/tree/decision_tree.py:88-91,140). 1e-12 relative absorbs ULP
// noise while never confusing genuinely different costs.
inline bool better(double cost, double best) {
  if (std::isinf(best)) return cost < best;
  return cost < best - 1e-12 * (std::abs(best) + 1.0);
}

// Bucket rows by frontier slot (counting sort; parked rows drop out).
// Zero-weight rows (bootstrap out-of-bag) are excluded up front: they
// contribute nothing to counts or impurity, and the device path's
// bin-occupancy ("constant") flag ignores them too.
void bucket_rows(const int32_t* node_id, const double* w, int64_t n_rows,
                 int32_t frontier_lo, int32_t n_slots,
                 std::vector<int64_t>& slot_start,
                 std::vector<int64_t>& rows_by_slot) {
  slot_start.assign(n_slots + 1, 0);
  std::vector<int32_t> slot_of(n_rows);
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t s = (int64_t)node_id[r] - frontier_lo;
    bool live = s >= 0 && s < n_slots && (!w || w[r] > 0.0);
    slot_of[r] = live ? (int32_t)s : -1;
    if (slot_of[r] >= 0) slot_start[slot_of[r] + 1]++;
  }
  for (int32_t s = 0; s < n_slots; ++s) slot_start[s + 1] += slot_start[s];
  rows_by_slot.resize(slot_start[n_slots]);
  std::vector<int64_t> cur(slot_start.begin(), slot_start.end() - 1);
  for (int64_t r = 0; r < n_rows; ++r)
    if (slot_of[r] >= 0) rows_by_slot[cur[slot_of[r]]++] = r;
}

// Frontier slots are independent, so the per-slot loop parallelizes with no
// synchronization and no effect on results (tie-breaks are within-slot).
// Ranges are row-balanced via the slot_start prefix sums: at the root level
// one slot can hold every row, and an even slot split would leave all but
// one thread idle. MPITREE_TPU_NATIVE_THREADS caps the thread count
// (default: hardware concurrency; 1 disables threading); a NEGATIVE value
// forces |value| threads even below the small-work threshold — a test
// hook, so the cap semantics never cost users the tiny-fit latency path.
template <class Fn>
void run_slot_ranges(const std::vector<int64_t>& slot_start, int32_t n_slots,
                     Fn&& worker) {
  int nt = 0;
  bool force = false;
  if (const char* env = std::getenv("MPITREE_TPU_NATIVE_THREADS")) {
    nt = std::atoi(env);
    if (nt < 0) {
      nt = -nt;
      force = true;
    }
  }
  if (nt <= 0) nt = (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > n_slots) nt = n_slots;
  // Tiny levels (the host tier's single-digit-millisecond latency path)
  // must not pay thread spawn/join: their whole sweep costs less than one
  // std::thread startup. Threshold in rows of actual work this call.
  if (!force && slot_start[n_slots] < (int64_t)1 << 15) nt = 1;
  if (nt <= 1) {
    worker(0, n_slots);
    return;
  }
  const int64_t total = slot_start[n_slots];
  std::vector<int32_t> bounds(nt + 1, 0);
  bounds[nt] = n_slots;
  for (int t = 1; t < nt; ++t) {
    const int64_t target = total * t / nt;
    auto it = std::upper_bound(slot_start.begin(),
                               slot_start.begin() + n_slots + 1, target);
    int32_t b = (int32_t)(it - slot_start.begin()) - 1;
    bounds[t] = std::max(b, bounds[t - 1]);
  }
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t)
    if (bounds[t + 1] > bounds[t])
      threads.emplace_back(worker, bounds[t], bounds[t + 1]);
  for (auto& th : threads) th.join();
}

// Produce the ascending occupied-bin order for one (node, feature) pass.
// Dense nodes (occupied bins comparable to the bin range, the exact-binned
// deep-tail case) iterate the range directly; sparse nodes sort the touched
// list — O(min(range, T log T)) instead of always T log T.
inline void order_touched(std::vector<int32_t>& touched, int32_t bt_max) {
  const int64_t T = (int64_t)touched.size();
  if ((int64_t)bt_max + 1 <= 8 * T) {
    // touched densely covers [0, bt_max]: counting iteration
    std::vector<char> seen((size_t)bt_max + 1, 0);
    for (int32_t b : touched) seen[b] = 1;
    touched.clear();
    for (int32_t b = 0; b <= bt_max; ++b)
      if (seen[b]) touched.push_back(b);
  } else {
    std::sort(touched.begin(), touched.end());
  }
}

}  // namespace

extern "C" {

// Per-level split search over one frontier chunk.
//
// Inputs (row-major):
//   xb       : (n_rows, n_feat) int32 bin ids
//   y        : (n_rows,) int32 class ids in [0, n_classes)
//   node_id  : (n_rows,) int32 current assignment; rows outside
//              [frontier_lo, frontier_lo + n_slots) are ignored
//   w        : (n_rows,) double sample weights (may be null -> all 1)
//   n_cand   : valid candidate count per feature — shape (n_feat,) when
//              n_cand_per_slot == 0, else (n_slots, n_feat) row-major
//   mono_cst : (n_feat,) int8 INTERNAL monotonicity signs (nullable):
//              a candidate on a signed feature is valid only when
//              (v_l - v_r)*sign <= 0 and both child class-0 fractions lie
//              in the slot's [mono_lo, mono_hi] (n_slots float32) bounds.
//              Child values are computed as f32(mass) * f32(1/n) —
//              reciprocal-multiply, matching the device engines bit for
//              bit on integer counts (utils/monotonic.py).
// Outputs (caller-allocated):
//   out_feat : (n_slots,) int32 best feature (-1 if no valid candidate)
//   out_bin  : (n_slots,) int32 best bin
//   out_cost : (n_slots,) double best cost (+inf if none)
//   out_counts: (n_slots, n_classes) double class counts
//   out_constant: (n_slots,) uint8 "all features single-bin" flag
//   out_vl/out_vr: (n_slots,) float32 winning candidate's child values
//              (only written when mono_cst is non-null; may be null
//              otherwise)
// criterion: 0 = entropy, 1 = gini.
void best_splits_classification(
    const int32_t* xb, const int32_t* y, const int32_t* node_id,
    const double* w, int64_t n_rows, int32_t n_feat, int32_t n_bins,
    int32_t n_classes, int32_t frontier_lo, int32_t n_slots,
    const int32_t* n_cand, int32_t n_cand_per_slot, int32_t criterion,
    double min_child_w, const int8_t* mono_cst, const float* mono_lo,
    const float* mono_hi, int32_t* out_feat, int32_t* out_bin,
    double* out_cost, double* out_counts, uint8_t* out_constant,
    float* out_vl, float* out_vr) {
  const double inf = std::numeric_limits<double>::infinity();

  std::vector<int64_t> slot_start;
  std::vector<int64_t> rows_by_slot;
  bucket_rows(node_id, w, n_rows, frontier_lo, n_slots, slot_start,
              rows_by_slot);

  // Integral weights -> integer class counts -> xlogx lookup table applies.
  bool int_w = true;
  if (w) {
    for (int64_t r = 0; r < n_rows; ++r)
      if (w[r] != std::floor(w[r])) { int_w = false; break; }
  }

  // Build the lookup table ONCE in the calling thread (its thread_local
  // storage persists across calls, amortizing the fill); workers only read
  // it. Freshly spawned threads would otherwise refill their own empty
  // thread_local copy every level.
  const double* shared_tab = nullptr;
  int64_t tab_size = 0;
  if (criterion == 0 && int_w) {
    double total_live = 0.0;
    for (int64_t i : rows_by_slot) total_live += w ? w[i] : 1.0;
    // Clamp to the memory cap rather than disabling: above the cap only the
    // few giant slots fall back to live log2; the deep tail's many small
    // slots (where the sweep cost concentrates) still hit the table.
    tab_size = std::min((int64_t)total_live + 1, kXlogxTabCap);
    shared_tab = xlogx_tab_ensure(tab_size - 1);
  }

  const uint16_t* xbt = gather_bins(xb, rows_by_slot, n_feat, n_bins);
  const int32_t* yl = gather_labels(y, rows_by_slot);
  const double* wl = gather_weights(w, rows_by_slot);
  const int64_t live = (int64_t)rows_by_slot.size();

  auto worker = [&](int32_t s_begin, int32_t s_end) {
  // Scratch reused across (node, feature) passes — one set per thread.
  std::vector<int32_t> touched_bins;                // occupied bins
  std::vector<double> left_cls(n_classes, 0.0);     // running class counts
  std::vector<double> node_cls(n_classes, 0.0);
  // DENSE slots (rows >> bins — the main build, 256 quantile bins) sweep a
  // per-(bin, class) histogram, zeroed lazily at first touch (occ stamp):
  // the old chain sweep\'s 2 impurity updates per ROW collapse into 2 per
  // (occupied bin, class), a ~rows/bins-fold reduction, and per-class LUT
  // deltas telescope to the identical totals for integer counts. SPARSE
  // slots (the hybrid refine: ~2k-row subtrees with exact local binning,
  // occupied bins ~ rows) keep the per-bin chain walk — there the
  // histogram\'s per-bin class scan would cost n_classes x the row count.
  std::vector<double> hist;  // sized on the first dense slot only
  std::vector<int32_t> occ_stamp(n_bins, -1);
  int32_t stamp = 0;
  std::vector<int64_t> bin_head(n_bins, -1);
  std::vector<int64_t> row_next;
  touched_bins.reserve(n_bins);

  for (int32_t s = s_begin; s < s_end; ++s) {
    const int64_t r0 = slot_start[s], r1 = slot_start[s + 1];
    const int32_t* nc =
        n_cand + (n_cand_per_slot ? (int64_t)s * n_feat : 0);
    out_feat[s] = -1;
    out_bin[s] = 0;
    out_cost[s] = inf;
    out_constant[s] = 1;
    std::fill(node_cls.begin(), node_cls.end(), 0.0);
    for (int64_t i = r0; i < r1; ++i)
      node_cls[yl[i]] += wl ? wl[i] : 1.0;
    double n_tot = 0.0;
    for (int32_t c = 0; c < n_classes; ++c) {
      out_counts[(int64_t)s * n_classes + c] = node_cls[c];
      n_tot += node_cls[c];
    }
    if (r1 == r0) { out_constant[s] = 0; continue; }

    // A slot with no candidate features at all (the hybrid refine zeroes
    // per-slot n_cand for budget-exhausted roots) needs only the counts
    // above — skip the per-feature chain builds and sweeps outright.
    {
      bool any_cand = false;
      for (int32_t f = 0; f < n_feat; ++f)
        if (nc[f] > 0) { any_cand = true; break; }
      if (!any_cand) continue;
    }

    // mode: 0 = entropy via log2, 1 = gini, 2 = entropy via lookup table
    int mode = criterion;
    const double* tab = nullptr;
    if (shared_tab && n_tot < (double)tab_size) {
      tab = shared_tab;
      mode = 2;
    }

    // Dense-path cost is rows + occupied_bins * n_classes per (slot,
    // feature); with many classes (the reference's every-sample-its-own-
    // class benchmark: n_classes == n_rows) that regresses far past the
    // chain walk's 2-updates-per-row, so the class term gates too.
    const bool use_hist =
        (r1 - r0) >= 2 * (int64_t)n_bins
        && (int64_t)n_bins * n_classes <= (r1 - r0);
    if (use_hist && hist.empty())
      hist.resize((size_t)n_bins * n_classes, 0.0);
    if (!use_hist) row_next.resize(r1 - r0);
    for (int32_t f = 0; f < n_feat; ++f) {
      // Accumulate the (bin, class) histogram (dense) or per-bin row
      // chains (sparse) for this (node, feature).
      touched_bins.clear();
      int32_t bt_max = 0;
      ++stamp;
      const uint16_t* col = xbt ? xbt + (size_t)f * live : nullptr;
      if (use_hist) {
        for (int64_t i = r0; i < r1; ++i) {
          const int32_t b = col ? col[i] : xb[rows_by_slot[i] * n_feat + f];
          if (occ_stamp[b] != stamp) {
            occ_stamp[b] = stamp;
            touched_bins.push_back(b);
            if (b > bt_max) bt_max = b;
            double* hb = &hist[(size_t)b * n_classes];
            for (int32_t c = 0; c < n_classes; ++c) hb[c] = 0.0;
          }
          hist[(size_t)b * n_classes + yl[i]] += wl ? wl[i] : 1.0;
        }
      } else {
        for (int64_t i = r0; i < r1; ++i) {
          const int32_t b =
              col ? col[i] : xb[rows_by_slot[i] * n_feat + f];
          if (occ_stamp[b] != stamp) {
            occ_stamp[b] = stamp;
            touched_bins.push_back(b);
            if (b > bt_max) bt_max = b;
            bin_head[b] = -1;
          }
          row_next[i - r0] = bin_head[b];
          bin_head[b] = i;
        }
      }
      if (touched_bins.size() > 1) out_constant[s] = 0;

      if (nc[f] > 0 && touched_bins.size() > 1) {
        // Ascending sweep over occupied bins only.
        order_touched(touched_bins, bt_max);
        double left_n = 0.0;
        double left_sum = 0.0;  // Σ_c xlogx(l_c) (entropy) or Σ_c l_c^2
        // right_c = node_c - left_c; maintain Σ_c f(right_c) incrementally,
        // starting with all mass on the right.
        double right_sum = 0.0;
        std::fill(left_cls.begin(), left_cls.end(), 0.0);
        if (mode == 2) {
          for (int32_t c = 0; c < n_classes; ++c)
            right_sum += tab[(int64_t)node_cls[c]];
        } else if (mode == 0) {
          for (int32_t c = 0; c < n_classes; ++c)
            right_sum += xlogx(node_cls[c]);
        } else {
          for (int32_t c = 0; c < n_classes; ++c)
            right_sum += node_cls[c] * node_cls[c];
        }

        // One shared impurity-delta update for both sweep strategies —
        // the moved mass is a whole bin-class total (dense path; per-row
        // deltas telescope to exactly this) or one row's weight (chains).
        auto apply_mass = [&](int32_t c, double m) {
          const double lc = left_cls[c];
          const double rc = node_cls[c] - lc;
          if (mode == 2) {
            left_sum += tab[(int64_t)(lc + m)] - tab[(int64_t)lc];
            right_sum += tab[(int64_t)(rc - m)] - tab[(int64_t)rc];
          } else if (mode == 0) {
            left_sum += xlogx(lc + m) - xlogx(lc);
            right_sum += xlogx(rc - m) - xlogx(rc);
          } else {
            left_sum += (lc + m) * (lc + m) - lc * lc;
            right_sum += (rc - m) * (rc - m) - rc * rc;
          }
          left_cls[c] = lc + m;
          left_n += m;
        };
        for (size_t ti = 0; ti < touched_bins.size(); ++ti) {
          const int32_t b = touched_bins[ti];
          if (use_hist) {
            const double* hb = &hist[(size_t)b * n_classes];
            for (int32_t c = 0; c < n_classes; ++c)
              if (hb[c] != 0.0) apply_mass(c, hb[c]);
          } else {
            for (int64_t i = bin_head[b]; i >= 0; i = row_next[i - r0])
              apply_mass(yl[i], wl ? wl[i] : 1.0);
          }
          if (b >= nc[f]) break;  // past the last valid candidate
          const double right_n = n_tot - left_n;
          if (left_n <= 0.0 || right_n <= 0.0) continue;
          if (left_n < min_child_w || right_n < min_child_w) continue;
          // Monotonic gate in the device's exact f32 reciprocal-multiply
          // form (ops/impurity._monotonic_ok; utils/monotonic.py).
          float vl_f = 0.0f, vr_f = 0.0f;
          if (mono_cst && mono_cst[f] != 0) {
            vl_f = (float)left_cls[0] *
                   (1.0f / std::max((float)left_n, 1.0f));
            vr_f = (float)(node_cls[0] - left_cls[0]) *
                   (1.0f / std::max((float)right_n, 1.0f));
            const float sgn = (float)mono_cst[f];
            if ((vl_f - vr_f) * sgn > 0.0f) continue;
            if (vl_f < mono_lo[s] || vl_f > mono_hi[s] ||
                vr_f < mono_lo[s] || vr_f > mono_hi[s])
              continue;
          }
          double cost;
          if (mode == 1) {
            const double gl = left_n - left_sum / left_n;
            const double gr = right_n - right_sum / right_n;
            cost = (gl + gr) / n_tot;
          } else {
            // n_l*H_l = n_l*log2(n_l) - Σ_c xlogx(l_c), likewise right.
            const double hl =
                (mode == 2 ? tab[(int64_t)left_n] : xlogx(left_n)) - left_sum;
            const double hr =
                (mode == 2 ? tab[(int64_t)right_n] : xlogx(right_n)) -
                right_sum;
            cost = (hl + hr) / n_tot;
          }
          if (better(cost, out_cost[s])) {
            out_cost[s] = cost;
            out_feat[s] = f;
            out_bin[s] = b;
            if (mono_cst) {
              out_vl[s] = vl_f;
              out_vr[s] = vr_f;
            }
          }
        }
      }
    }
  }
  };  // worker
  run_slot_ranges(slot_start, n_slots, worker);
}

// Regression (squared error) variant: per-node best split from
// (w, w*y, w*y^2) running sums; same tie-break and n_cand contract.
// Outputs: out_counts is (n_slots, 3) = (n, sum_y, sum_y2) with weights.
void best_splits_regression(
    const int32_t* xb, const float* yv, const int32_t* node_id,
    const double* w, int64_t n_rows, int32_t n_feat, int32_t n_bins,
    int32_t frontier_lo, int32_t n_slots, const int32_t* n_cand,
    int32_t n_cand_per_slot, double min_child_w, const int8_t* mono_cst,
    const float* mono_lo, const float* mono_hi, int32_t* out_feat,
    int32_t* out_bin, double* out_cost, double* out_counts,
    uint8_t* out_constant, double* out_ymin, double* out_ymax,
    float* out_vl, float* out_vr) {
  const double inf = std::numeric_limits<double>::infinity();

  std::vector<int64_t> slot_start;
  std::vector<int64_t> rows_by_slot;
  bucket_rows(node_id, w, n_rows, frontier_lo, n_slots, slot_start,
              rows_by_slot);
  const uint16_t* xbt = gather_bins(xb, rows_by_slot, n_feat, n_bins);
  const float* yvl = gather_targets(yv, rows_by_slot);
  const double* wl = gather_weights(w, rows_by_slot);
  const int64_t live = (int64_t)rows_by_slot.size();

  auto worker = [&](int32_t s_begin, int32_t s_end) {
  std::vector<double> bw(n_bins, 0.0), bs(n_bins, 0.0), bq(n_bins, 0.0);
  std::vector<int32_t> touched;
  touched.reserve(n_bins);

  for (int32_t s = s_begin; s < s_end; ++s) {
    const int64_t r0 = slot_start[s], r1 = slot_start[s + 1];
    const int32_t* nc =
        n_cand + (n_cand_per_slot ? (int64_t)s * n_feat : 0);
    out_feat[s] = -1;
    out_bin[s] = 0;
    out_cost[s] = inf;
    out_constant[s] = 1;
    double n_tot = 0.0, s_tot = 0.0, q_tot = 0.0;
    double ymin = inf, ymax = -inf;
    for (int64_t i = r0; i < r1; ++i) {
      const double wr = wl ? wl[i] : 1.0;
      const double yr = (double)yvl[i];
      n_tot += wr;
      s_tot += wr * yr;
      q_tot += wr * yr * yr;
      if (wr > 0) {
        if (yr < ymin) ymin = yr;
        if (yr > ymax) ymax = yr;
      }
    }
    out_counts[(int64_t)s * 3 + 0] = n_tot;
    out_counts[(int64_t)s * 3 + 1] = s_tot;
    out_counts[(int64_t)s * 3 + 2] = q_tot;
    out_ymin[s] = ymin;
    out_ymax[s] = ymax;
    if (r1 == r0) { out_constant[s] = 0; continue; }

    {
      bool any_cand = false;
      for (int32_t f = 0; f < n_feat; ++f)
        if (nc[f] > 0) { any_cand = true; break; }
      if (!any_cand) continue;
    }

    for (int32_t f = 0; f < n_feat; ++f) {
      touched.clear();
      int32_t bt_max = 0;
      const uint16_t* col = xbt ? xbt + (size_t)f * live : nullptr;
      for (int64_t i = r0; i < r1; ++i) {
        const int32_t b = col ? col[i] : xb[rows_by_slot[i] * n_feat + f];
        const double wr = wl ? wl[i] : 1.0;
        const double yr = (double)yvl[i];
        if (bw[b] == 0.0 && bs[b] == 0.0 && bq[b] == 0.0) {
          touched.push_back(b);
          if (b > bt_max) bt_max = b;
        }
        bw[b] += wr;
        bs[b] += wr * yr;
        bq[b] += wr * yr * yr;
      }
      if (touched.size() > 1) out_constant[s] = 0;
      if (nc[f] > 0 && touched.size() > 1) {
        order_touched(touched, bt_max);
        double wl = 0.0, sl = 0.0, ql = 0.0;
        for (int32_t b : touched) {
          wl += bw[b];
          sl += bs[b];
          ql += bq[b];
          if (b >= nc[f]) break;
          const double wr_ = n_tot - wl, sr = s_tot - sl, qr = q_tot - ql;
          if (wl <= 0.0 || wr_ <= 0.0) continue;
          if (wl < min_child_w || wr_ < min_child_w) continue;
          // Monotonic gate — ABI symmetry with the classification kernel.
          // CAVEAT: these child means come from f64 accumulators cast to
          // f32, which is NOT bit-matched to the device engines' f32
          // cumsum arithmetic; host_builder.py therefore routes
          // constrained REGRESSION to its numpy sweep (which mirrors the
          // device op for op) and never passes mono_cst here. A caller
          // wiring this path accepts engine-identity drift on near-tied
          // child means.
          float vl_f = 0.0f, vr_f = 0.0f;
          if (mono_cst && mono_cst[f] != 0) {
            vl_f = (float)sl * (1.0f / std::max((float)wl, 1.0f));
            vr_f = (float)sr * (1.0f / std::max((float)wr_, 1.0f));
            const float sgn = (float)mono_cst[f];
            if ((vl_f - vr_f) * sgn > 0.0f) continue;
            if (vl_f < mono_lo[s] || vl_f > mono_hi[s] ||
                vr_f < mono_lo[s] || vr_f > mono_hi[s])
              continue;
          }
          const double sse_l = ql - sl * sl / wl;
          const double sse_r = qr - sr * sr / wr_;
          const double cost =
              (std::max(sse_l, 0.0) + std::max(sse_r, 0.0)) / n_tot;
          if (better(cost, out_cost[s])) {
            out_cost[s] = cost;
            out_feat[s] = f;
            out_bin[s] = b;
            if (mono_cst) {
              out_vl[s] = vl_f;
              out_vr[s] = vr_f;
            }
          }
        }
      }
      for (int32_t b : touched) { bw[b] = 0.0; bs[b] = 0.0; bq[b] = 0.0; }
    }
  }
  };  // worker
  run_slot_ranges(slot_start, n_slots, worker);
}

}  // extern "C"
