// Host-side native resampling kernels.
//
// This framework's analogue of the reference's Rcpp layer
// (/root/reference/src/resampling.cpp): the device path runs the XLA
// resamplers and the whole-sweep kernel; this C++ library serves host-side tooling
// (NumPy pre/post-processing, the single-core baseline, CPU fallbacks)
// without an R/Rcpp dependency.
//
// Design differences from the reference (deliberate, not a translation):
//  * RNG stays with the caller — kernels are deterministic transforms of
//    caller-supplied uniforms, which makes them unit-testable and lets the
//    caller guarantee reproducibility;
//  * inverse-CDF lookups for the sorted stratified/systematic positions
//    use a single O(n) merge walk instead of the reference's O(n^2)
//    restart-from-zero walk; multinomial uses per-draw binary search;
//  * 0-based ancestor indices; status codes instead of R exceptions.

#include <cstddef>
#include <cstdint>
#include <vector>

using std::size_t;

namespace {

constexpr int kOk = 0;
constexpr int kErrNegativeWeight = 1;
constexpr int kErrZeroSum = 2;

// Validate weights and compute the cumulative sum. Mirrors the reference's
// checks: any negative weight or a non-positive total is an error
// (src/resampling.cpp:6-8,17-23,44-50).
int build_cdf(int64_t n, const double* weights, std::vector<double>& cdf) {
  double total = 0.0;
  cdf.resize(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    if (weights[i] < 0.0) return kErrNegativeWeight;
    total += weights[i];
    cdf[static_cast<size_t>(i)] = total;
  }
  if (total <= 0.0) return kErrZeroSum;
  for (int64_t i = 0; i < n; ++i) cdf[static_cast<size_t>(i)] /= total;
  cdf[static_cast<size_t>(n - 1)] = 1.0;  // guard float undershoot
  return kOk;
}

// One forward merge pass: positions must be non-decreasing.
void merge_walk(int64_t n, const std::vector<double>& cdf,
                const double* pos, int32_t* out) {
  int64_t i = 0;
  for (int64_t j = 0; j < n; ++j) {
    while (i < n - 1 && cdf[static_cast<size_t>(i)] < pos[j]) ++i;
    out[j] = static_cast<int32_t>(i);
  }
}

}  // namespace

extern "C" {

// Systematic: positions (j + u) / n share one offset u in [0, 1).
int bssm_resample_systematic(int64_t n, const double* weights, double u,
                             int32_t* out) {
  std::vector<double> cdf;
  int rc = build_cdf(n, weights, cdf);
  if (rc != kOk) return rc;
  std::vector<double> pos(static_cast<size_t>(n));
  for (int64_t j = 0; j < n; ++j)
    pos[static_cast<size_t>(j)] = (static_cast<double>(j) + u) / static_cast<double>(n);
  merge_walk(n, cdf, pos.data(), out);
  return kOk;
}

// Stratified: one independent uniform per stratum, positions (j + u_j) / n.
int bssm_resample_stratified(int64_t n, const double* weights,
                             const double* uniforms, int32_t* out) {
  std::vector<double> cdf;
  int rc = build_cdf(n, weights, cdf);
  if (rc != kOk) return rc;
  std::vector<double> pos(static_cast<size_t>(n));
  for (int64_t j = 0; j < n; ++j)
    pos[static_cast<size_t>(j)] =
        (static_cast<double>(j) + uniforms[j]) / static_cast<double>(n);
  merge_walk(n, cdf, pos.data(), out);
  return kOk;
}

// Multinomial: iid inverse-CDF draws via binary search (uniforms unsorted).
int bssm_resample_multinomial(int64_t n, const double* weights,
                              const double* uniforms, int32_t* out) {
  std::vector<double> cdf;
  int rc = build_cdf(n, weights, cdf);
  if (rc != kOk) return rc;
  for (int64_t j = 0; j < n; ++j) {
    const double u = uniforms[j];
    int64_t lo = 0, hi = n - 1;
    while (lo < hi) {
      int64_t mid = lo + (hi - lo) / 2;
      if (cdf[static_cast<size_t>(mid)] < u) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    out[j] = static_cast<int32_t>(lo);
  }
  return kOk;
}

}  // extern "C"
