// Native feature binner: bin = searchsorted(thresholds[f], value, 'left').
//
// The numpy loop in gbdt/binning.py costs ~100 ns/element (per-call
// overhead + branchy binary search); at MSLR-30K scale (3.6M docs x 136
// features) that is ~40 s of one-time setup. This kernel does the same
// search branchlessly over doc-row blocks on all cores.
//
// Exact numpy parity: searchsorted(a, v, 'left') = count of a[j] < v.
// Thresholds rows are sorted ascending and +inf-padded (so every finite
// value lands inside); ties and infinities follow IEEE < exactly like
// numpy's. (Reference behavior being reproduced: the one-time threshold
// grid of learning/tree/FeatureHistogram.java:~60.)

#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

#include "common.h"

namespace {
void bin_rows(const float* feats, const float* thr, int32_t* out,
              int64_t F, int64_t B, int64_t lo_row, int64_t hi_row) {
    for (int64_t i = lo_row; i < hi_row; ++i) {
        const float* row = feats + i * F;
        for (int64_t f = 0; f < F; ++f) {
            // shared parity-defining search (common.h): NaN -> B
            out[i * F + f] = static_cast<int32_t>(
                ranklib_native::bin_of(thr + f * B, B, row[f]));
        }
    }
}
}  // namespace

extern "C" int bin_features_i32(const float* feats,   // [N, F] row-major
                                const float* thr,     // [F, B] row-major
                                int32_t* out,         // [N, F]
                                int64_t N, int64_t F, int64_t B,
                                int64_t n_threads) {
    if (N < 0 || F <= 0 || B <= 0) return 1;
    if (N == 0) return 0;
    int64_t nt = n_threads;
    if (nt <= 0) {
        nt = static_cast<int64_t>(std::thread::hardware_concurrency());
        if (nt <= 0) nt = 1;
    }
    if (nt > N) nt = N;
    std::vector<std::thread> threads;
    threads.reserve(static_cast<size_t>(nt));
    const int64_t step = (N + nt - 1) / nt;
    for (int64_t b = 0; b < nt; ++b) {
        const int64_t lo = b * step;
        const int64_t hi = lo + step < N ? lo + step : N;
        if (lo >= hi) break;
        threads.emplace_back(bin_rows, feats, thr, out, F, B, lo, hi);
    }
    for (auto& th : threads) th.join();
    return 0;
}

// Capped per-feature unique collection for threshold building
// (gbdt/binning.py compute_thresholds). One row-major pass maintaining a
// small linear-probing set per feature (cap+1 entries decide "more than
// cap uniques", which is all the caller needs: <=tc uniques -> use them
// all, else an evenly spaced grid from min/max). -0.0 normalizes to +0.0
// like np.unique's ordering treats them equal.
//
// out_vals: [F, cap] (unsorted uniques; valid for features whose
// out_counts[f] <= cap), out_counts: [F] (= cap+1 when over cap),
// out_minmax: [F, 2].

#include <cstring>

using ranklib_native::CappedSet;
using ranklib_native::capped_insert;

extern "C" int feature_uniques(const float* feats,     // [N, F] row-major
                               int64_t N, int64_t F, int64_t cap,
                               float* out_vals,        // [F, cap]
                               int64_t* out_counts,    // [F]
                               float* out_minmax) {    // [F, 2]
    if (N <= 0 || F <= 0 || cap <= 0 || cap > 400) return 1;
    std::vector<CappedSet> sets(static_cast<size_t>(F));
    for (auto& s : sets) {
        std::memset(s.used, 0, sizeof(s.used));
        s.count = 0;
        s.dead = false;
    }
    // +/-inf seeds: NaN never wins a < / > compare, so NaN can never
    // poison the minmax (a row-0 seed let a leading NaN stick,
    // diverging from the numpy fallback's finite-only rule)
    std::vector<float> mn(static_cast<size_t>(F), INFINITY);
    std::vector<float> mx(static_cast<size_t>(F), -INFINITY);
    for (int64_t i = 0; i < N; ++i) {
        const float* row = feats + i * F;
        for (int64_t f = 0; f < F; ++f) {
            const float v = row[f];
            if (v < mn[f]) mn[f] = v;
            if (v > mx[f]) mx[f] = v;
            capped_insert(sets[f], v, out_vals + f * cap, cap);
        }
    }
    for (int64_t f = 0; f < F; ++f) {
        out_counts[f] = sets[f].dead ? cap + 1 : sets[f].count;
        if (mn[f] > mx[f]) {  // no finite value seen (all NaN)
            mn[f] = 0.0f;
            mx[f] = 0.0f;
        }
        out_minmax[f * 2] = mn[f];
        out_minmax[f * 2 + 1] = mx[f];
    }
    return 0;
}
