// Host-side data engine: sliding-window gather + per-subject normalization
// (the port's own copy of multimodalsignal_tpu/native/window_engine.cpp, the
// same source and the same build flags, so both packages' packs agree bit
// for bit).
//
// The host-bound stages that feed the card: the O(N*W*C) window gather and
// the per-channel z-score, both memory-bandwidth-bound and trivially
// parallel across windows/channels. Compiled with plain g++ (no pybind11
// dependency), loaded via ctypes (multimodalsignal_tpu_torch/native/
// __init__.py), with the NumPy implementations in data/windowing.py and
// data/dataset.py as behavioral reference and fallback.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -fopenmp (openmp optional)
//        window_engine.cpp -o build/libwindow_engine-<hash>.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

// Floor for the EDA log1p: FFT resampling can ring below -1 at sharp
// artifact steps; keep the transform total (mirrors dataset._LOG1P_FLOOR).
static inline double log1p_safe(double v) {
    return std::log1p(std::max(v, -1.0 + 1e-6));
}

extern "C" {

// Gather N windows of length W from a [T, C] float32 signal into [N, W, C].
// starts are row indices into the signal; caller guarantees bounds.
void sliding_windows_f32(const float* signal, int64_t t_total, int64_t channels,
                         const int64_t* starts, int64_t num_windows,
                         int64_t window, float* out) {
    (void)t_total;
    const int64_t row_bytes = channels * static_cast<int64_t>(sizeof(float));
#pragma omp parallel for schedule(static)
    for (int64_t n = 0; n < num_windows; ++n) {
        const float* src = signal + starts[n] * channels;
        float* dst = out + n * window * channels;
        std::memcpy(dst, src, static_cast<size_t>(window * row_bytes));
    }
}

// In-place per-channel z-score of [N, W, C] windows:
//   out[..., c] = ((log1p?)(x[..., c]) - mean[c]) / std[c]
// log1p_mask[c] != 0 applies log1p before standardizing (the reference's
// chest_EDA transform, dataset.py:40-44).
void normalize_windows_f32(float* windows, int64_t num_windows, int64_t window,
                           int64_t channels, const double* mean,
                           const double* std, const uint8_t* log1p_mask) {
    const int64_t rows = num_windows * window;
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < rows; ++r) {
        float* row = windows + r * channels;
        for (int64_t c = 0; c < channels; ++c) {
            double v = static_cast<double>(row[c]);
            if (log1p_mask[c]) v = log1p_safe(v);
            row[c] = static_cast<float>((v - mean[c]) / std[c]);
        }
    }
}

// Channel statistics over selected windows of a [N, W, C] array:
// for each channel, mean and (population) std of x or log1p(x).
void channel_stats_f32(const float* windows, int64_t num_windows,
                       int64_t window, int64_t channels,
                       const uint8_t* log1p_mask, double* mean_out,
                       double* std_out) {
    const int64_t rows = num_windows * window;
    for (int64_t c = 0; c < channels; ++c) {
        double s = 0.0, s2 = 0.0;
#pragma omp parallel for reduction(+ : s, s2) schedule(static)
        for (int64_t r = 0; r < rows; ++r) {
            double v = static_cast<double>(windows[r * channels + c]);
            if (log1p_mask[c]) v = log1p_safe(v);
            s += v;
            s2 += v * v;
        }
        const double m = s / static_cast<double>(rows);
        double var = s2 / static_cast<double>(rows) - m * m;
        if (var < 0.0) var = 0.0;
        mean_out[c] = m;
        std_out[c] = std::sqrt(var);
    }
}

// Fused per-subject corpus pack: channel-select + per-channel z-score
// (optional log1p) + [W, T, C]->[W_keep, C, T] transpose, in two streaming
// passes over a possibly memory-mapped input. Replaces the Python pipeline's
// ~5 full-array copies (select, normalize, keep-filter, transpose, pack)
// that dominated sharded-sweep staging time.
//   x         [w_total, t_len, c_all] float32 (row-major, may be mmap'd)
//   chan_idx  [c_sel] column indices into the last axis
//   stat_rows [w_total] uint8: windows contributing to the stats
//             (normalization "all" = every row, "baseline" = Base rows);
//             caller guarantees at least one row is set
//   keep_rows [w_total] uint8: windows emitted (classification-mode filter)
//   out       [sum(keep_rows), c_sel, t_len] float32
// Stats use double accumulators (population std + eps divisor), the same
// math as channel_stats_f32/normalize_windows_f32 above.
void pack_subject_f32(const float* x, int64_t w_total, int64_t t_len,
                      int64_t c_all, const int64_t* chan_idx, int64_t c_sel,
                      const uint8_t* log1p_mask, const uint8_t* stat_rows,
                      const uint8_t* keep_rows, double eps, float* out) {
    std::vector<double> sum(c_sel, 0.0), sumsq(c_sel, 0.0);
    int64_t n_stat = 0;
    for (int64_t w = 0; w < w_total; ++w) {
        if (!stat_rows[w]) continue;
        ++n_stat;
        const float* row0 = x + w * t_len * c_all;
        for (int64_t c = 0; c < c_sel; ++c) {
            const float* p = row0 + chan_idx[c];
            double s = 0.0, s2 = 0.0;
            if (log1p_mask[c]) {
                for (int64_t t = 0; t < t_len; ++t) {
                    const double v = log1p_safe(
                        static_cast<double>(p[t * c_all]));
                    s += v;
                    s2 += v * v;
                }
            } else {
                for (int64_t t = 0; t < t_len; ++t) {
                    const double v = static_cast<double>(p[t * c_all]);
                    s += v;
                    s2 += v * v;
                }
            }
            sum[c] += s;
            sumsq[c] += s2;
        }
    }
    std::vector<double> mean(c_sel), stdv(c_sel);
    const double n = static_cast<double>(n_stat) * static_cast<double>(t_len);
    for (int64_t c = 0; c < c_sel; ++c) {
        const double m = sum[c] / n;
        double var = sumsq[c] / n - m * m;
        if (var < 0.0) var = 0.0;
        mean[c] = m;
        stdv[c] = std::sqrt(var) + eps;
    }
    // Output slot per kept window (prefix count) so the emit pass can run
    // window-parallel on multi-core hosts.
    std::vector<int64_t> out_pos(w_total, -1);
    int64_t o = 0;
    for (int64_t w = 0; w < w_total; ++w)
        if (keep_rows[w]) out_pos[w] = o++;
#pragma omp parallel for schedule(static)
    for (int64_t w = 0; w < w_total; ++w) {
        if (!keep_rows[w]) continue;
        const float* row0 = x + w * t_len * c_all;
        float* dst = out + out_pos[w] * c_sel * t_len;
        for (int64_t c = 0; c < c_sel; ++c) {
            const float* p = row0 + chan_idx[c];
            float* q = dst + c * t_len;
            const double m = mean[c], sd = stdv[c];
            if (log1p_mask[c]) {
                for (int64_t t = 0; t < t_len; ++t)
                    q[t] = static_cast<float>(
                        (log1p_safe(static_cast<double>(p[t * c_all])) - m)
                        / sd);
            } else {
                for (int64_t t = 0; t < t_len; ++t)
                    q[t] = static_cast<float>(
                        (static_cast<double>(p[t * c_all]) - m) / sd);
            }
        }
    }
}

}  // extern "C"
