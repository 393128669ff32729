/* Native host-DSP kernels for chunk-boundary processing.
 *
 * The reference scans trailing silence with a per-sample Python loop
 * (reference: handler.py:210-234); for long-text synthesis this runs on
 * every chunk boundary over up to 2x22050 samples.  Compiled on first use
 * by echo_tts_torch.native (gcc -O3 -shared), loaded via ctypes; pure-numpy
 * fallback if no compiler is present.
 */
#include <stddef.h>
#include <math.h>

/* Number of trailing samples with |x| < threshold. */
long echo_trailing_silence(const float *x, long n, float threshold) {
    long count = 0;
    for (long i = n - 1; i >= 0; --i) {
        float v = x[i];
        if (v < 0) v = -v;
        if (v < threshold) ++count; else break;
    }
    return count;
}

/* First window of `window` rows (each `width` floats) whose std (unbiased)
 * < std_threshold and |mean - target| < 0.1; returns n if none.
 * Mirrors find_flattening_point (reference: inference.py:288-296). */
long echo_flattening_point(const float *data, long n, long width,
                           long window, float target,
                           float std_threshold) {
    const long count = window * width;
    for (long i = 0; i < n; ++i) {
        double sum = 0.0, sq = 0.0;
        for (long w = 0; w < window; ++w) {
            long row = i + w;
            const float *p = (row < n) ? data + row * width : NULL;
            for (long c = 0; c < width; ++c) {
                double v = p ? p[c] : 0.0;  /* zero-padded tail */
                sum += v;
                sq += v * v;
            }
        }
        double mean = sum / (double)count;
        double var = (sq - sum * mean) / (double)(count - 1);
        double sd = var > 0 ? sqrt(var) : 0.0;
        double dm = mean - (double)target;
        if (dm < 0) dm = -dm;
        if (sd < (double)std_threshold && dm < 0.1) return i;
    }
    return n;
}
