// Causal EMA normalization, on the host, in double precision.
//
// The port's copy of wav2sleep_tpu/native/src/ema_norm.cpp: the statistics
// entry, which the f64 host normalization reads, and the fused f32 entry. A
// strictly sequential, data-dependent recurrence (outlier clipping against the *previous* sigma
// makes it non-associative, so no parallel scan applies), run in double
// per sample and written out as float32. It is the full-length reference
// that the card's f32 kernel (csrc/ema_norm.cu) is held against.

#include <cmath>
#include <cstdint>

extern "C" {

// Single-channel EMA normalization statistics.
// Outputs mu[n], sigma_sq[n] (pre-floor), outlier[n].
void w2s_ema_stats(const double* signal, int64_t n, double alpha_baseline,
                   double alpha_variance, double mu_init, double sigma_sq_init,
                   double outlier_threshold_sigma, double min_sigma_sq,
                   double eps, double* mu, double* sigma_sq,
                   uint8_t* outlier) {
  if (n <= 0) return;
  mu[0] = mu_init;
  double s0 = sigma_sq_init;
  if (s0 < min_sigma_sq) s0 = min_sigma_sq;
  if (s0 < eps) s0 = eps;
  sigma_sq[0] = s0;
  outlier[0] = 0;
  double mu_prev = mu[0];
  double ss_prev = sigma_sq[0];
  const double om_ab = 1.0 - alpha_baseline;
  const double om_av = 1.0 - alpha_variance;
  for (int64_t t = 1; t < n; ++t) {
    const double x = signal[t];
    const double m = alpha_baseline * x + om_ab * mu_prev;
    double residual = x - m;
    double ss_floored = ss_prev < min_sigma_sq ? min_sigma_sq : ss_prev;
    const double threshold = outlier_threshold_sigma * std::sqrt(ss_floored);
    uint8_t is_outlier = 0;
    if (residual > threshold) {
      residual = threshold;
      is_outlier = 1;
    } else if (residual < -threshold) {
      residual = -threshold;
      is_outlier = 1;
    }
    const double ss = alpha_variance * residual * residual + om_av * ss_prev;
    mu[t] = m;
    sigma_sq[t] = ss;
    outlier[t] = is_outlier;
    mu_prev = m;
    ss_prev = ss;
  }
}

// Writes the normalized float32 signal
// (out = (x - mu) / sqrt(max(sigma_sq, min_sigma_sq))); outlier may be null.
void w2s_ema_normalize_f32(const float* signal, int64_t n,
                           double alpha_baseline, double alpha_variance,
                           double mu_init, double sigma_sq_init,
                           double outlier_threshold_sigma, double min_sigma_sq,
                           double eps, float* out, uint8_t* outlier) {
  if (n <= 0) return;
  double s0 = sigma_sq_init;
  if (s0 < min_sigma_sq) s0 = min_sigma_sq;
  if (s0 < eps) s0 = eps;
  double mu_prev = mu_init;
  double ss_prev = s0;
  {
    double denom = std::sqrt(s0 < min_sigma_sq ? min_sigma_sq : s0);
    out[0] = static_cast<float>((static_cast<double>(signal[0]) - mu_init) / denom);
    if (outlier) outlier[0] = 0;
  }
  const double om_ab = 1.0 - alpha_baseline;
  const double om_av = 1.0 - alpha_variance;
  for (int64_t t = 1; t < n; ++t) {
    const double x = static_cast<double>(signal[t]);
    const double m = alpha_baseline * x + om_ab * mu_prev;
    double residual = x - m;
    double ss_floored = ss_prev < min_sigma_sq ? min_sigma_sq : ss_prev;
    const double threshold = outlier_threshold_sigma * std::sqrt(ss_floored);
    uint8_t is_outlier = 0;
    if (residual > threshold) {
      residual = threshold;
      is_outlier = 1;
    } else if (residual < -threshold) {
      residual = -threshold;
      is_outlier = 1;
    }
    const double ss = alpha_variance * residual * residual + om_av * ss_prev;
    const double ss_out = ss < min_sigma_sq ? min_sigma_sq : ss;
    out[t] = static_cast<float>((x - m) / std::sqrt(ss_out));
    if (outlier) outlier[t] = is_outlier;
    mu_prev = m;
    ss_prev = ss;
  }
}

}  // extern "C"
