// Gaussian (mu, sigma) log posterior for the DE-step kernel.
//
// The float32 expression of demcmc_tpu_torch/models/gaussian.py, operation
// for operation: the prior Normal(0,1)(mu) + half-Cauchy(sigma) as in
// utils/dists.py, plus the centered sufficient-statistic likelihood
//   (c0 - n log s) - 0.5 (ss + n dm dm) / (s s),   dm = mu - xbar,
// summed as prior + loglike.  The constants are folded on the host (in
// float64, rounded once to float32) and passed in, so kernel and plain
// version use the same bits.
#pragma once

#include <math.h>

#include <cstdint>

namespace demcmc {

struct GaussianDensity {
  static constexpr int D = 2;
  static constexpr int kParams = 7;
  static constexpr bool kNoise = false;
  static constexpr uint32_t kIntMask = 0u;
  float n, xbar, ss, c0, log_2pi, log_pi, log2;

  static GaussianDensity from(const float* p, const float*) {
    return GaussianDensity{p[0], p[1], p[2], p[3], p[4], p[5], p[6]};
  }

  __device__ __forceinline__ float operator()(const float* x) const {
    const float mu = x[0], s = x[1];
    const float normal = (log_2pi + mu * mu) / -2.0f;
    float halfcauchy = log2 + -(log_pi + log1pf(s * s));
    halfcauchy = (s >= 0.0f) ? halfcauchy : -INFINITY;
    const float prior = normal + halfcauchy;
    const float dm = mu - xbar;
    const float ll = (c0 - n * logf(s)) - (0.5f * (ss + n * dm * dm)) / (s * s);
    return prior + ll;
  }
};

}  // namespace demcmc
