// MVN (mu[K], sigma) log posterior for the DE-step kernels.
//
// The float32 expression of demcmc_tpu_torch/models/mvnormal.py, operation
// for operation: the prior sum_i Normal(0,1)(mu_i) + half-Cauchy(sigma) as in
// utils/dists.py, plus the centered sufficient-statistic likelihood
//   (c0 - n K log s) - 0.5 (ss + n sum_i dm_i^2) / (s s),   dm = mu - xbar,
// summed as prior + loglike.  Both sums over i run in index order (the
// plain version's loop).  The constants are folded on the host (in float64,
// rounded once to float32) and passed in, so kernel and plain version use
// the same bits.  Parameters: mu = x[0..K-1], sigma = x[K].
#pragma once

#include <math.h>

#include <cstdint>

namespace demcmc {

template <int K>
struct MvNormalDensity {
  static constexpr int D = K + 1;
  static constexpr int kParams = 7 + K;
  static constexpr bool kNoise = false;
  static constexpr uint32_t kIntMask = 0u;
  float n, nd, ss, c0, log_2pi, log_pi, log2;
  float xbar[K];

  static MvNormalDensity from(const float* p, const float*) {
    MvNormalDensity m{p[0], p[1], p[2], p[3], p[4], p[5], p[6], {}};
    for (int i = 0; i < K; ++i) m.xbar[i] = p[7 + i];
    return m;
  }

  __device__ __forceinline__ float operator()(const float* x) const {
    float normal = (log_2pi + x[0] * x[0]) / -2.0f;
    for (int i = 1; i < K; ++i) normal = normal + (log_2pi + x[i] * x[i]) / -2.0f;
    const float s = x[K];
    float halfcauchy = log2 + -(log_pi + log1pf(s * s));
    halfcauchy = (s >= 0.0f) ? halfcauchy : -INFINITY;
    const float prior = normal + halfcauchy;
    float dm = x[0] - xbar[0];
    float q = dm * dm;
    for (int i = 1; i < K; ++i) {
      dm = x[i] - xbar[i];
      q = q + dm * dm;
    }
    const float ll = (c0 - nd * logf(s)) - (0.5f * (ss + n * q)) / (s * s);
    return prior + ll;
  }
};

}  // namespace demcmc
