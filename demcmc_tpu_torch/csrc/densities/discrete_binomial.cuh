// Discrete binomial (N integer, p) log posterior for the DE-step kernel.
//
// The float32 expression of demcmc_tpu_torch/models/discrete_binomial.py,
// operation for operation (the JAX model's demcmc_tpu/models/
// discrete_binomial.py:43-61 with the JAX kernel's _lgamma32):
//   n lgamma(N + 1) + const + Sk log p + (n N - Sk) log1p(-p)
//     - sum_u c_u lgamma(N - k_u + 1),     -inf where N < max k,
// the unique observed counts k_u with multiplicities c_u subtracted in the
// order of np.unique, then log(1/41) + that.  const = -sum_u c_u lgamma(k_u +
// 1) is folded on the host in float64.  The (k_u, c_u) table is a [n_unique,
// 2] float32 buffer in device memory (CudaDensity.data).  N = x[0] arrives
// already snapped to an integer by the sweep body; p = x[1].
#pragma once

#include <math.h>

#include <cstdint>

#include "../special.cuh"

namespace demcmc {

struct DiscreteBinomialDensity {
  static constexpr int D = 2;
  static constexpr bool kNoise = false;
  static constexpr uint32_t kIntMask = 1u;  // N snapped
  float n, cst, sk, kmax;
  int n_unique;
  float log_prior;
  const float* table;  // [n_unique, 2] (k_u, c_u)

  static DiscreteBinomialDensity from(const float* p, const float* data) {
    return DiscreteBinomialDensity{p[0], p[1], p[2], p[3], (int)p[4], p[5],
                                   data};
  }

  __device__ __forceinline__ float operator()(const float* x) const {
    const float N = rintf(x[0]), p = x[1];
    float lp = n * lgamma32(N + 1.0f) + cst + sk * logf(p) +
               (n * N - sk) * log1pf(-p);
    for (int u = 0; u < n_unique; ++u)
      lp = lp - table[2 * u + 1] * lgamma32(N - table[2 * u] + 1.0f);
    const float ll = (N >= kmax) ? lp : -INFINITY;
    return log_prior + ll;
  }
};

}  // namespace demcmc
