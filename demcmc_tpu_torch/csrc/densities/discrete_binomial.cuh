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
// already snapped to an integer by the sweep body (every lane of a chain
// snaps the same words); p = x[1].
//
// The unique counts are split over the chain's lanes (ChainLanes, up to
// kLanes threads of one warp, step_body.cuh): in round r lane l forms
// t_u = c_u lgamma32(N - k_u + 1) for u = r L + l, then every lane
// subtracts the round's terms in index order, reading lane l's with a
// __shfl_sync broadcast.  Built with -fmad=false, the serial loop also
// rounds the product and the difference apart, so every lane holds its
// bits.  With one lane a chain (the largest groups) the chain's thread
// walks the counts in turn, as the one-thread kernel did.
#pragma once

#include <math.h>

#include <cstdint>

#include "../philox.cuh"
#include "../special.cuh"

namespace demcmc {

struct DiscreteBinomialDensity {
  static constexpr int D = 2;
  static constexpr bool kNoise = false;
  static constexpr uint32_t kIntMask = 1u;  // N snapped
  // threads a chain at most: at the cell's 256 x 12 K1's window ran 0.84x
  // the one-thread kernel's time with 8, 0.88x with 16, 0.96x with 4
  // (tools/k1_ab.py on an H100, PERF.md)
  static constexpr int kLanes = 8;
  float n, cst, sk, kmax;
  int n_unique;
  float log_prior;
  const float* table;  // [n_unique, 2] (k_u, c_u)

  __host__ __device__ static DiscreteBinomialDensity from(
      const float* p, const float* data) {
    return DiscreteBinomialDensity{p[0], p[1], p[2], p[3], (int)p[4], p[5],
                                   data};
  }

  __device__ __forceinline__ float operator()(const float* x,
                                              const ChainLanes& ln) const {
    const float N = rintf(x[0]), p = x[1];
    float lp = n * lgamma32(N + 1.0f) + cst + sk * logf(p) +
               (n * N - sk) * log1pf(-p);
    const float2* tab = reinterpret_cast<const float2*>(table);
    if (ln.n == 1) {  // one lane a chain: the counts in turn
      for (int u = 0; u < n_unique; ++u) {
        const float2 kc = tab[u];
        lp = lp - kc.y * lgamma32(N - kc.x + 1.0f);
      }
    } else {
      for (int r0 = 0; r0 < n_unique; r0 += ln.n) {
        const int u = r0 + ln.lane;
        const float2 kc = u < n_unique ? tab[u] : make_float2(0.0f, 0.0f);
        const float t = kc.y * lgamma32(N - kc.x + 1.0f);
        const int m = min(ln.n, n_unique - r0);  // the same on every lane
        for (int l = 0; l < m; ++l)
          lp = lp - __shfl_sync(ln.mask, t, l, ln.n);
      }
    }
    const float ll = (N >= kmax) ? lp : -INFINITY;
    return log_prior + ll;
  }
};

}  // namespace demcmc
