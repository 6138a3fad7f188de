// LBA (nu[2], A, k, tau) log posterior for the DE-step kernel.
//
// The float32 expression of demcmc_tpu_torch/models/lba.py, operation for
// operation: the prior Normal(1,5)(nu_0) + Normal(1,5)(nu_1) +
// Normal(0.8,0.2)(A) + Normal(0.2,0.1)(k) + Uniform(0, min_rt)(tau) as in
// utils/dists.py, plus the likelihood of the JAX model's batched form
// (demcmc_tpu/models/lba.py:143-174): per trial, the two accumulators in
// order, the chosen one's log defective density and the other's log
// survivor, each clipped at 1e-30; -inf where rt <= tau.  The trials are
// summed in index order, as the plain version's loop does (the JAX kernel
// sums them in chunks, chunk_obs, so it agrees to a tolerance only).
//
// The trials live in a [n_trials, 2] float32 (choice, rt) buffer in device
// memory that the model owns (CudaDensity.data); the functor holds its
// pointer, so n_trials is a run-time value not bounded by the kernel's
// parameter space.  Every thread of a warp reads the same trial at the same
// step: a broadcast load.  Parameters: nu = x[0..1], A = x[2], k = x[3],
// tau = x[4].
#pragma once

#include <math.h>

#include <cstdint>

#include "../special.cuh"

namespace demcmc {

struct LbaDensity {
  static constexpr int D = 5;
  static constexpr bool kNoise = false;
  static constexpr uint32_t kIntMask = 0u;
  static constexpr int kLanes = 1;  // one thread a chain (step_body.cuh)
  static constexpr float kClip = 0x1.4484cp-100f;  // float32(1e-30)
  // (mu, sigma^2, log 2 pi sigma^2) of the nu, A and k priors
  float mu_nu, ss_nu, ln_nu, mu_a, ss_a, ln_a, mu_k, ss_k, ln_k;
  float min_rt, neg_log_min_rt;
  int n_trials;
  const float* trials;  // [n_trials, 2] (choice, rt)

  static LbaDensity from(const float* p, const float* data) {
    return LbaDensity{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8],
                      p[9], p[10], (int)p[11], data};
  }

  __device__ __forceinline__ static float normal(float x, float mu, float ss,
                                                 float ln) {
    return (ln + (x - mu) * (x - mu) / ss) / -2.0f;
  }

  __device__ __forceinline__ float operator()(const float* x) const {
    const float nu[2] = {x[0], x[1]};
    const float A = x[2], k = x[3], tau = x[4];
    const float unif =
        (tau >= 0.0f && tau <= min_rt) ? neg_log_min_rt : -INFINITY;
    const float prior = normal(nu[0], mu_nu, ss_nu, ln_nu) +
                        normal(nu[1], mu_nu, ss_nu, ln_nu) +
                        normal(A, mu_a, ss_a, ln_a) +
                        normal(k, mu_k, ss_k, ln_k) + unif;
    const float b = A + k;
    const float inv_A = 1.0f / A;
    float total = 0.0f;
    for (int j = 0; j < n_trials; ++j) {
      const float choice = trials[2 * j], rt = trials[2 * j + 1];
      const float t = rt - tau;
      const bool valid = t > 0.0f;
      const float ts = valid ? t : 1.0f;
      const float inv_ts = 1.0f / ts;
      float ll = 0.0f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float nui = nu[i];
        const float z1 = (k - ts * nui) * inv_ts;
        const float z2 = (b - ts * nui) * inv_ts;
        float P1, p1, P2, p2;
        phi_pair(z1, P1, p1);
        phi_pair(z2, P2, p2);
        float term;
        if (choice == (float)i) {
          const float pdf = inv_A * (-nui * P1 + p1 + nui * P2 - p2);
          term = logf(clip(pdf, kClip, INFINITY));
        } else {
          const float cdf = 1.0f + (k - ts * nui) * inv_A * P1 -
                            (b - ts * nui) * inv_A * P2 +
                            ts * inv_A * (p1 - p2);
          term = logf(clip(1.0f - cdf, kClip, 1.0f));
        }
        ll = ll + term;
      }
      ll = valid ? ll : -INFINITY;
      total = (j == 0) ? ll : total + ll;
    }
    return prior + total;
  }
};

}  // namespace demcmc
