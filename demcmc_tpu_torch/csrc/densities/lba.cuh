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
// parameter space.  Parameters: nu = x[0..1], A = x[2], k = x[3], tau =
// x[4].
//
// The trials are split over the chain's lanes (ChainLanes, up to kLanes
// threads of one warp, step_body.cuh): in round r lane l evaluates trial
// r L + l, so a round's L lanes read L adjacent (choice, rt) pairs, one
// coalesced load.  Then every lane folds the round's L terms in index
// order, reading lane l's with a __shfl_sync broadcast: the adds are the
// serial loop's, in its order, so every lane holds its bits (the -inf of
// an invalid trial included).  With one lane a chain (the largest groups)
// the chain's thread walks the trials in turn, every thread of a warp at
// the same trial (a broadcast load).
#pragma once

#include <math.h>

#include <cstdint>

#include "../philox.cuh"
#include "../special.cuh"

namespace demcmc {

struct LbaDensity {
  static constexpr int D = 5;
  static constexpr bool kNoise = false;
  static constexpr uint32_t kIntMask = 0u;
  static constexpr int kLanes = 32;  // threads a chain at most
  static constexpr float kClip = 0x1.4484cp-100f;  // float32(1e-30)
  // (mu, sigma^2, log 2 pi sigma^2) of the nu, A and k priors
  float mu_nu, ss_nu, ln_nu, mu_a, ss_a, ln_a, mu_k, ss_k, ln_k;
  float min_rt, neg_log_min_rt;
  int n_trials;
  const float* trials;  // [n_trials, 2] (choice, rt)

  __host__ __device__ static LbaDensity from(const float* p,
                                             const float* data) {
    return LbaDensity{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8],
                      p[9], p[10], (int)p[11], data};
  }

  __device__ __forceinline__ static float normal(float x, float mu, float ss,
                                                 float ln) {
    return (ln + (x - mu) * (x - mu) / ss) / -2.0f;
  }

  // Trial (choice, rt)'s term: the two accumulators in order, -inf where
  // rt <= tau.  kOne: the warp's threads are at the same trial (one lane a
  // chain), so the choice branches without divergence and only the chosen
  // log argument is formed; else both are, and one log, so the lanes of a
  // round (trials of either choice) do not diverge.
  template <bool kOne>
  __device__ __forceinline__ float term(float2 tr, const float (&nu)[2],
                                        float k, float b, float tau,
                                        float inv_A) const {
    const float choice = tr.x, rt = tr.y;
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
      auto pdf_arg = [&]() {
        const float pdf = inv_A * (-nui * P1 + p1 + nui * P2 - p2);
        return clip(pdf, kClip, INFINITY);
      };
      auto sf_arg = [&]() {
        const float cdf = 1.0f + (k - ts * nui) * inv_A * P1 -
                          (b - ts * nui) * inv_A * P2 +
                          ts * inv_A * (p1 - p2);
        return clip(1.0f - cdf, kClip, 1.0f);
      };
      if constexpr (kOne) {
        float lt;
        if (choice == (float)i)
          lt = logf(pdf_arg());
        else
          lt = logf(sf_arg());
        ll = ll + lt;
      } else {
        const float pa = pdf_arg(), sa = sf_arg();
        ll = ll + logf(choice == (float)i ? pa : sa);
      }
    }
    return valid ? ll : -INFINITY;
  }

  __device__ __forceinline__ float operator()(const float* x,
                                              const ChainLanes& ln) const {
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
    const float2* tab = reinterpret_cast<const float2*>(trials);
    float total = 0.0f;
    if (ln.n == 1) {  // one lane a chain: the trials in turn
      for (int j = 0; j < n_trials; ++j) {
        const float ll = term<true>(tab[j], nu, k, b, tau, inv_A);
        total = (j == 0) ? ll : total + ll;
      }
      return prior + total;
    }
    for (int r0 = 0; r0 < n_trials; r0 += ln.n) {
      const int j = r0 + ln.lane;
      const float ll = term<false>(
          j < n_trials ? tab[j] : make_float2(0.0f, 1.0f), nu, k, b, tau,
          inv_A);
      // the round's terms in index order: a whole warp's unrolled, else
      // the first m, L or the trials left (the same m on every lane)
      const int m = min(ln.n, n_trials - r0);
      if (m == 32) {
#pragma unroll
        for (int l = 0; l < 32; ++l) {
          const float v = __shfl_sync(ln.mask, ll, l);
          total = l == 0 && r0 == 0 ? v : total + v;
        }
      } else {
        for (int l = 0; l < m; ++l) {
          const float v = __shfl_sync(ln.mask, ll, l, ln.n);
          total = l == 0 && r0 == 0 ? v : total + v;
        }
      }
    }
    return prior + total;
  }
};

}  // namespace demcmc
