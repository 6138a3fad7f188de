// Pseudo-marginal ABC binomial (theta) log posterior for the DE-step kernel:
// a density that draws noise.
//
// The float32 expression of demcmc_tpu_torch/models/binomial.py::
// loglike_abc_batched (the JAX model's demcmc_tpu/models/binomial.py:50-86):
// the CDF table CDF_j = sum_{i<=j} C(N,i) theta^i (1-theta)^(N-i), j < N,
// with the integer powers by square-and-multiply (JAX's integer_pow order);
// for each of n_sim simulations a uniform u, its count sum_j 1{u > CDF_j},
// a hit when the count is k; log(hits / n_sim), plus the Beta(1,1) prior 0.
//
// The uniforms are the chain's words of rows row0 .. row0 + n_sim - 1 of its
// sub-sweep block (the noise panel, fused_step.py:2422-2427), read through
// ChainWords and never stored.  The panel is split over the chain's lanes
// (ChainLanes, up to kLanes threads of one warp, step_body.cuh): lane l
// takes the panel's Philox blocks l, l + n, ... (the first and last clipped
// to the panel), so each block is generated once, and the lanes' hits are
// summed with warp shuffles.  Hits are integers, exact in any order.
//
// The hit test: for theta in [0, 1] every pmf term is >= 0, so the float
// CDF is nondecreasing and a count is k exactly when (k == 0 or u >
// CDF_{k-1}) and (k == N or !(u > CDF_k)) -- two registers and two compares
// a simulation, bit for bit the count.  K1 evaluates the density only in
// the model's bounds (the ABC model's are [0, 1]); a theta in wider
// bounds but outside [0, 1] takes the count itself, with the CDF
// recomputed for each simulation, so no table sits in local memory.
// C(N, j) is a float32 buffer in device memory (CudaDensity.data); N <= 64
// (models/binomial.py MAX_N).
#pragma once

#include <math.h>

#include <cstdint>

#include "../philox.cuh"

namespace demcmc {

struct BinomialAbcDensity {
  static constexpr int D = 1;
  static constexpr bool kNoise = true;
  static constexpr uint32_t kIntMask = 0u;
  static constexpr int kLanes = 32;  // threads a chain at most
  int N, k, n_sim;
  const float* comb;  // [N] float32(C(N, j))

  __host__ __device__ static BinomialAbcDensity from(const float* p,
                                                     const float* data) {
    return BinomialAbcDensity{(int)p[0], (int)p[1], (int)p[2], data};
  }

  // x^n, n >= 0: acc * x on set bits, x * x between them; x^0 = 1
  __device__ __forceinline__ static float ipow(float x, int n) {
    if (n == 0) return 1.0f;
    float acc = 0.0f;
    bool have = false;
    while (n > 0) {
      if (n & 1) {
        acc = have ? acc * x : x;
        have = true;
      }
      n >>= 1;
      if (n > 0) x = x * x;
    }
    return acc;
  }

  __device__ __forceinline__ float pmf(float theta, float one_m, int j) const {
    return comb[j] * ipow(theta, j) * ipow(one_m, N - j);
  }

  // hits among this lane's simulations: hit(u) for each uniform of the
  // lane's blocks of rows row0 .. end - 1
  template <class Hit>
  __device__ __forceinline__ int lane_hits(ChainWords& Wc, int row0, int end,
                                           const ChainLanes& ln,
                                           Hit hit) const {
    int hits = 0;
    const int b1 = (end - 1) >> 2;
    for (int b = (row0 >> 2) + ln.lane; b <= b1; b += ln.n) {
      const int r = b << 2;
      if (r >= row0 && r + 4 <= end) {
        const uint4 q = Wc.block((uint32_t)b);
        hits += hit(to_uni(q.x)) + hit(to_uni(q.y)) + hit(to_uni(q.z)) +
                hit(to_uni(q.w));
      } else {
        for (int i = max(r, row0); i < min(r + 4, end); ++i)
          hits += hit(to_uni(Wc(i)));
      }
    }
    return hits;
  }

  __device__ __forceinline__ float operator()(const float* x, ChainWords& Wc,
                                              int row0,
                                              const ChainLanes& ln) const {
    const float theta = x[0], one_m = 1.0f - theta;
    // the panel's rows up to a computed end: with n_sim as the bound, K1's
    // window loop made ptxas reload it from the constant bank on each
    // simulation's critical path (9% of K1 on an H100, PERF.md)
    const int end = row0 + n_sim;
    int hits = 0;
    if (k < 0 || k > N) {
      // no count reaches k
    } else if (theta >= 0.0f && theta <= 1.0f) {
      float cdf = 0.0f, lo = -INFINITY, hi = INFINITY;
      for (int j = 0; j < N && j <= k; ++j) {
        const float p = pmf(theta, one_m, j);
        cdf = (j == 0) ? p : cdf + p;
        if (j == k - 1) lo = cdf;
        if (j == k) hi = cdf;
      }
      hits = lane_hits(Wc, row0, end, ln, [&](float u) {
        return (int)((u > lo) & !(u > hi));
      });
    } else {
      hits = lane_hits(Wc, row0, end, ln, [&](float u) {
        float cdf = 0.0f;
        int cnt = 0;
        for (int j = 0; j < N; ++j) {
          const float p = pmf(theta, one_m, j);
          cdf = (j == 0) ? p : cdf + p;
          cnt += u > cdf;
        }
        return (int)(cnt == k);
      });
    }
    hits = ln.sum(hits);
    return 0.0f + logf((float)hits / (float)n_sim);
  }
};

}  // namespace demcmc
