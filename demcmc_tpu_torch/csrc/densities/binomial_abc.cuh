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
// sub-sweep block (the noise panel, fused_step.py:2422-2427), read one at a
// time through ChainWords and never stored: at n_sim = 10,000 a stored panel
// would be 40 KB per thread.  Counts and hits are integers, exact in any
// order.  C(N, j) is a float32 buffer in device memory (CudaDensity.data);
// N <= kMaxN.
#pragma once

#include <math.h>

#include <cstdint>

#include "../philox.cuh"

namespace demcmc {

struct BinomialAbcDensity {
  static constexpr int D = 1;
  static constexpr bool kNoise = true;
  static constexpr uint32_t kIntMask = 0u;
  static constexpr int kMaxN = 64;
  int N, k, n_sim;
  const float* comb;  // [N] float32(C(N, j))

  static BinomialAbcDensity from(const float* p, const float* data) {
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

  __device__ __forceinline__ float operator()(const float* x, ChainWords& Wc,
                                              int row0) const {
    const float theta = x[0], one_m = 1.0f - theta;
    float cdf[kMaxN];
    for (int j = 0; j < N; ++j) {
      const float pmf = comb[j] * ipow(theta, j) * ipow(one_m, N - j);
      cdf[j] = (j == 0) ? pmf : cdf[j - 1] + pmf;
    }
    int hits = 0;
    for (int s = 0; s < n_sim; ++s) {
      const float u = to_uni(Wc(row0 + s));
      int cnt = 0;
      for (int j = 0; j < N; ++j) cnt += u > cdf[j];
      hits += cnt == k;
    }
    return 0.0f + logf((float)hits / (float)n_sim);
  }
};

}  // namespace demcmc
