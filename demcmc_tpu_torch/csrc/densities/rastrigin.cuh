// Rastrigin objective (n = 2) for K1's greedy accept (optimization).
//
// The float32 expression of demcmc_tpu_torch/models/rastrigin.py
// (rastrigin_batched), operation for operation:
//   A n + sum_i (x_i x_i - A cos(2 pi x_i)),
// summed in index order, with cosf (no fast math).  The constants (A n, A,
// 2 pi) are folded on the host (in float64, rounded once to float32) and
// passed in, so kernel and plain version use the same bits.  The model has
// no prior: only like() exists, and only the greedy instantiations of K1
// are built on it (ops/_build.py GREEDY_DENSITIES).
#pragma once

#include <math.h>

#include <cstdint>

namespace demcmc {

struct RastriginDensity {
  static constexpr int D = 2;
  static constexpr int kParams = 3;
  static constexpr bool kNoise = false;
  static constexpr uint32_t kIntMask = 0u;
  static constexpr int kLanes = 1;  // one thread a chain (step_body.cuh)
  // its draws taken before the state (sweep_hoist.cuh); K3 windows over a
  // thread block cluster
  static constexpr bool kHoist = true;
  float an, a, two_pi;

  __host__ __device__ static RastriginDensity from(const float* p,
                                                   const float*) {
    return RastriginDensity{p[0], p[1], p[2]};
  }

  __device__ __forceinline__ float like(const float* x) const {
    float s = x[0] * x[0] - a * cosf(two_pi * x[0]);
    for (int i = 1; i < D; ++i) s = s + (x[i] * x[i] - a * cosf(two_pi * x[i]));
    return an + s;
  }
};

}  // namespace demcmc
