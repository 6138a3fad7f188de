// Special functions for the CUDA densities, each the device twin of a plain
// PyTorch function, in its operation order (built with -fmad=false, so each
// float operation rounds as the plain version's does):
//   as_erfc_poly  demcmc_tpu_torch/utils/dists.py::as_erfc_poly (A&S 7.1.26)
//   phi_pair      demcmc_tpu_torch/models/lba.py::_Phi_phi
//   lgamma32      demcmc_tpu_torch/utils/dists.py::lgamma32, itself the JAX
//                 kernel's _lgamma32 (demcmc_tpu/ops/fused_step.py:1261-1286)
//   clip          torch.clamp / jnp.clip, NaN kept
// The JAX kernel's _erf32/_erfc32 (fused_step.py:1227-1259) get twins here
// when a port density first needs erf or erfc.  Constants are float32 hex
// literals equal to the plain versions' np.float32 roundings.
#pragma once

#include <math.h>

namespace demcmc {

// jnp.maximum / torch.maximum: NaN in either operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  if (isnan(a) || isnan(b)) return a + b;
  return a > b ? a : b;
}

// torch.clamp(x, lo, hi) with NaN kept (max, then min)
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  if (isnan(x)) return x;
  const float m = x > lo ? x : lo;
  return m < hi ? m : hi;
}

constexpr float kAsErfcP = 0x1.4f740ap-2f;  // 0.3275911
constexpr float kAs1 = 0x1.04f20cp-2f, kAs2 = -0x1.23531cp-2f,
                kAs3 = 0x1.6be1c6p+0f, kAs4 = -0x1.7401c6p+0f,
                kAs5 = 0x1.0fb844p+0f;
constexpr float kInvSqrt2 = 0x1.6a09e6p-1f;
constexpr float kInvSqrt2Pi = 0x1.988454p-2f;

__device__ __forceinline__ float as_erfc_poly(float t) {
  return t * (kAs1 + t * (kAs2 + t * (kAs3 + t * (kAs4 + t * kAs5))));
}

// Phi(x) and phi(x) sharing one exp(-x^2/2): Phi = 1 - erfc(|x|/sqrt2)/2
// for x >= 0, erfc(|x|/sqrt2)/2 below.
__device__ __forceinline__ void phi_pair(float x, float& Phi, float& phi) {
  const float e = expf(-0.5f * x * x);
  const float t = 1.0f / (1.0f + kAsErfcP * (fabsf(x) * kInvSqrt2));
  const float half_erfc = 0.5f * e * as_erfc_poly(t);
  Phi = (x >= 0.0f) ? 1.0f - half_erfc : half_erfc;
  phi = kInvSqrt2Pi * e;
}

constexpr float kLg12 = 0x1.555556p-4f;    // 1/12
constexpr float kLg360 = -0x1.6c16c2p-9f;  // -1/360
constexpr float kLg1260 = 0x1.a01a02p-11f;  // 1/1260
constexpr float kHalfLog2Pi = 0x1.d67f1cp-1f;

// log-gamma for x > 0: shift up to z = x + n, n = ceil(max(8 - x, 0)),
// with the product of the shifted terms, then a 3-term Stirling series.
__device__ __forceinline__ float lgamma32(float x) {
  const float n = ceilf(max_nan(8.0f - x, 0.0f));
  float prod = (n > 0.0f) ? x : 1.0f;
#pragma unroll
  for (int i = 1; i < 8; ++i) prod = prod * (((float)i < n) ? x + (float)i : 1.0f);
  const float z = x + n;
  const float zi = 1.0f / z;
  const float zi2 = zi * zi;
  const float series = zi * (kLg12 + zi2 * (kLg360 + zi2 * kLg1260));
  const float lg = (z - 0.5f) * logf(z) - z + kHalfLog2Pi + series;
  return lg - logf(prod);
}

}  // namespace demcmc
