// K3: one DE-MCz iteration -- partners from the history of past states.
//
// Replaces the resample variant of the TPU kernel demcmc_tpu/ops/
// fused_step.py build_fused_step: the history partner fetch
// one_sweep_resample (:2224-2246) with its three engines (in-VMEM
// fetch_hist_narrow :2178, the streamed pre-gather _resample_pre :2688,
// the wide one-hot permute fetch_hist_wide :2130), the partner index draws
// _resample_idx (:2637) and the history write store_samples! (:2494-2517).
// The body is step_body.cuh's sweep_kernel with the HistoryPartners source:
// the same proposal, snooker, epsilon, kappa, beta, bounds, density and MH
// tail as K1, with the DE pair and the snooker triple read from the history
// and the gamma_2 base select kept group-local.
//
// Design: the history is [H, C, D] float32 in device memory, H = n_initial +
// the iterations of the run; a partner is a direct global load at flat
// index row * C + chain, so one engine covers every population size (the
// TPU kernel's C <= 1,024 cap has no reason here).  The K1 thread layout is
// kept: one thread per chain, whole groups per block.
//
// What bounds it on an H100: at the DE-MCz flagship (C = 3, D = 31) a
// chain reads 2 history rows of 124 bytes for the DE pair or 3 for a
// snooker triple and needs ~2,000 operations -- nanoseconds of bandwidth
// or arithmetic -- but runs
// in one CTA with 3 useful threads, and the sequential sweep runs its three
// sub-sweeps one after another, each a serial chain of d = 31 loops,
// Philox blocks and transcendentals on one thread: ~28 us measured
// (PERF.md), bound by that chain's latency.  At C = 512 it moves ~25 KB and
// is bound by the launch.
#include <cuda_runtime.h>

#include <cstdint>

#include "densities/gaussian.cuh"
#include "densities/mvnormal.cuh"
#include "philox.cuh"
#include "step_body.cuh"

namespace demcmc {

template <class Density>
int launch_resample_step(float* theta, float* w, float* out_theta,
                         float* out_w, uint8_t* out_acc, int* fire,
                         float* hist, int H, const uint32_t* bits,
                         const int64_t* idx, const uint32_t* ia,
                         const float* fa, const uint32_t* sa, float theta_sn,
                         cudaStream_t stream) {
  constexpr int D = Density::D;
  const StepArgs<D> a = read_args<Density>(theta, w, out_theta, out_w, out_acc,
                                           fire, bits, ia, fa, sa, theta_sn);
  const Density dens = Density::from(fa + 7 + 2 * D, nullptr);
  const int C = a.G * a.Np;
  if (a.it < 2 || a.it > H) return (int)cudaErrorInvalidValue;
  HistoryPartners<D> src;
  src.hist = hist;
  src.idx = idx;
  src.words = WordSource{nullptr, C, ia[5], ia[6], ia[2], kResampleNs};
  src.C = C;
  src.n_slots = a.r_sn >= 0 ? 5 : 2;
  src.span = (uint32_t)(a.it - 1) * (uint32_t)C;
  return launch_sweep(a, dens, src, stream);
}

}  // namespace demcmc

// One iteration of K3 on the model's density: the K1 arguments (see
// step_body.cuh read_args) plus the history [H, C, D] and, in the
// indices-in test mode, idx [n_members * n_slots, C] int64 flat history
// indices (nullptr: drawn from Philox words).  Returns cudaGetLastError()
// after the launch.
#define RESAMPLE_STEP_ENTRY(NAME, DENSITY)                                    \
  extern "C" int resample_step_##NAME(                                       \
      float* theta, float* w, float* out_theta, float* out_w,                \
      uint8_t* out_acc, int* fire, float* hist, int H, const uint32_t* bits, \
      const int64_t* idx, const uint32_t* iargs, const float* fargs,         \
      const uint32_t* sargs, float theta_sn, void* stream) {                 \
    return demcmc::launch_resample_step<DENSITY>(                            \
        theta, w, out_theta, out_w, out_acc, fire, hist, H, bits, idx,       \
        iargs, fargs, sargs, theta_sn, (cudaStream_t)stream);                \
  }

// one entry per density of ops/_build.py KERNEL_DENSITIES["resample_step"]
RESAMPLE_STEP_ENTRY(gaussian, demcmc::GaussianDensity)
RESAMPLE_STEP_ENTRY(mvnormal30, demcmc::MvNormalDensity<30>)

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
