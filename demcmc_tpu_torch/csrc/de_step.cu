// K1: one DE-MCMC iteration over the whole population, partners from the
// chain's own group.
//
// Replaces the sweep of the TPU kernel demcmc_tpu/ops/fused_step.py
// build_fused_step (kernel closure :1858, one_sweep/_sweep_tail
// :2103-2451, run_sweeps :2453-2475, next-iteration migration gate
// :2518-2532) in its standard variant: partners and the snooker triple
// from the current group, random/fixed/variable gamma with the gamma_2
// burn-in base term, the snooker branch, epsilon noise, kappa
// recombination, beta mutation, bounds + NaN mask, log posterior, MH
// accept, synchronous or sequential sweep.  The body is step_body.cuh's
// sweep_kernel with the GroupPartners source; K3 (de_step_resample.cu) is
// the same body over the history.  Migration is the separate kernel K2
// (migration.cu), launched just before this one.
//
// What bounds it on an H100: at 4,096 chains one iteration moves about
// 100 KB (theta and w read, the new theta and w written, here both in place
// and as the trajectory row), which is ~30 ns at 3.35 TB/s, and does ~500
// operations per chain (five or six Philox blocks, exp/log/cos) -- also
// well under a microsecond.  At 65,536 chains with snooker it moves 1.6 MB
// (0.5 us at 3.35 TB/s) and needs ~450 operations per chain (0.4 us at the
// float32 peak), against ~6.5 us measured (PERF.md).  The kernel is bound by launch latency and by
// each thread's serial chain of dependent operations.  The design keeps
// one launch per iteration with no host synchronisation, draws its random
// words in registers instead of reading a pre-drawn buffer, and keeps every
// group-level reduction in shared memory.  Fewer launches (K iterations per
// launch, CUDA graphs) are later work.
//
// The densities other than the Gaussian (densities/*.cuh) run the whole
// density in the chain's thread: LBA loops over its trials (two
// accumulators, four Phi/phi pairs and two logs per trial), the ABC binomial
// over its n_sim simulations (a Philox block per four of them), the discrete
// binomial over its unique counts (an lgamma each).  There the kernel is
// bound by that serial loop on one thread per chain (4,096 threads, about
// one warp per SM quadrant), not by bytes; spreading trials or simulations
// over a warp's lanes is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "densities/binomial_abc.cuh"
#include "densities/discrete_binomial.cuh"
#include "densities/gaussian.cuh"
#include "densities/lba.cuh"
#include "philox.cuh"
#include "step_body.cuh"

namespace demcmc {

__global__ void philox_fill_kernel(uint32_t* out, int n_rows, int n,
                                   uint32_t k0, uint32_t k1, uint32_t it,
                                   uint32_t ns) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows * n) return;
  out[i] = philox_word(k0, k1, it, (uint32_t)(i / n), (uint32_t)(i % n), ns);
}

template <class Density>
int launch_de_step(float* theta, float* w, float* out_theta, float* out_w,
                   uint8_t* out_acc, int* fire, const uint32_t* bits,
                   const uint32_t* ia, const float* fa, const uint32_t* sa,
                   float theta_sn, const float* dens_data,
                   cudaStream_t stream) {
  constexpr int D = Density::D;
  const StepArgs<D> a = read_args<Density>(theta, w, out_theta, out_w, out_acc,
                                           fire, bits, ia, fa, sa, theta_sn);
  const Density dens = Density::from(fa + 7 + 2 * D, dens_data);
  return launch_sweep(a, dens, GroupPartners<D>{}, stream);
}

}  // namespace demcmc

// One iteration of K1 on the model's density (argument arrays: see
// step_body.cuh read_args; dens_data: the density's device buffer, or
// nullptr).  Returns cudaGetLastError() after the launch.
#define DE_STEP_ENTRY(NAME, DENSITY)                                          \
  extern "C" int de_step_##NAME(float* theta, float* w, float* out_theta,    \
                                float* out_w, uint8_t* out_acc, int* fire,   \
                                const uint32_t* bits, const uint32_t* iargs, \
                                const float* fargs, const uint32_t* sargs,   \
                                float theta_sn, const float* dens_data,      \
                                void* stream) {                              \
    return demcmc::launch_de_step<DENSITY>(theta, w, out_theta, out_w,       \
                                           out_acc, fire, bits, iargs,       \
                                           fargs, sargs, theta_sn,           \
                                           dens_data, (cudaStream_t)stream); \
  }

// one entry per density of ops/_build.py KERNEL_DENSITIES["de_step"]
DE_STEP_ENTRY(gaussian, demcmc::GaussianDensity)
DE_STEP_ENTRY(lba, demcmc::LbaDensity)
DE_STEP_ENTRY(binomial_abc, demcmc::BinomialAbcDensity)
DE_STEP_ENTRY(discrete_binomial, demcmc::DiscreteBinomialDensity)

// Philox words (seed, it, row, chain) for rows 0..n_rows-1, chains 0..n-1
// into out [n_rows, n] -- used to hold the device generator against the
// plain torch one.
extern "C" int philox_fill(uint32_t* out, int n_rows, int n, uint32_t k0,
                           uint32_t k1, uint32_t it, uint32_t ns,
                           void* stream) {
  const int total = n_rows * n;
  demcmc::philox_fill_kernel<<<(total + 255) / 256, 256, 0,
                               (cudaStream_t)stream>>>(out, n_rows, n, k0, k1,
                                                       it, ns);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
