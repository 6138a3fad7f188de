// K1: a window of K DE-MCMC iterations over the whole population in one
// launch, partners from the chain's own group.
//
// Replaces the sweep of the TPU kernel demcmc_tpu/ops/fused_step.py
// build_fused_step (kernel closure :1858, one_sweep/_sweep_tail
// :2103-2451, run_sweeps :2453-2475, next-iteration migration gate
// :2518-2532) in its standard variant: partners and the snooker triple
// from the current group, random/fixed/variable gamma with the gamma_2
// burn-in base term, the snooker branch, epsilon noise, kappa
// recombination, beta mutation, bounds + NaN mask, log posterior, MH
// accept, synchronous or sequential sweep; and, for optimization, the
// greedy max/min accept on the objective alone (:2429-2445, with the
// min-mode clamp of the base select, :2289-2293).  The body is
// step_body.cuh's sweep kernel with the GroupPartners source; K3
// (de_step_resample.cu) is the same body over the history.  Migration is
// the separate kernel K2 (migration.cu), launched before a window whose
// first iteration's gate is open.
//
// What bounds it on an H100: at 4,096 chains one iteration moves about
// 100 KB (theta and w read, the new theta and w written, here both in place
// and as the trajectory row), which is ~30 ns at 3.35 TB/s, and does ~500
// operations per chain (five or six Philox blocks, exp/log/cos) -- also
// well under a microsecond.  At 65,536 chains with snooker it moves 1.6 MB
// (0.5 us at 3.35 TB/s) and needs ~450 operations per chain (0.4 us at the
// float32 peak), against ~6.5 us measured (PERF.md).  The kernel is bound by launch latency and by
// each thread's serial chain of dependent operations.  The design runs a
// window of K iterations per launch (up to sampler's super_k, cut where a
// migration gate opens) with no host synchronisation, keeps theta and w in
// registers across the window, draws its random words in registers
// instead of reading a pre-drawn buffer, and keeps every group-level
// reduction in shared memory.
//
// The discrete binomial's loop over its unique counts (an lgamma each) is
// split over up to 8 lanes per chain: at the cell's 256 groups of 12, 128
// blocks of 6 warps instead of 52 blocks of 2.  LBA's loop over its trials
// (two accumulators, four Phi/phi pairs and two logs per trial) and the ABC
// binomial's over its n_sim simulations (a Philox block per four of them,
// two compares each) are split over up to 32 lanes per chain (kLanes,
// step_body.cuh): at the LBA cell's 256 groups of 16 chains, 256 blocks of
// 16 warps instead of 64 blocks of 2 warps, each lane a trial a round and
// the terms folded in index order; at the ABC cell's 512 groups of 8,
// 512 blocks of 8 warps, so the Philox and compare work fills every SM.
#include <cuda_runtime.h>

#include <cstdint>

#include "densities/binomial_abc.cuh"
#include "densities/discrete_binomial.cuh"
#include "densities/gaussian.cuh"
#include "densities/lba.cuh"
#include "densities/rastrigin.cuh"
#include "philox.cuh"
#include "step_body.cuh"

namespace demcmc {

// Words (seed, it, row0 + r, chain0 + c) into out [n_rows, n]: a thread
// per Philox block of four rows and a chain, writing the block's rows that
// fall in the range; with uni, each word's uniform to_uni(w) as float bits
// (a stochastic model's noise panel).
__global__ void philox_fill_kernel(uint32_t* out, int n_rows, int n,
                                   uint32_t k0, uint32_t k1, uint32_t it,
                                   uint32_t ns, uint32_t row0,
                                   uint32_t chain0, int uni,
                                   int64_t n_threads) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_threads) return;
  const int c = (int)(i % n);
  const uint32_t blk = (row0 >> 2) + (uint32_t)(i / n);
  const uint4 b = philox_block(k0, k1, it, blk, chain0 + (uint32_t)c, ns);
  const uint32_t w[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int64_t r = (int64_t)blk * 4 + l - row0;
    if (r < 0 || r >= n_rows) continue;
    out[r * n + c] = uni ? __float_as_uint(to_uni(w[l])) : w[l];
  }
}

template <class Density, int kMode = kAcceptMH>
int launch_de_step(float* theta, float* w, float* out_theta, float* out_w,
                   uint8_t* out_acc, int* fire, const uint32_t* bits,
                   const uint32_t* ia, const float* fa, const uint32_t* sa,
                   float theta_sn, const float* dens_data, int chain0,
                   cudaStream_t stream) {
  constexpr int D = Density::D;
  const StepArgs<D> a =
      read_args<Density>(theta, w, out_theta, out_w, out_acc, fire, bits, ia,
                         fa, sa, theta_sn, (uint32_t)chain0);
  const Density dens = Density::from(fa + 7 + 2 * D, dens_data);
  return launch_sweep<Density, GroupPartners<D>, kMode>(
      a, dens, GroupPartners<D>{}, ia[19] != 0, stream);
}

}  // namespace demcmc

// One window of K iterations of K1 on the model's density (argument
// arrays and chain0: see step_body.cuh read_args; dens_data: the density's
// device buffer, or nullptr).  Returns cudaGetLastError() after the launch.
// de_step_block_chains_NAME writes the chains one block of the
// configuration's kernel (sequential sweep, snooker, block sweeps) holds on
// the current device -- a group must fit one block -- and returns a CUDA
// error code.
#define DE_STEP_ENTRY(NAME, DENSITY)                                          \
  extern "C" int de_step_##NAME(float* theta, float* w, float* out_theta,    \
                                float* out_w, uint8_t* out_acc, int* fire,   \
                                const uint32_t* bits, const uint32_t* iargs, \
                                const float* fargs, const uint32_t* sargs,   \
                                float theta_sn, const float* dens_data,      \
                                int chain0, void* stream) {                  \
    return demcmc::launch_de_step<DENSITY>(                                  \
        theta, w, out_theta, out_w, out_acc, fire, bits, iargs, fargs, sargs, \
        theta_sn, dens_data, chain0, (cudaStream_t)stream);                  \
  }                                                                          \
  extern "C" int de_step_block_chains_##NAME(int seq, int snooker, int n_blk, \
                                             int* chains) {                  \
    return demcmc::block_chains_of<DENSITY,                                  \
                                   demcmc::GroupPartners<DENSITY::D>>(       \
        seq != 0, snooker != 0, n_blk, chains);                              \
  }

// one entry per density of ops/_build.py KERNEL_DENSITIES["de_step"]
DE_STEP_ENTRY(gaussian, demcmc::GaussianDensity)
DE_STEP_ENTRY(lba, demcmc::LbaDensity)
DE_STEP_ENTRY(binomial_abc, demcmc::BinomialAbcDensity)
DE_STEP_ENTRY(discrete_binomial, demcmc::DiscreteBinomialDensity)

// K1 with the greedy accept MODE (max or min) on a density's objective:
// de_step_MODE_NAME and de_step_block_chains_MODE_NAME, as above.
#define DE_STEP_GREEDY_ENTRY(MODE, KMODE, NAME, DENSITY)                     \
  extern "C" int de_step_##MODE##_##NAME(                                    \
      float* theta, float* w, float* out_theta, float* out_w,                \
      uint8_t* out_acc, int* fire, const uint32_t* bits,                     \
      const uint32_t* iargs, const float* fargs, const uint32_t* sargs,      \
      float theta_sn, const float* dens_data, int chain0, void* stream) {    \
    return demcmc::launch_de_step<DENSITY, KMODE>(                           \
        theta, w, out_theta, out_w, out_acc, fire, bits, iargs, fargs, sargs, \
        theta_sn, dens_data, chain0, (cudaStream_t)stream);                  \
  }                                                                          \
  extern "C" int de_step_block_chains_##MODE##_##NAME(int seq, int snooker,  \
                                                      int n_blk,             \
                                                      int* chains) {         \
    return demcmc::block_chains_of<DENSITY,                                  \
                                   demcmc::GroupPartners<DENSITY::D>, KMODE>( \
        seq != 0, snooker != 0, n_blk, chains);                              \
  }

// one per mode and density of ops/_build.py GREEDY_MODES, GREEDY_DENSITIES
DE_STEP_GREEDY_ENTRY(max, demcmc::kAcceptMax, gaussian, demcmc::GaussianDensity)
DE_STEP_GREEDY_ENTRY(min, demcmc::kAcceptMin, gaussian, demcmc::GaussianDensity)
DE_STEP_GREEDY_ENTRY(max, demcmc::kAcceptMax, rastrigin,
                     demcmc::RastriginDensity)
DE_STEP_GREEDY_ENTRY(min, demcmc::kAcceptMin, rastrigin,
                     demcmc::RastriginDensity)

// Philox words (seed, it, row0 + r, chain0 + c) for r < n_rows, c < n into
// out [n_rows, n], or with uni their uniforms: the unfused step's noise
// panel of a stochastic model (rng.EVAL_NS, INIT_NOISE_NS) and a custom
// slot's key words (rng.CUSTOM_NS), and the device generator held against
// the plain torch one.
extern "C" int philox_fill(uint32_t* out, int n_rows, int n, uint32_t k0,
                           uint32_t k1, uint32_t it, uint32_t ns,
                           uint32_t row0, uint32_t chain0, int uni,
                           void* stream) {
  if (n_rows <= 0 || n <= 0) return 0;
  const uint32_t last = row0 + (uint32_t)(n_rows - 1);
  const int64_t n_blk = (int64_t)(last >> 2) - (row0 >> 2) + 1;
  const int64_t n_threads = n_blk * n;
  demcmc::philox_fill_kernel<<<(unsigned)((n_threads + 255) / 256), 256, 0,
                               (cudaStream_t)stream>>>(
      out, n_rows, n, k0, k1, it, ns, row0, chain0, uni, n_threads);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
