// K1 over R replications in one launch (replicated runs: the JAX
// package's sample_replicated, sample_replicated_packed and
// optimize_replicated, demcmc_tpu/sampler.py:1688, 1825; demcmc_tpu/
// optimize.py:101).
//
// Replaces the TPU kernel demcmc_tpu/ops/fused_step.py build_fused_step
// (kernel closure :1858) as the JAX packed run builds it
// (demcmc_tpu/sampler.py:1764-1822): R replications' groups as one
// population of R G groups, each data leaf a per-chain constant folded
// into the kernel, migration off in the kernel.  Here the population is
// group-contiguous, replication r owning chains r c_rep .. (r + 1) c_rep -
// 1 (c_rep = G Np), and the launch takes a replication table instead of
// per-chain data: each replication's density constants ([R, n_params])
// and data buffer ([R, data_stride], LBA's trials, the binomials' tables),
// and its Philox key ([R, 2]).  A chain finds its replication once,
// r = c / c_rep (a group never spans two), and builds its density and its
// word source from row r in registers (RepPartners::bind); replication r's
// next gate goes to fire[r], from its first chain's word.  With local
// chain words each replication draws exactly its solo run's words
// (sample_replicated: bit for bit the solo run); a packed run keys every
// row by one seed with the population's chain words.
//
// The body is step_body.cuh's, through the same kernels (sweep_kernel,
// sweep_kernel_lanes, sweep_kernel_hoist) with the partner source
// RepPartners, which is K1's GroupPartners plus the table; the
// replication code is compile-time (kRepOf), so the solo instantiations
// in de_step.cu keep their code (tools/k1_ab.py compares their SASS).
//
// What bounds it on an H100: the solo K1's work, plus per chain one row
// of the table (a few floats and two key words) read once per launch.  At
// the bench's packed cell (64 replications of 4 groups of 4, 1,024
// chains) an iteration moves ~25 KB and does ~500 operations a chain:
// far under a microsecond on either bound, so the launch and each
// thread's dependent chain bound it, as for the solo K1 (PERF.md).
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

// K1's partners (GroupPartners) and the replication table.
template <int D>
struct RepPartners : GroupPartners<D> {
  static constexpr bool kRep = true;
  const uint32_t* keys;  // [R, 2] Philox key words
  const float* params;   // [R, n_params] density constants
  const float* data;     // [R, data_stride] or nullptr
  int n_params, data_stride, c_rep, local;

  __device__ __forceinline__ RepPartners at(int, int) const { return *this; }

  // chain c's replication: its density from row r of the table and, but
  // in bits-in mode (whose buffer holds the population's columns), its
  // words under key r at chain words local to it (c - r c_rep) or the
  // population's
  template <class Density>
  __device__ __forceinline__ void bind(int c, WordSource& W,
                                       Density& dens) const {
    const int r = c / c_rep;
    dens = Density::from(params + (size_t)r * n_params,
                         data ? data + (size_t)r * data_stride : nullptr);
    if (W.bits == nullptr) {
      W.k0 = keys[2 * r];
      W.k1 = keys[2 * r + 1];
      W.chain0 = local ? 0u - (uint32_t)(r * c_rep) : 0u;
    }
  }
};

template <class Density, int kMode = kAcceptMH>
int launch_de_step_rep(float* theta, float* w, float* out_theta,
                       float* out_w, uint8_t* out_acc, int* fire,
                       const uint32_t* bits, const uint32_t* ia,
                       const float* fa, const uint32_t* sa, float theta_sn,
                       const uint32_t* keys, const float* params,
                       const float* data, int n_params, int data_stride,
                       int c_rep, int local, cudaStream_t stream) {
  constexpr int D = Density::D;
  const StepArgs<D> a = read_args<Density>(theta, w, out_theta, out_w,
                                           out_acc, fire, bits, ia, fa, sa,
                                           theta_sn, 0u);
  if (c_rep < a.Np || c_rep % a.Np || (a.G * a.Np) % c_rep || n_params < 1)
    return (int)cudaErrorInvalidValue;
  RepPartners<D> src;
  src.keys = keys;
  src.params = params;
  src.data = data;
  src.n_params = n_params;
  src.data_stride = data_stride;
  src.c_rep = c_rep;
  src.local = local;
  // the table lies in device memory: every chain binds its own density
  const Density dens{};
  return launch_sweep<Density, RepPartners<D>, kMode>(a, dens, src,
                                                      ia[19] != 0, stream);
}

}  // namespace demcmc

// One window of K iterations of every replication (the arguments of
// de_step.cu's entries, then the table: keys [R, 2] uint32, params [R,
// n_params], data [R, data_stride] or nullptr, c_rep chains a replication,
// local != 0 for chain words local to each; fire is [R]).  Returns
// cudaGetLastError() after the launch.  de_step_rep_block_chains_NAME:
// the chains one block of the configuration's replicated kernel holds.
#define DE_STEP_REP_ENTRY(NAME, KMODE, DENSITY)                              \
  extern "C" int de_step_rep_##NAME(                                         \
      float* theta, float* w, float* out_theta, float* out_w,                \
      uint8_t* out_acc, int* fire, const uint32_t* bits,                     \
      const uint32_t* iargs, const float* fargs, const uint32_t* sargs,      \
      float theta_sn, const uint32_t* keys, const float* params,             \
      const float* data, int n_params, int data_stride, int c_rep,           \
      int local, void* stream) {                                             \
    return demcmc::launch_de_step_rep<DENSITY, KMODE>(                       \
        theta, w, out_theta, out_w, out_acc, fire, bits, iargs, fargs, sargs, \
        theta_sn, keys, params, data, n_params, data_stride, c_rep, local,   \
        (cudaStream_t)stream);                                               \
  }                                                                          \
  extern "C" int de_step_rep_block_chains_##NAME(int seq, int snooker,       \
                                                 int n_blk, int* chains) {   \
    return demcmc::block_chains_of<DENSITY,                                  \
                                   demcmc::RepPartners<DENSITY::D>, KMODE>(  \
        seq != 0, snooker != 0, n_blk, chains);                              \
  }

// one entry per density and accept of de_step.cu (ops/_build.py
// KERNEL_DENSITIES["de_step"], GREEDY_MODES x GREEDY_DENSITIES)
DE_STEP_REP_ENTRY(gaussian, demcmc::kAcceptMH, demcmc::GaussianDensity)
DE_STEP_REP_ENTRY(lba, demcmc::kAcceptMH, demcmc::LbaDensity)
DE_STEP_REP_ENTRY(binomial_abc, demcmc::kAcceptMH, demcmc::BinomialAbcDensity)
DE_STEP_REP_ENTRY(discrete_binomial, demcmc::kAcceptMH,
                  demcmc::DiscreteBinomialDensity)
DE_STEP_REP_ENTRY(max_gaussian, demcmc::kAcceptMax, demcmc::GaussianDensity)
DE_STEP_REP_ENTRY(min_gaussian, demcmc::kAcceptMin, demcmc::GaussianDensity)
DE_STEP_REP_ENTRY(max_rastrigin, demcmc::kAcceptMax, demcmc::RastriginDensity)
DE_STEP_REP_ENTRY(min_rastrigin, demcmc::kAcceptMin, demcmc::RastriginDensity)

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
