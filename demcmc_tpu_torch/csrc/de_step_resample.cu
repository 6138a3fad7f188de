// K3: a window of K DE-MCz iterations in one launch -- partners from the
// history of past states.
//
// Replaces the resample variant of the TPU kernel demcmc_tpu/ops/
// fused_step.py build_fused_step: the history partner fetch
// one_sweep_resample (:2224-2246) with its three engines (in-VMEM
// fetch_hist_narrow :2178, the streamed pre-gather _resample_pre :2688,
// the wide one-hot permute fetch_hist_wide :2130), the partner index draws
// _resample_idx (:2637) and the history write store_samples! (:2494-2517).
// The body is step_body.cuh's sweep kernel with the HistoryPartners source:
// the same proposal, snooker, epsilon, kappa, beta, bounds, density and MH
// tail as K1, with the DE pair and the snooker triple read from the history
// and the gamma_2 base select kept group-local.
//
// Design: the history is [H, C, D] float32 in device memory, H = n_initial +
// the iterations of the run; a partner is a direct global load at flat
// index row * C + chain, so one engine covers every population size (the
// TPU kernel's C <= 1,024 cap has no reason here).  The K1 thread layout is
// kept: one thread per chain, whole groups per block; on the 30-dim MVN a
// population of 64 chains or fewer runs L = 8 to 32 lanes a chain over the
// dimensions instead (step_body.cuh, sweep_dims.cuh).  A window of K > 1
// iterations needs every chain's history row it - 1 before iteration
// it + 1, so it runs the population in one CTA with a barrier between
// iterations, for as many chains as one block of the instantiation holds
// (its registers and the stage's shared memory: window_chains; 1,024 at
// most), and the sampler keeps K = 1 above that
// (ops/resample_step.py::resample_super_k).  On the Gaussian
// (sweep_hoist.cuh) the window runs over a thread block cluster instead:
// blocks of about one warp, whole groups each, up to 16 of them (then
// larger blocks), with the cluster barrier between iterations; one CTA of
// 512 chains held 16 warps on one SM of 132 (5.4 us an iteration, PERF.md).
//
// What bounds it on an H100: at the DE-MCz flagship (C = 3, D = 31) a
// chain reads 2 history rows of 124 bytes for the DE pair or 3 for a
// snooker triple and needs ~2,000 operations -- nanoseconds of bandwidth
// or arithmetic -- so it is bound by the latency of one iteration's
// dependent chain.  With one thread a chain that chain was the whole
// sub-sweep: d = 31 loops over arrays in local memory, 8 Philox blocks of
// epsilon words in turn, sub-sweeps one after another (~26 us an
// iteration, PERF.md).  With a warp a chain a lane draws its own words and
// does its dimension's arithmetic, the sums over the dimensions are folds
// of broadcasts (~31 dependent adds each, several at once), and past
// burn-in the three sub-sweeps run at once (sweep_dims.cuh).  At C = 512 it
// moves ~25 KB and is bound by the launch.
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
                         uint32_t chain0, int C_hist, cudaStream_t stream) {
  constexpr int D = Density::D;
  const StepArgs<D> a = read_args<Density>(theta, w, out_theta, out_w, out_acc,
                                           fire, bits, ia, fa, sa, theta_sn,
                                           chain0);
  const Density dens = Density::from(fa + 7 + 2 * D, nullptr);
  const int C = a.G * a.Np;
  if (a.it0 < 2 || a.K < 1 || a.it0 + a.K - 1 > H ||
      (long long)chain0 + C > (long long)C_hist ||
      (a.K > 1 && (chain0 != 0u || C_hist != C)))
    return (int)cudaErrorInvalidValue;
  auto fill = [&](auto& src) {
    src.hist = hist;
    src.idx = idx;
    src.words =
        WordSource{nullptr, C, ia[5], ia[6], ia[2], kResampleNs, chain0};
    src.C = C;
    src.n_slots = a.r_sn >= 0 ? 5 : 2;
    src.n_rows = a.n_blk * a.n_members * src.n_slots;
    src.span = 0;  // set per iteration (HistoryPartners::at)
  };
  if (chain0 == 0u && C_hist == C) {  // the whole population
    HistoryPartners<D> src;
    fill(src);
    return launch_sweep(a, dens, src, ia[19] != 0, stream);
  }
  HistoryPartners<D, true> src;  // a shard of a chain mesh
  fill(src);
  src.C_hist = C_hist;
  src.chain0 = chain0;
  return launch_sweep(a, dens, src, ia[19] != 0, stream);
}

}  // namespace demcmc

// One window of K iterations of K3 on the model's density: the K1
// arguments (see step_body.cuh read_args) plus the history [H, C_hist, D]
// and, in the indices-in test mode, idx [K n_blk n_members n_slots, C] int64
// flat history indices (nullptr: drawn from Philox words), then chain0 and
// C_hist: the launch's chains are chains chain0 .. chain0 + C - 1 of a
// population of C_hist (a shard of a chain mesh; 0 and C for the whole
// population), whose words they draw and whose history columns they write.
// A window of K > 1 runs the whole population (chain0 = 0, C_hist = C) in
// one CTA, or on the Gaussian in one cluster (resample_window_chains_NAME).
// Returns the launch's CUDA error code.
// resample_block_chains_NAME writes the chains one block of the
// configuration's kernel (sequential sweep, snooker, block sweeps) holds
// -- a group must fit one block -- and resample_window_chains_NAME those a
// window of the configuration with groups of Np holds, on the current
// device; each returns a CUDA error code.
#define RESAMPLE_STEP_ENTRY(NAME, DENSITY)                                    \
  extern "C" int resample_step_##NAME(                                       \
      float* theta, float* w, float* out_theta, float* out_w,                \
      uint8_t* out_acc, int* fire, float* hist, int H, const uint32_t* bits, \
      const int64_t* idx, const uint32_t* iargs, const float* fargs,         \
      const uint32_t* sargs, float theta_sn, uint32_t chain0, int C_hist,    \
      void* stream) {                                                        \
    return demcmc::launch_resample_step<DENSITY>(                            \
        theta, w, out_theta, out_w, out_acc, fire, hist, H, bits, idx,       \
        iargs, fargs, sargs, theta_sn, chain0, C_hist, (cudaStream_t)stream); \
  }                                                                          \
  extern "C" int resample_block_chains_##NAME(int seq, int snooker,          \
                                              int n_blk, int* chains) {      \
    return demcmc::block_chains_of<DENSITY,                                  \
                                   demcmc::HistoryPartners<DENSITY::D>>(     \
        seq != 0, snooker != 0, n_blk, chains);                              \
  }                                                                          \
  extern "C" int resample_window_chains_##NAME(int seq, int snooker,         \
                                               int n_blk, int Np,            \
                                               int* chains) {                \
    return demcmc::window_chains<DENSITY,                                    \
                                 demcmc::HistoryPartners<DENSITY::D>>(       \
        seq != 0, snooker != 0, n_blk, Np, chains);                          \
  }

// one entry per density of ops/_build.py KERNEL_DENSITIES["resample_step"]
RESAMPLE_STEP_ENTRY(gaussian, demcmc::GaussianDensity)
RESAMPLE_STEP_ENTRY(mvnormal30, demcmc::MvNormalDensity<30>)

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
