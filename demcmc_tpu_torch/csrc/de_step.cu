// K1: one synchronous DE-MCMC iteration over the whole population.
//
// Replaces the sweep of the TPU kernel demcmc_tpu/ops/fused_step.py
// build_fused_step (kernel closure :1858, one_sweep/_sweep_tail
// :2103-2451, next-iteration migration gate :2518-2532) in its standard
// variant: partners from the current group, random/fixed/variable gamma
// with the gamma_2 burn-in base term, epsilon noise, kappa recombination,
// beta mutation, bounds + NaN mask, log posterior, MH accept.  Migration
// is the separate kernel K2 (migration.cu), launched just before this one.
//
// Layout: theta [C, D] and w [C] float32, chain c in group c / Np.  One
// thread per chain; a block holds whole groups.  The synchronous sweep
// reads iteration-start values, so the group is staged in shared memory
// first and every read of another chain (partners, softmax base) goes to
// the staged copy; the state is then updated in place.
//
// What bounds it on an H100: at 4,096 chains one iteration moves about
// 100 KB (theta and w read, the new theta and w written, here both in place
// and as the trajectory row), which is ~30 ns at 3.35 TB/s, and does ~1 k
// operations per chain (five or six Philox blocks, exp/log/cos) -- also
// well under a microsecond.  The kernel is
// bound by launch latency.  The design keeps one launch per iteration with
// no host synchronisation, draws its random words in registers instead of
// reading a pre-drawn buffer, and keeps every group-level reduction in
// shared memory.  Fewer launches (K iterations per launch, CUDA graphs)
// are later work.
//
// Rounding: built with -fmad=false so every float operation rounds like
// the plain PyTorch version in ops/fused_step.py, which issues the same
// operations in the same order.  The group softmax CDF is the same
// Hillis-Steele segmented scan as the TPU kernel's _seg_scan.
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "densities/gaussian.cuh"
#include "philox.cuh"

namespace demcmc {

constexpr int kThreadsTarget = 64;
constexpr float kTwoPi = 6.283185307179586f;

template <int D>
struct StepArgs {
  float* theta;      // [C, D] state, updated in place
  float* w;          // [C]
  float* out_theta;  // [C, D] trajectory row, or nullptr
  float* out_w;      // [C] or nullptr
  uint8_t* out_acc;  // [C] or nullptr
  int* fire;         // [1] next iteration's migration gate (written)
  WordSource words;
  int G, Np, it, burnin, random_gamma;
  int r_part, r_gamma, r_eps, r_kappa, r_gate, r_norm, r_acc, r_fire;
  float fixed_g1, eps, eps2, kappa_keep, beta, sigma, alpha;
  float lo[D], hi[D];
};

// max that propagates NaN, like jnp.maximum / torch.maximum (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// Inclusive Hillis-Steele scan within Np-thread segments of s (the TPU
// kernel's _seg_scan: x[p] = op(x[p], x[p-k]) for p >= k, k = 1, 2, 4...).
template <bool kAdd>
__device__ __forceinline__ void seg_scan(float* s, int tid, int p, int Np) {
  for (int k = 1; k < Np; k <<= 1) {
    const float v = (p >= k) ? s[tid - k] : 0.0f;
    __syncthreads();
    if (p >= k) s[tid] = kAdd ? s[tid] + v : nan_max(s[tid], v);
    __syncthreads();
  }
}

template <class Density>
__global__ void de_step_kernel(StepArgs<Density::D> a, Density dens) {
  constexpr int D = Density::D;
  extern __shared__ float sh[];
  const int T = blockDim.x, tid = threadIdx.x, Np = a.Np;
  float* s_th = sh;         // [T, D] iteration-start theta of the block
  float* s_q = sh + T * D;  // [T] scan scratch
  const int p = tid % Np;
  const int lead = tid - p;
  const int g = blockIdx.x * (T / Np) + tid / Np;
  const bool valid = g < a.G;
  const int c = valid ? g * Np + p : 0;
  const WordSource& W = a.words;   // other chains' words (leader, chain 0)
  ChainWords Wc(a.words, c);       // this chain's words, rising rows

  float th[D], prop[D];
  float w = 0.0f;
  for (int i = 0; i < D; ++i) th[i] = valid ? a.theta[(size_t)c * D + i] : 0.0f;
  if (valid) w = a.w[c];
  for (int i = 0; i < D; ++i) s_th[tid * D + i] = th[i];
  __syncthreads();

  // two distinct non-self partners (shift trick, fused_step.py:2113-2125)
  int ia = (int)(Wc(a.r_part) % (uint32_t)(Np - 1));
  int ib = (int)(Wc(a.r_part + 1) % (uint32_t)(Np - 2));
  ib += ib >= ia;
  ia += ia >= p;
  ib += ib >= p;
  const float* pm = s_th + (lead + ia) * D;
  const float* pn = s_th + (lead + ib) * D;

  if (a.random_gamma) {
    const float ub = to_uni(Wc(a.r_gamma));
    const float g1 = to_uni(Wc(a.r_gamma + 1)) * 0.5f + 0.5f;
    const float g2 = to_uni(Wc(a.r_gamma + 2)) * 0.5f + 0.5f;
    float bterm[D];
    for (int i = 0; i < D; ++i) bterm[i] = 0.0f;
    if (a.it <= a.burnin) {  // block-uniform: every thread takes it
      // base chain drawn from softmax(w) over the group by inverse CDF
      s_q[tid] = w;
      __syncthreads();
      seg_scan<false>(s_q, tid, p, Np);
      const float mx = s_q[lead + Np - 1];
      __syncthreads();
      s_q[tid] = expf(w - (isfinite(mx) ? mx : 0.0f));
      __syncthreads();
      seg_scan<true>(s_q, tid, p, Np);
      const float ubs = fmaxf(ub, FLT_MIN) * s_q[lead + Np - 1];
      int cnt = 0;
      for (int o = 0; o < Np; ++o) cnt += s_q[lead + o] < ubs;
      const float* base = s_th + (lead + min(cnt, Np - 1)) * D;
      for (int i = 0; i < D; ++i) bterm[i] = g2 * (base[i] - th[i]);
    }
    for (int i = 0; i < D; ++i)
      prop[i] = (th[i] + g1 * (pm[i] - pn[i])) + bterm[i];
  } else {
    for (int i = 0; i < D; ++i) prop[i] = th[i] + a.fixed_g1 * (pm[i] - pn[i]);
  }

  if (a.r_eps >= 0)
    for (int i = 0; i < D; ++i)
      prop[i] = prop[i] + (to_uni(Wc(a.r_eps + i)) * a.eps2 - a.eps);
  if (a.r_kappa >= 0)
    for (int i = 0; i < D; ++i)
      if (!(to_uni(Wc(a.r_kappa + i)) > a.kappa_keep)) prop[i] = th[i];
  if (a.r_gate >= 0) {
    // beta mutation, one gate per group from the leader's word
    const bool mut = to_uni(W(a.r_gate, valid ? g * Np : 0)) <= a.beta;
    for (int i = 0; i < D; ++i) {
      const float u1 = fmaxf(to_uni(Wc(a.r_norm + i)), FLT_MIN);
      const float u2 = to_uni(Wc(a.r_norm + D + i));
      const float nrm = sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
      if (mut) prop[i] = th[i] + a.sigma * nrm;
    }
  }

  bool inb = true;
  for (int i = 0; i < D; ++i) {
    if (isfinite(a.lo[i])) inb = inb && prop[i] >= a.lo[i];
    if (isfinite(a.hi[i])) inb = inb && prop[i] <= a.hi[i];
  }
  const float lp = dens(prop);
  const float wp = (inb && !isnan(lp)) ? lp : -INFINITY;
  const float u = fmaxf(to_uni(Wc(a.r_acc)), FLT_MIN);
  const bool acc = logf(u) <= wp - w;

  if (!valid) return;
  for (int i = 0; i < D; ++i) {
    const float v = acc ? prop[i] : th[i];
    a.theta[(size_t)c * D + i] = v;
    if (a.out_theta) a.out_theta[(size_t)c * D + i] = v;
  }
  const float nw = acc ? wp : w;
  a.w[c] = nw;
  if (a.out_w) a.out_w[c] = nw;
  if (a.out_acc) a.out_acc[c] = acc ? 1 : 0;
  if (c == 0) {
    const float uf = to_uni(W(a.r_fire, 0));
    *a.fire = (a.alpha > 0.0f && uf <= a.alpha) ? 1 : 0;
  }
}

template <class Density>
int launch_de_step(float* theta, float* w, float* out_theta, float* out_w,
                   uint8_t* out_acc, int* fire, const uint32_t* bits,
                   const uint32_t* ia, const float* fa, cudaStream_t stream) {
  constexpr int D = Density::D;
  StepArgs<D> a;
  a.theta = theta;
  a.w = w;
  a.out_theta = out_theta;
  a.out_w = out_w;
  a.out_acc = out_acc;
  a.fire = fire;
  a.G = (int)ia[0];
  a.Np = (int)ia[1];
  a.it = (int)ia[2];
  a.burnin = (int)ia[3];
  a.random_gamma = (int)ia[4];
  a.words = WordSource{bits, a.G * a.Np, ia[5], ia[6], ia[2]};
  a.r_part = (int)ia[7];
  a.r_gamma = (int)ia[8];
  a.r_eps = (int)ia[9];
  a.r_kappa = (int)ia[10];
  a.r_gate = (int)ia[11];
  a.r_norm = (int)ia[12];
  a.r_acc = (int)ia[13];
  a.r_fire = (int)ia[14];
  a.fixed_g1 = fa[0];
  a.eps = fa[1];
  a.eps2 = fa[2];
  a.kappa_keep = fa[3];
  a.beta = fa[4];
  a.sigma = fa[5];
  a.alpha = fa[6];
  for (int i = 0; i < D; ++i) {
    a.lo[i] = fa[7 + i];
    a.hi[i] = fa[7 + D + i];
  }
  const Density dens = Density::from(fa + 7 + 2 * D);
  if (a.Np < 3 || a.Np > 1024 || a.G < 1) return (int)cudaErrorInvalidValue;
  const int gpb = a.Np >= kThreadsTarget ? 1 : kThreadsTarget / a.Np;
  const int threads = gpb * a.Np;
  const int blocks = (a.G + gpb - 1) / gpb;
  const size_t smem = (size_t)threads * (D + 1) * sizeof(float);
  de_step_kernel<Density><<<blocks, threads, smem, stream>>>(a, dens);
  return (int)cudaGetLastError();
}

__global__ void philox_fill_kernel(uint32_t* out, int n_rows, int n,
                                   uint32_t k0, uint32_t k1, uint32_t it,
                                   uint32_t ns) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows * n) return;
  out[i] = philox_word(k0, k1, it, (uint32_t)(i / n), (uint32_t)(i % n), ns);
}

}  // namespace demcmc

// iargs: G, Np, it, burnin, random_gamma, seed_lo, seed_hi, then the row of
//   the partner, gamma, eps, kappa, gate, normal, accept and fire draws
//   (0xffffffff where absent).
// fargs: fixed_g1, eps, 2 eps, 1 - kappa, beta, sigma, alpha, lo[D], hi[D],
//   then the density's constants.
// Returns cudaGetLastError() after the launch.
extern "C" int de_step_gaussian(float* theta, float* w, float* out_theta,
                                float* out_w, uint8_t* out_acc, int* fire,
                                const uint32_t* bits, const uint32_t* iargs,
                                const float* fargs, void* stream) {
  return demcmc::launch_de_step<demcmc::GaussianDensity>(
      theta, w, out_theta, out_w, out_acc, fire, bits, iargs, fargs,
      (cudaStream_t)stream);
}

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
