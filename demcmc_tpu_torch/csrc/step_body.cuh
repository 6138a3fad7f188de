// The DE sweep body shared by K1 (de_step.cu) and K3 (de_step_resample.cu).
//
// Port of the sweep of the TPU kernel demcmc_tpu/ops/fused_step.py
// build_fused_step (kernel closure :1858): run_sweeps (:2453-2475) around
// _sweep_tail (:2248-2451) -- random/fixed/variable gamma with the gamma_2
// burn-in base term, the snooker branch with its MH correction, epsilon
// noise, kappa recombination, beta mutation, bounds + NaN mask, log
// posterior, MH accept -- and the next-iteration migration gate (:2518-2532).
// The kernel is one template over a partner source: GroupPartners (K1)
// draws the DE pair and the snooker triple from the chain's words and reads
// them from its group staged in shared memory; HistoryPartners (K3) reads
// them from the history in device memory and writes the new state to
// history row it - 1.  K1 and K3 are two instantiations of this body.
//
// Layout: theta [C, D] and w [C] float32, chain c in group c / Np.  One
// thread per chain; a block holds whole groups.  The group is staged in
// shared memory, and every read of another chain (partners, softmax base)
// goes to the staged copy.  The synchronous sweep (one sub-sweep) reads
// iteration-start values and updates the state in place.  The sequential
// sweep runs Np sub-sweeps: in sub-sweep m only group slot m proposes and
// commits, writes its new theta to the stage, and __syncthreads() makes it
// visible before sub-sweep m + 1 (reference crossover.jl:12-17).
//
// Densities (csrc/densities/*.cuh) are functors over the proposal; one
// that draws noise (kNoise, the pseudo-marginal panel) also takes the
// chain's words positioned at its panel.  The dimensions of a density's
// compile-time kIntMask are snapped to integers before the bounds (as
// run-time flags, branches cost K1 measurable time on an H100, PERF.md).
//
// Rounding: built with -fmad=false so every float operation rounds like the
// plain PyTorch version (ops/fused_step.py::sweep_plain), which issues the
// same operations in the same order; sums over the d dimensions run in
// index order in both.  The group softmax CDF is the same Hillis-Steele
// segmented scan as the TPU kernel's _seg_scan.
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "philox.cuh"

namespace demcmc {

constexpr int kThreadsTarget = 64;
constexpr float kTwoPi = 6.283185307179586f;
// Draw the mutation's normals only in groups whose beta gate fired: chosen
// at compile time from the width (see the mutation in sweep_kernel).
template <int D>
constexpr bool kNormalsIfGated = D >= 8;

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
  int n_members, stride;  // sub-sweeps, rows per sub-sweep block
  uint32_t int_mask;      // integer dimensions (bit i: dimension i), held
                          // against the density's kIntMask at launch
  int r_noise;            // first row of a density's noise panel
  int r_part, r_triple, r_gamma, r_sn, r_eps, r_kappa, r_gate, r_norm, r_acc,
      r_fire;
  float fixed_g1, eps, eps2, kappa_keep, beta, sigma, alpha, theta_sn;
  float lo[D], hi[D];
};

// iargs: G, Np, it, burnin, random_gamma, seed_lo, seed_hi, then the row of
//   the partner, gamma, eps, kappa, gate, normal, accept and fire draws
//   (0xffffffff where absent).
// fargs: fixed_g1, eps, 2 eps, 1 - kappa, beta, sigma, alpha, lo[D], hi[D],
//   then the density's constants.
// sargs: sub-sweeps, rows per sub-sweep block, the snooker member-index row,
//   the snooker gamma row, the integer-dimension bit mask and the noise
//   panel's row (rows 0xffffffff where absent).
template <class Density>
StepArgs<Density::D> read_args(float* theta, float* w, float* out_theta,
                               float* out_w, uint8_t* out_acc, int* fire,
                               const uint32_t* bits, const uint32_t* ia,
                               const float* fa, const uint32_t* sa,
                               float theta_sn) {
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
  a.n_members = (int)sa[0];
  a.stride = (int)sa[1];
  a.r_triple = (int)sa[2];
  a.r_sn = (int)sa[3];
  a.int_mask = sa[4];
  a.r_noise = (int)sa[5];
  a.fixed_g1 = fa[0];
  a.eps = fa[1];
  a.eps2 = fa[2];
  a.kappa_keep = fa[3];
  a.beta = fa[4];
  a.sigma = fa[5];
  a.alpha = fa[6];
  a.theta_sn = theta_sn;
  for (int i = 0; i < D; ++i) {
    a.lo[i] = fa[7 + i];
    a.hi[i] = fa[7 + D + i];
  }
  return a;
}

// The chain being updated in a sub-sweep.
struct Slot {
  int c, p, lead, member, off;  // chain, group slot, group's first thread,
                                // sub-sweep, its row offset
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

// sum_i x[i] y[i] in index order
template <int D>
__device__ __forceinline__ float dot(const float* x, const float* y) {
  float s = x[0] * y[0];
  for (int i = 1; i < D; ++i) s = s + x[i] * y[i];
  return s;
}

// Partners from the chain's own group, staged in shared memory (K1): the
// DE pair is two distinct non-self slots (shift trick, fused_step.py:
// 2113-2125), the snooker triple three distinct slots including self
// (:2332-2339), each index drawn from one of the chain's step words.
template <int D>
struct GroupPartners {
  struct Thread {};
  __device__ __forceinline__ Thread thread(int) const { return {}; }

  __device__ __forceinline__ void pair(Thread&, ChainWords& Wc, const Slot& s,
                                       const StepArgs<D>& a, const float* stage,
                                       const float*& pm,
                                       const float*& pn) const {
    const int Np = a.Np;
    int ia = (int)(Wc(a.r_part + s.off) % (uint32_t)(Np - 1));
    int ib = (int)(Wc(a.r_part + s.off + 1) % (uint32_t)(Np - 2));
    ib += ib >= ia;
    ia += ia >= s.p;
    ib += ib >= s.p;
    pm = stage + (s.lead + ia) * D;
    pn = stage + (s.lead + ib) * D;
  }

  __device__ __forceinline__ void triple(Thread&, ChainWords& Wc,
                                         const Slot& s, const StepArgs<D>& a,
                                         const float* stage, const float*& pz,
                                         const float*& pm,
                                         const float*& pn) const {
    const int Np = a.Np;
    const int az = (int)(Wc(a.r_triple + s.off) % (uint32_t)Np);
    int bz = (int)(Wc(a.r_triple + s.off + 1) % (uint32_t)(Np - 1));
    int cz = (int)(Wc(a.r_triple + s.off + 2) % (uint32_t)(Np - 2));
    bz += bz >= az;
    const int lo = min(az, bz), hi = max(az, bz);
    cz += cz >= lo;
    cz += cz >= hi;
    pz = stage + (s.lead + az) * D;
    pm = stage + (s.lead + bz) * D;
    pn = stage + (s.lead + cz) * D;
  }

  __device__ __forceinline__ void commit(const StepArgs<D>&, int,
                                         const float*) const {}
};

// Partners from the history [H, C, D] in device memory (K3), at flat
// indices row * C + chain over the count * C past (row, chain) pairs: given
// (idx [n_members * n_slots, C], indices-in test mode) or drawn from the
// chain's Philox words of namespace RESAMPLE_NS, slot row member * n_slots +
// slot, without replacement within the pair and within the triple
// (demcmc_tpu/ops/proposals.py::resample_flat_indices).  The new state goes
// to history row it - 1 (store_samples!, fused_step.py:2494-2517); reads
// only touch rows below it - 1, so no read races the write.
template <int D>
struct HistoryPartners {
  float* hist;         // [H, C, D]
  const int64_t* idx;  // [n_members * n_slots, C] or nullptr
  WordSource words;    // RESAMPLE_NS words
  int C, n_slots;
  uint32_t span;       // count * C

  struct Thread {
    ChainWords w;
  };
  __device__ __forceinline__ Thread thread(int c) const {
    return Thread{ChainWords(words, c)};
  }

  __device__ __forceinline__ uint32_t flat(Thread& t, const Slot& s,
                                           int slot) const {
    const int row = s.member * n_slots + slot;
    return idx ? (uint32_t)idx[(size_t)row * C + s.c] : t.w(row);
  }

  __device__ __forceinline__ const float* at(uint32_t f) const {
    return hist + (size_t)f * D;
  }

  __device__ __forceinline__ void pair(Thread& t, ChainWords&, const Slot& s,
                                       const StepArgs<D>&, const float*,
                                       const float*& pm,
                                       const float*& pn) const {
    uint32_t f0 = flat(t, s, 0), f1 = flat(t, s, 1);
    if (!idx) {
      f0 = f0 % span;
      f1 = f1 % (span - 1u);
      f1 += f1 >= f0;
    }
    pm = at(f0);
    pn = at(f1);
  }

  __device__ __forceinline__ void triple(Thread& t, ChainWords&,
                                         const Slot& s, const StepArgs<D>&,
                                         const float*, const float*& pz,
                                         const float*& pm,
                                         const float*& pn) const {
    uint32_t f0 = flat(t, s, 2), f1 = flat(t, s, 3), f2 = flat(t, s, 4);
    if (!idx) {
      f0 = f0 % span;
      f1 = f1 % (span - 1u);
      f2 = f2 % (span - 2u);
      f1 += f1 >= f0;
      const uint32_t lo = min(f0, f1), hi = max(f0, f1);
      f2 += f2 >= lo;
      f2 += f2 >= hi;
    }
    pz = at(f0);
    pm = at(f1);
    pn = at(f2);
  }

  __device__ __forceinline__ void commit(const StepArgs<D>& a, int c,
                                         const float* th) const {
    float* row = hist + ((size_t)(a.it - 1) * C + c) * D;
    for (int i = 0; i < D; ++i) row[i] = th[i];
  }
};

// kSeq (the sequential sweep) and kSnooker are compile-time, so a
// configuration without them runs none of their code: as run-time flags
// they made K1 measurably slower on an H100 (PERF.md).
template <class Density, class Source, bool kSeq, bool kSnooker>
__global__ void sweep_kernel(StepArgs<Density::D> a, Density dens,
                             Source src) {
  constexpr int D = Density::D;
  extern __shared__ float sh[];
  const int T = blockDim.x, tid = threadIdx.x, Np = a.Np;
  float* s_th = sh;         // [T, D] the block's groups
  float* s_q = sh + T * D;  // [T] scan scratch
  const int p = tid % Np;
  const int lead = tid - p;
  const int g = blockIdx.x * (T / Np) + tid / Np;
  const bool valid = g < a.G;
  const int c = valid ? g * Np + p : 0;
  const WordSource& W = a.words;   // other chains' words (leader, chain 0)
  ChainWords Wc(a.words, c);       // this chain's words, rising rows
  typename Source::Thread st = src.thread(c);

  float th[D], prop[D];
  float w = 0.0f;
  for (int i = 0; i < D; ++i) th[i] = valid ? a.theta[(size_t)c * D + i] : 0.0f;
  if (valid) w = a.w[c];
  for (int i = 0; i < D; ++i) s_th[tid * D + i] = th[i];
  __syncthreads();

  // beta mutation: one gate per group and sweep, from the leader's word.
  // The sequential sweep reads it before its sub-sweeps, the synchronous
  // one next to its use, where it overlaps the proposal (K1 measured
  // faster on an H100 than with the gate read here).
  auto beta_gate = [&]() {
    return a.r_gate >= 0 && to_uni(W(a.r_gate, valid ? g * Np : 0)) <= a.beta;
  };
  const bool mut_sweep = kSeq && beta_gate();
  const bool base_phase = a.random_gamma && a.it <= a.burnin;  // block-wide
  const float half_dm1 = 0.5f * (float)(D - 1);
  bool acc_any = false;

  for (int m = 0; m < (kSeq ? a.n_members : 1); ++m) {
    if (base_phase) {
      // softmax(w) CDF over each group (every thread takes part)
      s_q[tid] = w;
      __syncthreads();
      seg_scan<false>(s_q, tid, p, Np);
      const float mx = s_q[lead + Np - 1];
      __syncthreads();
      s_q[tid] = expf(w - (isfinite(mx) ? mx : 0.0f));
      __syncthreads();
      seg_scan<true>(s_q, tid, p, Np);
    }
    // The synchronous sweep runs every thread through the body (chain 0's
    // words and a zero group for the threads past the last group, whose
    // results are never written): K1 measured faster on an H100 than with
    // the test.  The sequential sweep keeps it: its few proposing threads
    // would wait on diverging idle ones.
    if (kSeq ? valid && p == m : true) {
      const Slot s{c, p, lead, m, m * a.stride};
      const float *pm, *pn;
      src.pair(st, Wc, s, a, s_th, pm, pn);
      if (a.random_gamma) {
        const float ub = to_uni(Wc(a.r_gamma + s.off));
        const float g1 = to_uni(Wc(a.r_gamma + s.off + 1)) * 0.5f + 0.5f;
        const float g2 = to_uni(Wc(a.r_gamma + s.off + 2)) * 0.5f + 0.5f;
        float bterm[D];
        for (int i = 0; i < D; ++i) bterm[i] = 0.0f;
        if (base_phase) {
          // base chain drawn from softmax(w) over the group by inverse CDF
          const float ubs = fmaxf(ub, FLT_MIN) * s_q[lead + Np - 1];
          int cnt = 0;
          for (int o = 0; o < Np; ++o) cnt += s_q[lead + o] < ubs;
          const float* base = s_th + (lead + min(cnt, Np - 1)) * D;
          for (int i = 0; i < D; ++i) bterm[i] = g2 * (base[i] - th[i]);
        }
        for (int i = 0; i < D; ++i)
          prop[i] = (th[i] + g1 * (pm[i] - pn[i])) + bterm[i];
      } else {
        for (int i = 0; i < D; ++i)
          prop[i] = th[i] + a.fixed_g1 * (pm[i] - pn[i]);
      }

      // snooker, per chain with probability theta_sn (fused_step.py:
      // 2322-2351): project the triple's pm, pn onto theta - z
      const float* pz = nullptr;
      bool sn = false, degen = false;
      float den0 = 0.0f;
      if (kSnooker) {
        const float *pm2, *pn2;
        src.triple(st, Wc, s, a, s_th, pz, pm2, pn2);
        float sp[D];
        for (int i = 0; i < D; ++i) sp[i] = th[i] - pz[i];
        den0 = dot<D>(sp, sp);
        degen = den0 <= FLT_MIN;
        if (degen)
          for (int i = 0; i < D; ++i) sp[i] = 1.0f;
        const float dens2 = dot<D>(sp, sp);
        const float q1 = dot<D>(pm2, sp) / dens2;
        const float q2 = dot<D>(pn2, sp) / dens2;
        const float gsn = to_uni(Wc(a.r_sn + s.off)) + 1.2f;
        sn = to_uni(Wc(a.r_sn + s.off + 1)) <= a.theta_sn;
        if (sn)
          for (int i = 0; i < D; ++i)
            prop[i] = th[i] + gsn * (q1 * sp[i] - q2 * sp[i]);
      }

      if (a.r_eps >= 0)
        for (int i = 0; i < D; ++i)
          prop[i] = prop[i] + (to_uni(Wc(a.r_eps + s.off + i)) * a.eps2 - a.eps);
      if (a.r_kappa >= 0)
        for (int i = 0; i < D; ++i)
          if (!(to_uni(Wc(a.r_kappa + s.off + i)) > a.kappa_keep)) prop[i] = th[i];

      // snooker MH correction 0.5 (d - 1) (log|theta' - z|^2 - log|theta -
      // z|^2) on the final proposal; a degenerate draw z == theta proposes
      // theta and is rejected with -inf (:2374-2384)
      float adj = 0.0f;
      if (sn) {
        if (degen)
          for (int i = 0; i < D; ++i) prop[i] = th[i];
        float a1[D];
        for (int i = 0; i < D; ++i) a1[i] = prop[i] - pz[i];
        const float a1sq = dot<D>(a1, a1);
        adj = degen ? -INFINITY : half_dm1 * (logf(a1sq) - logf(den0));
      }

      // Box-Muller normals.  Narrow densities draw them in every chain and
      // let the gate select; wide ones only where the group's gate fired
      // (kNormalsIfGated: on an H100 the branch slows K1 at d = 2 and saves
      // K3 at d = 31 more than half its time).  The radii come from the
      // first d rows and then the angles, so the words are read in rising
      // rows; only the narrow synchronous sweep takes u1, u2 per dimension,
      // which K1 runs faster.
      const bool mut = kSeq ? mut_sweep : beta_gate();
      if constexpr (!kSeq && !kNormalsIfGated<D>) {
        if (a.r_gate >= 0)
          for (int i = 0; i < D; ++i) {
            const float u1 = fmaxf(to_uni(Wc(a.r_norm + s.off + i)), FLT_MIN);
            const float u2 = to_uni(Wc(a.r_norm + s.off + D + i));
            const float nrm = sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
            if (mut) prop[i] = th[i] + a.sigma * nrm;
          }
      } else if (kNormalsIfGated<D> ? mut : a.r_gate >= 0) {
        float rad[D];
        for (int i = 0; i < D; ++i)
          rad[i] = sqrtf(-2.0f * logf(fmaxf(to_uni(Wc(a.r_norm + s.off + i)),
                                            FLT_MIN)));
        for (int i = 0; i < D; ++i) {
          const float u2 = to_uni(Wc(a.r_norm + s.off + D + i));
          const float nrm = rad[i] * cosf(kTwoPi * u2);
          if (mut) prop[i] = th[i] + a.sigma * nrm;
        }
      }
      if (mut) adj = 0.0f;  // a mutation carries no snooker correction

      // integer snap (fused_step.py:2402-2410) on the density's compile-time
      // mask: rintf rounds half to even, as jnp.round and torch.round do
      if constexpr (Density::kIntMask != 0u)
        for (int i = 0; i < D; ++i)
          if ((Density::kIntMask >> i) & 1u) prop[i] = rintf(prop[i]);

      bool inb = true;
      for (int i = 0; i < D; ++i) {
        if (isfinite(a.lo[i])) inb = inb && prop[i] >= a.lo[i];
        if (isfinite(a.hi[i])) inb = inb && prop[i] <= a.hi[i];
      }
      // a density that draws noise streams its panel from the chain's words
      // (rows r_noise.. of the sub-sweep block, before the accept row)
      float lp;
      if constexpr (Density::kNoise)
        lp = dens(prop, Wc, a.r_noise + s.off);
      else
        lp = dens(prop);
      const float wp = (inb && !isnan(lp)) ? lp : -INFINITY;
      const float u = fmaxf(to_uni(Wc(a.r_acc + s.off)), FLT_MIN);
      float delta = wp - w;
      if (kSnooker) delta = delta + adj;
      const bool acc = logf(u) <= delta;
      if (acc) {
        for (int i = 0; i < D; ++i) th[i] = prop[i];
        w = wp;
      }
      acc_any = acc_any || acc;
      if (kSeq)
        for (int i = 0; i < D; ++i) s_th[tid * D + i] = th[i];
    }
    if (kSeq) __syncthreads();  // the commit, before the next sub-sweep
  }

  if (!valid) return;
  for (int i = 0; i < D; ++i) {
    a.theta[(size_t)c * D + i] = th[i];
    if (a.out_theta) a.out_theta[(size_t)c * D + i] = th[i];
  }
  a.w[c] = w;
  if (a.out_w) a.out_w[c] = w;
  if (a.out_acc) a.out_acc[c] = acc_any ? 1 : 0;
  src.commit(a, c, th);
  if (c == 0) {
    const float uf = to_uni(W(a.r_fire, 0));
    *a.fire = (a.alpha > 0.0f && uf <= a.alpha) ? 1 : 0;
  }
}

// Launch one iteration: whole groups per block, about kThreadsTarget
// threads.  Returns cudaGetLastError() after the launch.
template <class Density, class Source>
int launch_sweep(const StepArgs<Density::D>& a, const Density& dens,
                 const Source& src, cudaStream_t stream) {
  constexpr int D = Density::D;
  if (a.Np < 3 || a.Np > 1024 || a.G < 1 || a.n_members < 1)
    return (int)cudaErrorInvalidValue;
  // the model's integer dimensions must be the ones the density snaps
  if (a.int_mask != Density::kIntMask) return (int)cudaErrorInvalidValue;
  const int gpb = a.Np >= kThreadsTarget ? 1 : kThreadsTarget / a.Np;
  const int threads = gpb * a.Np;
  const int blocks = (a.G + gpb - 1) / gpb;
  const size_t smem = (size_t)threads * (D + 1) * sizeof(float);
  auto kernel = a.n_members > 1
      ? (a.r_sn >= 0 ? sweep_kernel<Density, Source, true, true>
                     : sweep_kernel<Density, Source, true, false>)
      : (a.r_sn >= 0 ? sweep_kernel<Density, Source, false, true>
                     : sweep_kernel<Density, Source, false, false>);
  kernel<<<blocks, threads, smem, stream>>>(a, dens, src);
  return (int)cudaGetLastError();
}

}  // namespace demcmc
