// The DE sweep body shared by K1 (de_step.cu) and K3 (de_step_resample.cu).
//
// Port of the sweep of the TPU kernel demcmc_tpu/ops/fused_step.py
// build_fused_step (kernel closure :1858): run_sweeps (:2453-2475) around
// _sweep_tail (:2248-2451) -- random/fixed/variable gamma with the gamma_2
// burn-in base term, the snooker branch with its MH correction, epsilon
// noise, kappa recombination, beta mutation, bounds + NaN mask, log
// posterior, MH accept -- and the next-iteration migration gate (:2518-2532).
// The accept mode is a template value: MH on the log posterior, or, for
// optimization, the greedy max/min accept on the density's objective alone
// (the TPU kernel's mode 'max'/'min': out of bounds or NaN scores -inf/+inf,
// :2429; the accept row is read in every mode, :2436; w' > w or w' < w with
// no snooker correction, :2442-2445; min mode clamps the weights of the
// gamma_2 base select, :2289-2293).
//
// A launch runs a window of K iterations it0 .. it0 + K - 1 (the TPU
// kernel's grid over K, :2618): theta and w stay in registers from one
// iteration to the next, iteration it0 + k reads its words at Philox
// counter it0 + k (bits-in mode: rows k n_words .. of a [K n_words, C]
// buffer, as the interpret-mode kernel_call feeds them, :2717-2735), and a
// trajectory row is written only for the iterations the emission rule
// keeps (emit='all', 'last' and ('stride', s), :2560-2575: local iteration
// k is kept iff k >= emit_first and (k - emit_first) % emit_stride == 0).
// The state goes to device memory once, at the end, and the gate once,
// from the last iteration's word.  Migration is never inside a window: the
// sampler cuts windows where a gate opens (sampler.plan_windows) and
// launches K2 between them, so groups stay independent within a window
// and the window is bitwise equal to K one-iteration launches.  kPost (the
// TPU kernel's phase='post', :2250-2276) statically drops the gamma_2
// base select, for windows past burn-in.
// Constant blocks (the TPU kernel's block sweeps, :2479-2488): with a
// compile-time block count kNBlk > 1 an iteration runs the whole sweep
// once per block, each from the state the earlier blocks left, on its own
// rows (blk_stride apart) and, in K3, its own partner slot sets; the
// block's bit mask keeps the crossover or snooker proposal to its
// dimensions after the recombination and before the snooker correction
// (:2360-2372), the mutation ignores it, and the last block's accepts are
// recorded.  kNBlk = 1 is the unblocked kernel, with no block code.
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
// Densities (csrc/densities/*.cuh) are functors over the proposal: the log
// posterior (operator()) and, for a density with a greedy instantiation,
// its objective (like(), the loglike with no prior); one that draws noise
// (kNoise, the pseudo-marginal panel) also takes the chain's words
// positioned at its panel.  The dimensions of a density's
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
// accept modes (ops/fused_step.py accept_mode: 'mh', 'max', 'min')
constexpr int kAcceptMH = 0, kAcceptMax = 1, kAcceptMin = 2;
// min mode's clamp of +inf weights in the base select (fused_step.py:2292)
constexpr float kMinModeClamp = 3.0e38f;
constexpr int kMaxBlocks = 2;  // block counts built: 1 (none) and 2
constexpr float kTwoPi = 6.283185307179586f;
// Draw the mutation's normals only in groups whose beta gate fired: chosen
// at compile time from the width (see the mutation in sweep_kernel).
template <int D>
constexpr bool kNormalsIfGated = D >= 8;

template <int D>
struct StepArgs {
  float* theta;      // [C, D] state, updated in place
  float* w;          // [C]
  float* out_theta;  // [T, C, D] trajectory rows (T emitted), or nullptr
  float* out_w;      // [T, C] or nullptr
  uint8_t* out_acc;  // [T, C] or nullptr
  int* fire;         // [1] next iteration's migration gate (written)
  WordSource words;  // the window's first iteration's words
  int G, Np, it0, burnin, random_gamma;
  int K, emit_first, emit_stride, n_words;  // the window
  int n_members, stride;  // sub-sweeps, rows per sub-sweep block
  uint32_t int_mask;      // integer dimensions (bit i: dimension i), held
                          // against the density's kIntMask at launch
  int r_noise;            // first row of a density's noise panel
  int r_part, r_triple, r_gamma, r_sn, r_eps, r_kappa, r_gate, r_norm, r_acc,
      r_fire;
  int n_blk, blk_stride;          // block sweeps, rows per block sweep
  uint32_t blk_mask[kMaxBlocks];  // each block's dimensions (bit i: dim i)
  float fixed_g1, eps, eps2, kappa_keep, beta, sigma, alpha, theta_sn;
  float lo[D], hi[D];
};

// iargs: G, Np, it0, burnin, random_gamma, seed_lo, seed_hi, then the row of
//   the partner, gamma, eps, kappa, gate, normal, accept and fire draws
//   (0xffffffff where absent), then the window: K, emit_first, emit_stride,
//   words per iteration and the phase (1: post), then the chains of the
//   population (a row of the bits-in buffer).
// chain0: the launch's first chain in the population (a shard of a chain
//   mesh; 0 for the whole population): G, Np and the state are the
//   launch's, the words those of chains chain0 .. (philox.cuh).
// fargs: fixed_g1, eps, 2 eps, 1 - kappa, beta, sigma, alpha, lo[D], hi[D],
//   then the density's constants.
// sargs: sub-sweeps, rows per sub-sweep block, the snooker member-index row,
//   the snooker gamma row, the integer-dimension bit mask, the noise
//   panel's row (rows 0xffffffff where absent), the block sweeps, rows per
//   block sweep, then each block's dimension bit mask (none for one).
template <class Density>
StepArgs<Density::D> read_args(float* theta, float* w, float* out_theta,
                               float* out_w, uint8_t* out_acc, int* fire,
                               const uint32_t* bits, const uint32_t* ia,
                               const float* fa, const uint32_t* sa,
                               float theta_sn, uint32_t chain0) {
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
  a.it0 = (int)ia[2];
  a.burnin = (int)ia[3];
  a.random_gamma = (int)ia[4];
  a.words =
      WordSource{bits, (int)ia[20], ia[5], ia[6], ia[2], kStepNs, chain0};
  a.r_part = (int)ia[7];
  a.r_gamma = (int)ia[8];
  a.r_eps = (int)ia[9];
  a.r_kappa = (int)ia[10];
  a.r_gate = (int)ia[11];
  a.r_norm = (int)ia[12];
  a.r_acc = (int)ia[13];
  a.r_fire = (int)ia[14];
  a.K = (int)ia[15];
  a.emit_first = (int)ia[16];
  a.emit_stride = (int)ia[17];
  a.n_words = (int)ia[18];
  a.n_members = (int)sa[0];
  a.stride = (int)sa[1];
  a.r_triple = (int)sa[2];
  a.r_sn = (int)sa[3];
  a.int_mask = sa[4];
  a.r_noise = (int)sa[5];
  a.n_blk = (int)sa[6];
  a.blk_stride = (int)sa[7];
  for (int b = 0; b < kMaxBlocks; ++b)
    a.blk_mask[b] = (a.n_blk > 1 && b < a.n_blk) ? sa[8 + b] : ~0u;
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
  int set;                      // partner slot set: block * n_members + member
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
  static constexpr bool kOneCta = false;
  struct Thread {};
  __device__ __forceinline__ GroupPartners at(int, int) const { return *this; }
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

  __device__ __forceinline__ void commit(int, int, const float*) const {}
};

// Partners from the history [H, C, D] in device memory (K3), at flat
// indices row * C + chain over the count * C past (row, chain) pairs: given
// (idx [K n_rows, C] with n_rows = n_blk * n_members * n_slots, indices-in
// test mode) or drawn from the chain's Philox words of namespace
// RESAMPLE_NS, slot row set * n_slots + slot (set: block-major, then
// member), without replacement within the pair and within the triple
// (demcmc_tpu/ops/proposals.py::resample_flat_indices).
// The new state goes to history row it - 1 (store_samples!, fused_step.py:
// 2494-2517); an iteration reads only rows below it - 1, so no read races
// the write.  Iteration it + 1 may read row it - 1 of any chain, so a
// window of K > 1 runs the whole population in one CTA (kOneCta) with a
// barrier between iterations.
template <int D>
struct HistoryPartners {
  static constexpr bool kOneCta = true;
  float* hist;         // [H, C, D]
  const int64_t* idx;  // [K n_rows, C] or nullptr
  WordSource words;    // RESAMPLE_NS words
  int C, n_slots, n_rows;
  uint32_t span;       // count * C

  // the source of window iteration k (iteration it)
  __device__ __forceinline__ HistoryPartners at(int k, int it) const {
    HistoryPartners s = *this;
    s.words = words.at(k, (uint32_t)it, 0);
    if (idx) s.idx = idx + (size_t)k * n_rows * C;
    s.span = (uint32_t)(it - 1) * (uint32_t)C;
    return s;
  }

  struct Thread {
    ChainWords w;
  };
  __device__ __forceinline__ Thread thread(int c) const {
    return Thread{ChainWords(words, c)};
  }

  __device__ __forceinline__ uint32_t flat(Thread& t, const Slot& s,
                                           int slot) const {
    const int row = s.set * n_slots + slot;
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

  __device__ __forceinline__ void commit(int it, int c, const float* th) const {
    float* row = hist + ((size_t)(it - 1) * C + c) * D;
    for (int i = 0; i < D; ++i) row[i] = th[i];
  }
};

// kSeq (the sequential sweep), kSnooker, kPost, kNBlk and kMode (the
// accept) are compile-time, so a configuration without them runs none of
// their code: as run-time flags they made K1 measurably slower on an H100
// (PERF.md).
template <class Density, class Source, bool kSeq, bool kSnooker, bool kPost,
          int kNBlk, int kMode = kAcceptMH>
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
  const size_t C = (size_t)a.G * Np;

  float th[D], prop[D];
  float w = 0.0f;
  for (int i = 0; i < D; ++i) th[i] = valid ? a.theta[(size_t)c * D + i] : 0.0f;
  if (valid) w = a.w[c];
  for (int i = 0; i < D; ++i) s_th[tid * D + i] = th[i];
  __syncthreads();

  const float half_dm1 = 0.5f * (float)(D - 1);
  int t_out = 0;  // trajectory rows written so far
  for (int k = 0; k < a.K; ++k) {
    const int it = a.it0 + k;
    const WordSource W = a.words.at(k, (uint32_t)it, a.n_words);
    ChainWords Wc(W, c);  // this chain's words, rising rows
    const Source sk = src.at(k, it);
    typename Source::Thread st = sk.thread(c);

    const bool base_phase = !kPost && a.random_gamma && it <= a.burnin;
    bool acc_any = false;

    for (int b = 0; b < kNBlk; ++b) {
      const int bo = b * a.blk_stride;  // the block sweep's first row
      // beta mutation: one gate per group and sweep, from the leader's word
      // (W adds chain0: the leader's index in the population).
      // The sequential sweep reads it before its sub-sweeps, the synchronous
      // one next to its use, where it overlaps the proposal (K1 measured
      // faster on an H100 than with the gate read here).
      auto beta_gate = [&]() {
        return a.r_gate >= 0 &&
               to_uni(W(a.r_gate + bo, valid ? g * Np : 0)) <= a.beta;
      };
      const bool mut_sweep = kSeq && beta_gate();
      acc_any = false;  // the last block's accepts are recorded

      for (int m = 0; m < (kSeq ? a.n_members : 1); ++m) {
        if (base_phase) {
          // softmax(w) CDF over each group (every thread takes part); min
          // mode's +inf weights (out-of-bounds scores) clamped, so the
          // exponentials stay finite
          const float wb = kMode == kAcceptMin ? fminf(w, kMinModeClamp) : w;
          s_q[tid] = wb;
          __syncthreads();
          seg_scan<false>(s_q, tid, p, Np);
          const float mx = s_q[lead + Np - 1];
          __syncthreads();
          s_q[tid] = expf(wb - (isfinite(mx) ? mx : 0.0f));
          __syncthreads();
          seg_scan<true>(s_q, tid, p, Np);
        }
        // The synchronous sweep runs every thread through the body (chain 0's
        // words and a zero group for the threads past the last group, whose
        // results are never written): K1 measured faster on an H100 than
        // with the test.  The sequential sweep keeps it: its few proposing
        // threads would wait on diverging idle ones.
        if (kSeq ? valid && p == m : true) {
          const Slot s{c, p, lead, m, bo + m * a.stride, b * a.n_members + m};
          const float *pm, *pn;
          sk.pair(st, Wc, s, a, s_th, pm, pn);
          if (a.random_gamma) {
            const float ub = to_uni(Wc(a.r_gamma + s.off));
            const float g1 = to_uni(Wc(a.r_gamma + s.off + 1)) * 0.5f + 0.5f;
            const float g2 = to_uni(Wc(a.r_gamma + s.off + 2)) * 0.5f + 0.5f;
            // past burn-in the base term is +0.0 and is still added: the add
            // turns -0.0 into +0.0, as in the TPU kernel's post variant
            // (fused_step.py:2262-2275), so kPost changes no bit
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
            sk.triple(st, Wc, s, a, s_th, pz, pm2, pn2);
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
              prop[i] = prop[i] +
                        (to_uni(Wc(a.r_eps + s.off + i)) * a.eps2 - a.eps);
          if (a.r_kappa >= 0)
            for (int i = 0; i < D; ++i)
              if (!(to_uni(Wc(a.r_kappa + s.off + i)) > a.kappa_keep))
                prop[i] = th[i];
          // the block's dimensions only (reset!, crossover.jl:336-352); a
          // static index into the masks (b is 0 or 1)
          if constexpr (kNBlk > 1) {
            const uint32_t keep = b == 0 ? a.blk_mask[0] : a.blk_mask[1];
            for (int i = 0; i < D; ++i)
              if (!((keep >> i) & 1u)) prop[i] = th[i];
          }

          // snooker MH correction 0.5 (d - 1) (log|theta' - z|^2 - log|theta -
          // z|^2) on the final proposal; a degenerate draw z == theta
          // proposes theta and is rejected with -inf (:2374-2384)
          float adj = 0.0f;
          if (sn) {
            if (degen)
              for (int i = 0; i < D; ++i) prop[i] = th[i];
            float a1[D];
            for (int i = 0; i < D; ++i) a1[i] = prop[i] - pz[i];
            const float a1sq = dot<D>(a1, a1);
            adj = degen ? -INFINITY : half_dm1 * (logf(a1sq) - logf(den0));
          }

          // Box-Muller normals.  Narrow densities draw them in every chain
          // and let the gate select; wide ones only where the group's gate
          // fired (kNormalsIfGated: on an H100 the branch slows K1 at d = 2
          // and saves K3 at d = 31 more than half its time).  The radii come
          // from the first d rows and then the angles, so the words are read
          // in rising rows; only the narrow synchronous sweep takes u1, u2
          // per dimension, which K1 runs faster.
          const bool mut = kSeq ? mut_sweep : beta_gate();
          if constexpr (!kSeq && !kNormalsIfGated<D>) {
            if (a.r_gate >= 0)
              for (int i = 0; i < D; ++i) {
                const float u1 =
                    fmaxf(to_uni(Wc(a.r_norm + s.off + i)), FLT_MIN);
                const float u2 = to_uni(Wc(a.r_norm + s.off + D + i));
                const float nrm = sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
                if (mut) prop[i] = th[i] + a.sigma * nrm;
              }
          } else if (kNormalsIfGated<D> ? mut : a.r_gate >= 0) {
            float rad[D];
            for (int i = 0; i < D; ++i)
              rad[i] = sqrtf(-2.0f *
                             logf(fmaxf(to_uni(Wc(a.r_norm + s.off + i)),
                                        FLT_MIN)));
            for (int i = 0; i < D; ++i) {
              const float u2 = to_uni(Wc(a.r_norm + s.off + D + i));
              const float nrm = rad[i] * cosf(kTwoPi * u2);
              if (mut) prop[i] = th[i] + a.sigma * nrm;
            }
          }
          if (mut) adj = 0.0f;  // a mutation carries no snooker correction

          // integer snap (fused_step.py:2402-2410) on the density's
          // compile-time mask: rintf rounds half to even, as jnp.round and
          // torch.round do
          if constexpr (Density::kIntMask != 0u)
            for (int i = 0; i < D; ++i)
              if ((Density::kIntMask >> i) & 1u) prop[i] = rintf(prop[i]);

          bool inb = true;
          for (int i = 0; i < D; ++i) {
            if (isfinite(a.lo[i])) inb = inb && prop[i] >= a.lo[i];
            if (isfinite(a.hi[i])) inb = inb && prop[i] <= a.hi[i];
          }
          // a density that draws noise streams its panel from the chain's
          // words (rows r_noise.. of the sub-sweep block, before the accept
          // row); the greedy modes score the objective alone
          float lp;
          if constexpr (kMode != kAcceptMH)
            lp = dens.like(prop);
          else if constexpr (Density::kNoise)
            lp = dens(prop, Wc, a.r_noise + s.off);
          else
            lp = dens(prop);
          const float bad = kMode == kAcceptMin ? INFINITY : -INFINITY;
          const float wp = (inb && !isnan(lp)) ? lp : bad;
          // the accept word, read in every mode (the layout is the same)
          const float u = fmaxf(to_uni(Wc(a.r_acc + s.off)), FLT_MIN);
          bool acc;
          if constexpr (kMode == kAcceptMH) {
            float delta = wp - w;
            if (kSnooker) delta = delta + adj;
            acc = logf(u) <= delta;
          } else if constexpr (kMode == kAcceptMax) {
            acc = wp > w;
          } else {
            acc = wp < w;
          }
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
      if constexpr (kNBlk > 1 && !kSeq) {
        // the next block reads this one's state: the synchronous sweep's
        // stage is refreshed between two barriers, as between iterations
        if (b + 1 < kNBlk) {
          __syncthreads();
          for (int i = 0; i < D; ++i) s_th[tid * D + i] = th[i];
          __syncthreads();
        }
      }
    }  // block sweeps

    const bool emit =
        k >= a.emit_first && (k - a.emit_first) % a.emit_stride == 0;
    if (valid) {
      if (emit) {
        const size_t row = (size_t)t_out * C + c;
        if (a.out_theta)
          for (int i = 0; i < D; ++i) a.out_theta[row * D + i] = th[i];
        if (a.out_w) a.out_w[row] = w;
        if (a.out_acc) a.out_acc[row] = acc_any ? 1 : 0;
      }
      sk.commit(it, c, th);
    }
    t_out += emit;
    if (k + 1 < a.K) {
      // the next iteration reads this one's state: every read of the stage
      // (and, in K3, the history row just written) is done before the
      // synchronous sweep refreshes the stage, and the refresh is seen
      // before the next reads.  The sequential sweep's stage is current.
      __syncthreads();
      if (!kSeq)
        for (int i = 0; i < D; ++i) s_th[tid * D + i] = th[i];
      __syncthreads();
    }
  }

  if (!valid) return;
  for (int i = 0; i < D; ++i) a.theta[(size_t)c * D + i] = th[i];
  a.w[c] = w;
  if (c == 0) {
    const int last = a.K - 1;
    const WordSource W = a.words.at(last, (uint32_t)(a.it0 + last), a.n_words);
    const float uf = to_uni(W.global(a.r_fire, 0));  // every shard: chain 0
    *a.fire = (a.alpha > 0.0f && uf <= a.alpha) ? 1 : 0;
  }
}

// The instantiation a configuration launches.
template <class Dn, class S, int kNBlk, int kM>
auto pick_kernel_blocks(bool seq, bool snooker, bool post) {
  if (seq)
    return snooker
               ? (post ? sweep_kernel<Dn, S, true, true, true, kNBlk, kM>
                       : sweep_kernel<Dn, S, true, true, false, kNBlk, kM>)
               : (post ? sweep_kernel<Dn, S, true, false, true, kNBlk, kM>
                       : sweep_kernel<Dn, S, true, false, false, kNBlk, kM>);
  return snooker
             ? (post ? sweep_kernel<Dn, S, false, true, true, kNBlk, kM>
                     : sweep_kernel<Dn, S, false, true, false, kNBlk, kM>)
             : (post ? sweep_kernel<Dn, S, false, false, true, kNBlk, kM>
                     : sweep_kernel<Dn, S, false, false, false, kNBlk, kM>);
}

template <class Density, class Source, int kMode = kAcceptMH>
auto pick_kernel(bool seq, bool snooker, bool post, int n_blk) {
  return n_blk > 1 ? pick_kernel_blocks<Density, Source, kMaxBlocks, kMode>(
                         seq, snooker, post)
                   : pick_kernel_blocks<Density, Source, 1, kMode>(
                         seq, snooker, post);
}

// Chains one block of `kernel` holds on the current device, one thread
// each: the threads its registers allow (cudaFuncGetAttributes'
// maxThreadsPerBlock) and the stage, D + 1 floats a chain, within the
// shared memory a block may opt in to.  Returns a CUDA error code.
template <int D, class Kernel>
int block_chains(Kernel kernel, int* chains) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, optin = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const int by_smem =
      (optin - (int)fa.sharedSizeBytes) / ((D + 1) * (int)sizeof(float));
  *chains = fa.maxThreadsPerBlock < by_smem ? fa.maxThreadsPerBlock : by_smem;
  return (int)cudaSuccess;
}

// Chains one block of a configuration's kernel holds: the fewer of its two
// phases' instantiations.  The sampler reads it once per configuration: a
// group must fit one block (sampler.fused_supported), and a one-CTA window
// (K > 1 of a kOneCta source) the whole population, else K = 1
// (ops/resample_step.py::resample_super_k).
template <class Density, class Source, int kMode = kAcceptMH>
int window_chains(bool seq, bool snooker, int n_blk, int* chains) {
  constexpr int D = Density::D;
  int all = 0, post = 0;
  int e = block_chains<D>(
      pick_kernel<Density, Source, kMode>(seq, snooker, false, n_blk), &all);
  if (e == 0)
    e = block_chains<D>(
        pick_kernel<Density, Source, kMode>(seq, snooker, true, n_blk),
        &post);
  *chains = all < post ? all : post;
  return e;
}

// Launch one window: whole groups per block, about kThreadsTarget threads;
// a Source that needs one CTA (K3's history) for K > 1 runs the whole
// population in one block, if the instantiation can launch that block
// (block_chains).  Returns cudaGetLastError() after the launch.
template <class Density, class Source, int kMode = kAcceptMH>
int launch_sweep(const StepArgs<Density::D>& a, const Density& dens,
                 const Source& src, bool post, cudaStream_t stream) {
  constexpr int D = Density::D;
  if (a.Np < 3 || a.Np > 1024 || a.G < 1 || a.n_members < 1 || a.K < 1 ||
      a.emit_first < 0 || a.emit_stride < 1 ||
      (a.n_blk != 1 && a.n_blk != kMaxBlocks))
    return (int)cudaErrorInvalidValue;
  // the model's integer dimensions must be the ones the density snaps
  if (a.int_mask != Density::kIntMask) return (int)cudaErrorInvalidValue;
  auto kernel = pick_kernel<Density, Source, kMode>(a.n_members > 1,
                                                    a.r_sn >= 0, post, a.n_blk);
  int gpb = a.Np >= kThreadsTarget ? 1 : kThreadsTarget / a.Np;
  if (Source::kOneCta && a.K > 1) {
    int most = 0;
    const int e = block_chains<D>(kernel, &most);
    if (e != 0) return e;
    if (a.G * a.Np > most) return (int)cudaErrorInvalidValue;
    gpb = a.G;
  }
  const int threads = gpb * a.Np;
  const int blocks = (a.G + gpb - 1) / gpb;
  const size_t smem = (size_t)threads * (D + 1) * sizeof(float);
  if (smem > 48 * 1024) {  // above the default: opt in (one-CTA K3 windows)
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, threads, smem, stream>>>(a, dens, src);
  return (int)cudaGetLastError();
}

}  // namespace demcmc
