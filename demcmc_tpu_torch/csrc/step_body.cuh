// The DE sweep shared by K1 (de_step.cu) and K3 (de_step_resample.cu): its
// arguments, partner sources and launch here, its body in sweep_body.cuh.
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
// thread per chain, or, for a density with kLanes > 1 (the ABC binomial's
// noise panel, LBA's trials), L adjacent threads of one warp per chain
// (its lanes; L a power of two <= kLanes, chosen at launch from Np; at
// L = 1 the one-thread kernel runs, the body at one lane); a block holds
// whole groups.  Every lane runs the chain's proposal, bounds
// and accept on the same words, so to the same bits; only the density's
// inner loop is split over the lanes (ChainLanes), and lane 0 writes the
// chain's stage, scan entry and outputs.  A density with kDimLanes (the
// 30-dim MVN, in K3) runs sweep_kernel_dims (sweep_dims.cuh) instead
// wherever its population fits one block with 8 lanes a chain or more and
// the configuration is one that kernel has (launch_sweep): lanes over the
// dimensions of the whole sweep.  A density with kHoist (the d = 2
// Gaussian and Rastrigin) runs sweep_kernel_hoist (sweep_hoist.cuh): one
// thread a chain, its draws taken before the state, and a K3 window over a
// thread block cluster.  The group is staged in
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
#include <mutex>
#include <type_traits>

#include "philox.cuh"

namespace demcmc {

constexpr int kThreadsTarget = 64;
// threads a block of sweep_kernel_hoist (K3's window: a cluster's CTAs):
// one warp, the chains spread over the most SMs (on an H100 1-3% faster
// than 64 threads, 128 slower, PERF.md)
constexpr int kHoistThreadsTarget = 32;
// threads a block for a density with lanes: 8 warps a block, so the ABC
// cell's 512 groups of 8 chains fill every SM
constexpr int kLaneThreadsTarget = 256;
// threads a block of a kernel with lanes may have: its launch bound, which
// holds it to the registers that allow them (so no attribute query at launch)
constexpr int kLaneBlockThreads = 1024;
// accept modes (ops/fused_step.py accept_mode: 'mh', 'max', 'min')
constexpr int kAcceptMH = 0, kAcceptMax = 1, kAcceptMin = 2;
// min mode's clamp of +inf weights in the base select (fused_step.py:2292)
constexpr float kMinModeClamp = 3.0e38f;
constexpr int kMaxBlocks = 2;  // block counts built: 1 (none) and 2
constexpr float kTwoPi = 6.283185307179586f;
// Draw the mutation's normals only in groups whose beta gate fired: chosen
// at compile time from the width (see the mutation in sweep_body.cuh).
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
  int lanes;  // threads a chain (set at launch; 1 unless the density has
              // kLanes > 1)
};

// Threads a chain at most in a kernel of this density and partner source:
// the density's kLanes, 1 for a one-CTA source (K3's history).
template <class Density, class Source>
constexpr int kMaxLanes = Source::kOneCta ? 1 : Density::kLanes;

// Lanes over the dimensions in K3 (sweep_kernel_dims): a density's
// kDimLanes, false for a density that declares none.
template <class Density, class = void>
constexpr bool kDimLanesOf = false;
template <class Density>
constexpr bool
    kDimLanesOf<Density, std::void_t<decltype(Density::kDimLanes)>> =
        Density::kDimLanes;

// Draws before the state (sweep_kernel_hoist): a density's kHoist, false
// for a density that declares none.
template <class Density, class = void>
constexpr bool kHoistOf = false;
template <class Density>
constexpr bool kHoistOf<Density, std::void_t<decltype(Density::kHoist)>> =
    Density::kHoist;
// rows of a sub-sweep block at most (2 partners, 3 gammas, 3 snooker
// members, snooker gamma and gate, d eps, d kappa, the beta gate, 2d
// normals, the accept), and the Philox blocks that hold them at any
// alignment
template <int D>
constexpr int kHoistRows = 12 + 4 * D;
template <int D>
constexpr int kHoistBlocks = (kHoistRows<D> + 6) / 4;
// CTAs of a K3 window's cluster at most: 16, the non-portable size, where
// the card co-schedules it (cluster_size)
constexpr int kMaxClusterCtas = 16;

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
  a.lanes = 1;
  return a;
}

// The chain being updated in a sub-sweep.
struct Slot {
  int c, p, lead, member, off;  // chain, group slot, group's first slot,
                                // sub-sweep, its row offset
  int set;                      // partner slot set: block * n_members + member
};

// max that propagates NaN, like jnp.maximum / torch.maximum (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// Inclusive Hillis-Steele scan within Np-slot segments of s (the TPU
// kernel's _seg_scan: x[p] = op(x[p], x[p-k]) for p >= k, k = 1, 2, 4...);
// slot is the thread's chain slot, and only a writer stores (one lane a
// chain; every thread reaches the barriers).
template <bool kAdd>
__device__ __forceinline__ void seg_scan(float* s, int slot, int p, int Np,
                                         bool writer) {
  for (int k = 1; k < Np; k <<= 1) {
    const float v = (p >= k) ? s[slot - k] : 0.0f;
    __syncthreads();
    if (writer && p >= k) s[slot] = kAdd ? s[slot] + v : nan_max(s[slot], v);
    __syncthreads();
  }
}

// Words 4 b0 .. 4 b0 + 4 N - 1 of chain c (of the launch) into t[j * T],
// and returned (kX), the word at row rx of chain cx: the Philox blocks in
// straight-line code, computed together.
template <int N, bool kX>
__device__ __forceinline__ uint32_t philox_rows(uint32_t* t, int T,
                                                const WordSource& W,
                                                uint32_t chain, int b0,
                                                int rx, uint32_t cx) {
  uint4 v[N];
#pragma unroll
  for (int q = 0; q < N; ++q)
    v[q] = philox_block(W.k0, W.k1, W.it, (uint32_t)(b0 + q), chain, W.ns);
  uint4 x = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (kX)
    x = philox_block(W.k0, W.k1, W.it, (uint32_t)rx >> 2, cx, W.ns);
#pragma unroll
  for (int q = 0; q < N; ++q) {
    t[(4 * q) * T] = v[q].x;
    t[(4 * q + 1) * T] = v[q].y;
    t[(4 * q + 2) * T] = v[q].z;
    t[(4 * q + 3) * T] = v[q].w;
  }
  return kX ? lane(x, (uint32_t)rx) : 0u;
}

template <int kNB, bool kX>
__device__ __forceinline__ uint32_t philox_rows_n(uint32_t* t, int T,
                                                  const WordSource& W,
                                                  uint32_t chain, int b0,
                                                  int nb, int rx,
                                                  uint32_t cx) {
  static_assert(kNB <= 6, "draw_words: up to 6 blocks");
  switch (nb) {
    case 1: return philox_rows<1, kX>(t, T, W, chain, b0, rx, cx);
    case 2: return philox_rows<2, kX>(t, T, W, chain, b0, rx, cx);
    case 3: return philox_rows<3, kX>(t, T, W, chain, b0, rx, cx);
    case 4: return philox_rows<4, kX>(t, T, W, chain, b0, rx, cx);
    case 5: return philox_rows<5, kX>(t, T, W, chain, b0, rx, cx);
    default: return philox_rows<kNB, kX>(t, T, W, chain, b0, rx, cx);
  }
}

// Words 4 b0 .. 4 b0 + 4 nb - 1 of chain c (of the launch) into t[j * T]
// (nb <= kNB), and returned (x), the word at row rx of chain cx: the
// Philox blocks computed together, with no branch between them (one code
// path for each nb), or in bits-in mode the buffer's rows (those at
// n_words and past, which the iteration does not have, left 0).
template <int kNB>
__device__ __forceinline__ uint32_t draw_words(uint32_t* t, int T,
                                               const WordSource& W, int c,
                                               int b0, int nb, int n_words,
                                               bool x, int rx, int cx) {
  const uint32_t chain = W.chain0 + (uint32_t)c;
  if (W.bits != nullptr) {
    for (int j = 0; j < 4 * nb; ++j) {
      const int row = 4 * b0 + j;
      t[j * T] = row < n_words ? W.bits[(size_t)row * W.C + chain] : 0u;
    }
    return x ? W(rx, cx) : 0u;
  }
  const uint32_t xc = W.chain0 + (uint32_t)cx;
  return x ? philox_rows_n<kNB, true>(t, T, W, chain, b0, nb, rx, xc)
           : philox_rows_n<kNB, false>(t, T, W, chain, b0, nb, rx, xc);
}

// The barrier of every thread of the cluster (barrier.cluster.arrive,
// release, then wait, acquire): the writes before it, to shared or device
// memory, are seen by every thread of the cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n\tbarrier.cluster.wait;" :::
               "memory");
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
// A shard of a chain mesh (kShard: chains chain0 .. of a population of
// C_hist, HistoryShard) reads the population's history (row stride C_hist,
// span count * C_hist), draws its index words by population chain
// (words.chain0) and writes its own columns of row it - 1; it runs one
// iteration a launch (the other shards write the rest of the row).  kShard
// is compile-time, so the whole population's source (chain0 = 0,
// C_hist = C) holds no shard fields and computes what it did before them.
template <bool kShard>
struct HistoryShard {};
template <>
struct HistoryShard<true> {
  int C_hist;       // the population's chains: the history's row stride
  uint32_t chain0;  // the launch's first chain in the population
};

template <int D, bool kShard = false>
struct HistoryPartners : HistoryShard<kShard> {
  static constexpr bool kOneCta = true;
  float* hist;         // [H, C_hist, D]
  const int64_t* idx;  // [K n_rows, C] (the launch's chains) or nullptr
  WordSource words;    // RESAMPLE_NS words, of chains chain0 ..
  int C, n_slots, n_rows;
  uint32_t span;       // count * C_hist

  // the source of window iteration k (iteration it)
  __device__ __forceinline__ HistoryPartners at(int k, int it) const {
    HistoryPartners s = *this;
    s.words = words.at(k, (uint32_t)it, 0);
    if (idx) s.idx = idx + (size_t)k * n_rows * C;
    if constexpr (kShard)
      s.span = (uint32_t)(it - 1) * (uint32_t)this->C_hist;
    else
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

  // chain c's entry of history row it - 1
  __device__ __forceinline__ size_t row_of(int it, int c) const {
    if constexpr (kShard)
      return ((size_t)(it - 1) * this->C_hist + this->chain0 + (uint32_t)c) *
             D;
    else
      return ((size_t)(it - 1) * C + c) * D;
  }

  __device__ __forceinline__ void commit(int it, int c, const float* th) const {
    float* row = hist + row_of(it, c);
    for (int i = 0; i < D; ++i) row[i] = th[i];
  }

  // Lanes over the dimensions (sweep_kernel_dims): the pair and the
  // triple from their index words already reduced modulo their spans (in
  // the indices-in mode, the indices), and dimension i of the new state.
  __device__ __forceinline__ void pair_from(uint32_t f0, uint32_t f1,
                                            const float*& pm,
                                            const float*& pn) const {
    if (!idx) f1 += f1 >= f0;
    pm = at(f0);
    pn = at(f1);
  }

  __device__ __forceinline__ void triple_from(uint32_t f0, uint32_t f1,
                                              uint32_t f2, const float*& pz,
                                              const float*& pm,
                                              const float*& pn) const {
    if (!idx) {
      f1 += f1 >= f0;
      const uint32_t lo = min(f0, f1), hi = max(f0, f1);
      f2 += f2 >= lo;
      f2 += f2 >= hi;
    }
    pz = at(f0);
    pm = at(f1);
    pn = at(f2);
  }

  __device__ __forceinline__ void commit_dim(int it, int c, int i,
                                             float v) const {
    hist[row_of(it, c) + i] = v;
  }
};

// sweep_kernel_dims, lanes over the dimensions
#include "sweep_dims.cuh"

// A replicated launch (a partner source with kRep, de_step_rep.cu): the
// population is R replications of c_rep chains, whole groups each.  The
// bodies call bind() once per thread, where a chain takes its
// replication's density and words; they write each replication's gate
// into fire[r].  kRep is compile-time, so a source without it (every other
// instantiation) compiles none of that code.
template <class Source, class = void>
constexpr bool kRepOf = false;
template <class Source>
constexpr bool kRepOf<Source, std::void_t<decltype(Source::kRep)>> =
    Source::kRep;

// kSeq (the sequential sweep), kSnooker, kPost, kNBlk and kMode (the
// accept) are compile-time, so a configuration without them runs none of
// their code: as run-time flags they made K1 measurably slower on an H100
// (PERF.md).  The two kernels share their body, sweep_body.cuh, included
// as text: a device function called from both changed the code of every
// one-thread-a-chain instantiation (their SASS, compared on an H100).
//
// One thread a chain (kMaxLanes == 1, and a density with lanes where it
// gets one lane a chain).
template <class Density, class Source, bool kSeq, bool kSnooker, bool kPost,
          int kNBlk, int kMode = kAcceptMH>
__global__ void sweep_kernel(StepArgs<Density::D> a, Density dens,
                             Source src) {
  constexpr int kBodyLanes = 1;
#include "sweep_body.cuh"
}

// Lanes (kMaxLanes > 1): held to 64 registers by the launch bound, so a
// block of 1,024 threads launches and a group fits one block up to 1,024
// chains (one lane each), as with one thread a chain.
template <class Density, class Source, bool kSeq, bool kSnooker, bool kPost,
          int kNBlk, int kMode = kAcceptMH>
__global__ void __launch_bounds__(kLaneBlockThreads)
    sweep_kernel_lanes(StepArgs<Density::D> a, Density dens, Source src) {
  constexpr int kBodyLanes = kMaxLanes<Density, Source>;
#include "sweep_body.cuh"
}

// One thread a chain, the draws before the state (kHoist): held to 64
// registers by the launch bound, so a group fits one block up to 1,024
// chains, as in the one-thread kernel.
template <class Density, class Source, bool kSeq, bool kSnooker, bool kPost,
          int kNBlk, int kMode = kAcceptMH>
__global__ void __launch_bounds__(kLaneBlockThreads)
    sweep_kernel_hoist(StepArgs<Density::D> a, Density dens, Source src) {
#include "sweep_hoist.cuh"
}

// (kDims > 0: sweep_kernel_dims with kDims register slots a lane; one
// block sweep, the MH accept; kOne: a density with lanes at one lane a
// chain, the one-thread kernel)
template <class Dn, class S, bool kSeq, bool kSnooker, bool kPost, int kNBlk,
          int kM, int kDims, bool kOne>
auto kernel_of() {
  if constexpr (kDims > 0) {
    static_assert(kNBlk == 1 && kM == kAcceptMH, "sweep_kernel_dims");
    return sweep_kernel_dims<Dn, S, kDims, kSeq, kSnooker, kPost>;
  } else if constexpr (kHoistOf<Dn>) {
    return sweep_kernel_hoist<Dn, S, kSeq, kSnooker, kPost, kNBlk, kM>;
  } else if constexpr (kMaxLanes<Dn, S> > 1 && !kOne) {
    return sweep_kernel_lanes<Dn, S, kSeq, kSnooker, kPost, kNBlk, kM>;
  } else {
    return sweep_kernel<Dn, S, kSeq, kSnooker, kPost, kNBlk, kM>;
  }
}

// The instantiation a configuration launches (kDims > 0: lanes over the
// dimensions, kDims register slots a lane; kOne: one lane a chain).
template <class Dn, class S, int kNBlk, int kM, int kD = 0, bool kO = false>
auto pick_kernel_blocks(bool seq, bool snooker, bool post) {
  if (seq)
    return snooker
               ? (post ? kernel_of<Dn, S, true, true, true, kNBlk, kM, kD, kO>()
                       : kernel_of<Dn, S, true, true, false, kNBlk, kM, kD,
                                   kO>())
               : (post ? kernel_of<Dn, S, true, false, true, kNBlk, kM, kD,
                                   kO>()
                       : kernel_of<Dn, S, true, false, false, kNBlk, kM, kD,
                                   kO>());
  return snooker
             ? (post ? kernel_of<Dn, S, false, true, true, kNBlk, kM, kD, kO>()
                     : kernel_of<Dn, S, false, true, false, kNBlk, kM, kD,
                                 kO>())
             : (post ? kernel_of<Dn, S, false, false, true, kNBlk, kM, kD,
                                 kO>()
                     : kernel_of<Dn, S, false, false, false, kNBlk, kM, kD,
                                 kO>());
}

template <class Density, class Source, int kMode = kAcceptMH,
          bool kOne = false>
auto pick_kernel(bool seq, bool snooker, bool post, int n_blk) {
  return n_blk > 1
             ? pick_kernel_blocks<Density, Source, kMaxBlocks, kMode, 0, kOne>(
                   seq, snooker, post)
             : pick_kernel_blocks<Density, Source, 1, kMode, 0, kOne>(
                   seq, snooker, post);
}

// The kernel a configuration launches at one lane a chain: the one-thread
// kernel, also for a density with lanes (the body at kL = 1).
template <class Density, class Source, int kMode = kAcceptMH>
auto pick_kernel_one(bool seq, bool snooker, bool post, int n_blk) {
  return pick_kernel<Density, Source, kMode, true>(seq, snooker, post, n_blk);
}

// Shared memory a chain of a kernel on Density holds, in floats: the
// stage, D + 1, and in sweep_kernel_hoist its words (sweep_hoist.cuh).
template <class Density>
constexpr int kStageFloats =
    Density::D + 1 + (kHoistOf<Density> ? 4 * kHoistBlocks<Density::D> : 0);

// Chains one block of `kernel` holds on the current device, one thread
// each: the threads its registers allow (cudaFuncGetAttributes'
// maxThreadsPerBlock) and the stage, kStageFloats a chain, within the
// shared memory a block may opt in to.  Returns a CUDA error code.
template <class Density, class Kernel>
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
      (optin - (int)fa.sharedSizeBytes) /
      (kStageFloats<Density> * (int)sizeof(float));
  *chains = fa.maxThreadsPerBlock < by_smem ? fa.maxThreadsPerBlock : by_smem;
  return (int)cudaSuccess;
}

// The stage's shared memory of `chains` chains, opted in to above the
// default 48 KB.
template <class Density, class Kernel>
int stage_smem(Kernel kernel, int chains, size_t* smem) {
  *smem = (size_t)chains * kStageFloats<Density> * sizeof(float);
  if (*smem <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// The launch configuration of `blocks` blocks of `threads` threads and
// `smem` bytes in clusters of `ctas` blocks (cfg points at the attribute:
// not to be copied).
struct ClusterLaunch {
  cudaLaunchAttribute at[1];
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int blocks, int threads, size_t smem, cudaStream_t stream,
                int ctas)
      : cfg{} {
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = (unsigned)ctas;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = at;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

// The cluster of `kernel` (a K3 window of a kHoist density) on the current
// device: *chains, the chains one of its blocks holds (block_chains), and
// *ctas, the most blocks of that many threads one cluster co-schedules
// (cudaOccupancyMaxActiveClusters): kMaxClusterCtas, the non-portable
// size, where the card has room for one such cluster, else the next power
// of two down.  Read once per kernel and device.  Returns a CUDA error
// code.
template <class Density, class Kernel>
int cluster_size(Kernel kernel, int* chains, int* ctas) {
  struct Entry {
    const void* fn;
    int dev, chains, ctas;
  };
  static Entry seen[64];
  static int n_seen = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> hold(mu);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].fn == (const void*)kernel && seen[i].dev == dev) {
      *chains = seen[i].chains;
      *ctas = seen[i].ctas;
      return (int)cudaSuccess;
    }
  int most = 0;
  size_t smem = 0;
  int rc = block_chains<Density>(kernel, &most);
  if (rc == 0) rc = stage_smem<Density>(kernel, most, &smem);
  if (rc == 0)
    rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc != 0) return rc;
  int n = 1;
  for (int s = kMaxClusterCtas; s > 1; s >>= 1) {
    const ClusterLaunch l(s, most, smem, nullptr, s);
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(&active, kernel, &l.cfg);
    if (e != cudaSuccess) return (int)e;
    if (active > 0) {
      n = s;
      break;
    }
  }
  if (n_seen < 64) seen[n_seen++] = Entry{(const void*)kernel, dev, most, n};
  *chains = most;
  *ctas = n;
  return (int)cudaSuccess;
}

// Chains one block of a configuration's kernel holds: the fewer of its two
// phases' instantiations (for a density with lanes, of the one-thread
// kernel, which takes the largest groups at one lane a chain).  The
// sampler reads it once per configuration: a group must fit one block
// (sampler.fused_supported).
template <class Density, class Source, int kMode = kAcceptMH>
int block_chains_of(bool seq, bool snooker, int n_blk, int* chains) {
  int all = 0, post = 0;
  int e = block_chains<Density>(
      pick_kernel_one<Density, Source, kMode>(seq, snooker, false, n_blk),
      &all);
  if (e == 0)
    e = block_chains<Density>(
        pick_kernel_one<Density, Source, kMode>(seq, snooker, true, n_blk),
        &post);
  *chains = all < post ? all : post;
  return e;
}

// Chains a window of K > 1 iterations of a kOneCta source (K3) holds for
// groups of Np: the chains one block holds (block_chains_of), or for a
// kHoist density those of one cluster, its largest (cluster_size) of
// blocks of whole groups; the fewer of the two phases'.  Above it the
// sampler keeps K = 1 (ops/resample_step.py::resample_super_k).
template <class Density, class Source, int kMode = kAcceptMH>
int window_chains(bool seq, bool snooker, int n_blk, int Np, int* chains) {
  if constexpr (!kHoistOf<Density>) {
    return block_chains_of<Density, Source, kMode>(seq, snooker, n_blk,
                                                   chains);
  } else {
    if (Np < 1) return (int)cudaErrorInvalidValue;
    int fewest = 0;
    for (int post = 0; post < 2; ++post) {
      int most = 0, ctas = 0;
      const int e = cluster_size<Density>(
          pick_kernel<Density, Source, kMode>(seq, snooker, post, n_blk),
          &most, &ctas);
      if (e != 0) return e;
      const int n = ctas * (most / Np) * Np;
      fewest = post == 0 || n < fewest ? n : fewest;
    }
    *chains = fewest;
    return (int)cudaSuccess;
  }
}

// Launch one window.  K3 on a density with lanes over the dimensions
// (kDimLanes) runs sweep_kernel_dims, in one block, where its population
// fits that block with at least kDimMinLanes lanes a chain and the
// configuration is one that kernel has (random gamma, kappa = 1, no
// constant blocks): L the largest power of two <= 32 with
// C L <= kDimBlockThreads (the instantiation with ceil(D / 32) slots a
// lane at L = 32, ceil(D / kDimMinLanes) below).
// Otherwise: whole groups per block, about kThreadsTarget threads
// (kHoistThreadsTarget on a kHoist density); a Source that needs one CTA
// (K3's history) for K > 1 runs the whole population in one block, if the
// instantiation can launch that block (block_chains) -- on a kHoist
// density, in one cluster of such blocks (cluster_size), as many as the
// groups need up to the largest cluster, with more groups a block
// beyond.  A density with lanes (kMaxLanes > 1) gets L threads a chain:
// the largest power of two <= kLanes with Np L within the threads one
// block of the kernel may have, kLaneBlockThreads (L = 1 for the largest
// groups, which run the one-thread kernel, so a group fits one block
// whenever it fits with one thread a chain), and about kLaneThreadsTarget
// threads a block.  Returns the launch's CUDA error code.
template <class Density, class Source, int kMode = kAcceptMH>
int launch_sweep(const StepArgs<Density::D>& args, const Density& dens,
                 const Source& src, bool post, cudaStream_t stream) {
  constexpr int D = Density::D;
  constexpr int kL = kMaxLanes<Density, Source>;
  StepArgs<D> a = args;
  if (a.Np < 3 || a.Np > 1024 || a.G < 1 || a.n_members < 1 || a.K < 1 ||
      a.emit_first < 0 || a.emit_stride < 1 ||
      (a.n_blk != 1 && a.n_blk != kMaxBlocks))
    return (int)cudaErrorInvalidValue;
  // the model's integer dimensions must be the ones the density snaps
  if (a.int_mask != Density::kIntMask) return (int)cudaErrorInvalidValue;
  if constexpr (kDimLanesOf<Density> && Source::kOneCta &&
                kMode == kAcceptMH) {
    const int n = a.G * a.Np;
    int L = 32;
    while (L > kDimMinLanes && n * L > kDimBlockThreads) L >>= 1;
    if (n * L <= kDimBlockThreads && a.random_gamma && a.r_kappa < 0 &&
        a.n_blk == 1) {
      constexpr int kS32 = (D + 31) / 32, kSMin =
          (D + kDimMinLanes - 1) / kDimMinLanes;
      a.lanes = L;
      const bool seq = a.n_members > 1, sn = a.r_sn >= 0;
      auto kd = L == 32 ? pick_kernel_blocks<Density, Source, 1, kMode, kS32>(
                              seq, sn, post)
                        : pick_kernel_blocks<Density, Source, 1, kMode, kSMin>(
                              seq, sn, post);
      kd<<<1, n * L, dim_smem_bytes<D>(n), stream>>>(a, dens, src);
      return (int)cudaGetLastError();
    }
  }
  auto kernel = pick_kernel<Density, Source, kMode>(a.n_members > 1,
                                                    a.r_sn >= 0, post, a.n_blk);
  constexpr int kTarget =
      kHoistOf<Density> ? kHoistThreadsTarget : kThreadsTarget;
  int gpb = a.Np >= kTarget ? 1 : kTarget / a.Np;
  a.lanes = 1;
  if constexpr (kL > 1) {
    int L = kL;
    while (L > 1 && a.Np * L > kLaneBlockThreads) L >>= 1;
    gpb = a.Np * L >= kLaneThreadsTarget ? 1
                                         : kLaneThreadsTarget / (a.Np * L);
    if (gpb > a.G) gpb = a.G;
    a.lanes = L;
    if (L == 1)
      kernel = pick_kernel_one<Density, Source, kMode>(
          a.n_members > 1, a.r_sn >= 0, post, a.n_blk);
  }
  // a sub-sweep block's words must fit sweep_kernel_hoist's table
  if (kHoistOf<Density> && a.stride > kHoistRows<D>)
    return (int)cudaErrorInvalidValue;
  int blocks = (a.G + gpb - 1) / gpb;
  int cluster = 0;  // CTAs of the launch's cluster (0: none)
  if (Source::kOneCta && a.K > 1) {
    int most = 0;
    if constexpr (kHoistOf<Density>) {
      int ctas = 0;
      const int e = cluster_size<Density>(kernel, &most, &ctas);
      if (e != 0) return e;
      if (blocks > ctas) {
        gpb = (a.G + ctas - 1) / ctas;
        blocks = (a.G + gpb - 1) / gpb;
      }
      cluster = blocks;
    } else {
      const int e = block_chains<Density>(kernel, &most);
      if (e != 0) return e;
      gpb = a.G;
      blocks = 1;
    }
    if (gpb * a.Np > most) return (int)cudaErrorInvalidValue;
  }
  const int threads = gpb * a.Np * a.lanes;
  size_t smem = 0;
  const int e = stage_smem<Density>(kernel, gpb * a.Np, &smem);
  if (e != 0) return e;
  if (cluster > 0) {
    const ClusterLaunch l(blocks, threads, smem, stream, cluster);
    const cudaError_t le = cudaLaunchKernelEx(&l.cfg, kernel, a, dens, src);
    if (le != cudaSuccess) return (int)le;
    return (int)cudaGetLastError();
  }
  kernel<<<blocks, threads, smem, stream>>>(a, dens, src);
  return (int)cudaGetLastError();
}

}  // namespace demcmc
