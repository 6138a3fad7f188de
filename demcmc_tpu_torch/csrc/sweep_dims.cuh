// The DE sweep with lanes over the dimensions: sweep_kernel_dims, the
// instantiation of K3's sweep for a density that asks for it (kDimLanes;
// the 30-dim MVN of the DE-MCz flagship).
//
// The same iteration as sweep_body.cuh, operation for operation, for the
// configurations launch_sweep sends here: the MH accept, random gamma,
// kappa = 1, no constant blocks, no integer dimensions (every other runs
// sweep_kernel).  It is laid out over L adjacent threads of one warp per
// chain (L a power of two, 8 <= L <= 32, chosen at launch: launch_sweep):
// lane l owns dimensions l, l + L, l + 2 L, ... of the whole sub-sweep --
// its slots j of the register arrays (dimension l + j L), S of them (a
// template value: 1 at L = 32, D / 8 rounded up below, so the one-warp
// chain holds one slot per array).  A lane loads its dimensions of theta
// and of each history partner (a chain's row is one coalesced load by its
// lanes; the pair and the triple are loaded together), draws its own
// epsilon and normal words (word row r + i for dimension i), and does its
// dimensions' proposal arithmetic and bound tests.  The values the chain
// shares -- the partner indices, gamma, the snooker choice and gsn, the
// beta gate, the accept uniform -- every lane draws from the same words, as
// the one-thread kernel's thread does, so every lane holds the same bits.
// A sub-sweep's shared words (all but the beta gate's) are drawn one a
// lane (word r on lane r mod L) and broadcast with __shfl_sync, the
// history indices reduced modulo their spans on their lanes, so a
// sub-sweep waits for one Philox block and one modulo, not a dozen in
// turn; a lane's own words are read whole (WordSource, no row cache).
//
// Sums over the dimensions (the snooker dots, the correction's |a1|^2, the
// density's sums) keep the one-thread kernel's order: DimLanes::fold has
// each lane store its dimensions' values in the chain's scratch in shared
// memory, and every lane reads them back four at a time and adds them in
// index order, so the float adds are the serial ones in the serial order.
// Independent sums are folded together, so their dependent adds overlap.
// The bounds test is a vote over the lanes (a conjunction: no order).
//
// K3's sequential sweep: its sub-sweeps read one another only through the
// stage (the gamma_2 base select, in burn-in): the partners come from the
// history, and a chain's accept reads its own state.  Where no base select
// runs (past burn-in) every chain runs its sub-sweep at once, on its own
// words, with the one barrier after them: the same operations on the same
// values as sub-sweeps one after another.  In burn-in the sub-sweeps stay
// in order, with a barrier between them.
//
// Lane 0 takes the chain's part of the softmax scan and writes w, the
// accept flag and the gate; every lane writes its dimensions of the stage,
// the trajectory row, the history row and the final theta.  Included as
// text by step_body.cuh inside namespace demcmc, after the partner sources
// and seg_scan: not a header.

// threads a block of sweep_kernel_dims may have: its launch bound, 128
// registers a thread
constexpr int kDimBlockThreads = 512;
// lanes a chain at least; a population that fits one block only with
// fewer runs one thread a chain (sweep_kernel)
constexpr int kDimMinLanes = 8;
// sums a fold takes at once at most (the snooker's three)
constexpr int kDimFolds = 3;
// the words a sub-sweep's lanes share, drawn one a lane: the five history
// index words (the pair's, the triple's), gamma's three, gsn and the
// snooker choice, the accept uniform
constexpr int kQIdx = 0, kQGamma = 5, kQSn = 8, kQAcc = 10, kQWords = 11;

// The L lanes of one chain over its dimensions: this thread's lane, L, log2
// L, the warp mask of the L threads and the chain's fold scratch in shared
// memory (kDimFolds sums of kPad floats).
template <int D>
struct DimLanes {
  static constexpr int kPad = (D + 3) & ~3;  // a sum's scratch: whole float4s
  int lane, n, shift;
  unsigned mask;
  float* buf;

  // the dimension of slot j (>= D: the slot is unused)
  __device__ __forceinline__ int dim(int j) const { return lane + j * n; }

  // dimension i's value (slot i / L of lane i mod L), in every lane
  template <int S>
  __device__ __forceinline__ float get(const float (&v)[S], int i) const {
    const int j = i >> shift;
    float x = v[0];
#pragma unroll
    for (int k = 1; k < S; ++k)
      if (k == j) x = v[k];
    return __shfl_sync(mask, x, i & (n - 1), n);
  }

  // acc[t] = the sum over dimensions i < kCnt of v[t]'s, in index order
  // (the first term, then acc + term), in every lane; the N sums together
  template <int kCnt, int N, int S>
  __device__ __forceinline__ void fold(const float (&v)[N][S],
                                       float (&acc)[N]) const {
    static_assert(N <= kDimFolds && kCnt <= kPad, "the fold scratch");
    __syncwarp(mask);  // every lane has read the last fold's scratch
#pragma unroll
    for (int t = 0; t < N; ++t) {
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (dim(j) < kCnt) buf[t * kPad + dim(j)] = v[t][j];
    }
    __syncwarp(mask);
#pragma unroll
    for (int q = 0; q < (kCnt + 3) / 4; ++q) {
      float4 x[N];
#pragma unroll
      for (int t = 0; t < N; ++t)
        x[t] = reinterpret_cast<const float4*>(buf + t * kPad)[q];
#pragma unroll
      for (int t = 0; t < N; ++t) {
        acc[t] = q == 0 ? x[t].x : acc[t] + x[t].x;
        if (4 * q + 1 < kCnt) acc[t] = acc[t] + x[t].y;
        if (4 * q + 2 < kCnt) acc[t] = acc[t] + x[t].z;
        if (4 * q + 3 < kCnt) acc[t] = acc[t] + x[t].w;
      }
    }
  }
};

// Shared memory of a sweep_kernel_dims block of n chains: the stage and
// the scan scratch, then (float4-aligned) each chain's fold scratch.
template <int D>
__host__ __device__ constexpr int dim_fold_offset(int n) {
  return (n * (D + 1) + 3) & ~3;
}
template <int D>
constexpr size_t dim_smem_bytes(int n) {
  return (size_t)(dim_fold_offset<D>(n) + n * kDimFolds * DimLanes<D>::kPad) *
         sizeof(float);
}

template <class Density, class Source, int S, bool kSeq, bool kSnooker,
          bool kPost>
__global__ void __launch_bounds__(kDimBlockThreads)
    sweep_kernel_dims(StepArgs<Density::D> a, Density dens, Source src) {
  static_assert(Source::kOneCta,
                "lanes over the dimensions: K3's partners from the history");
  static_assert(Density::kIntMask == 0u,
                "lanes over the dimensions: no integer dimensions");
  constexpr int D = Density::D;
  extern __shared__ float sh[];
  const int tid = threadIdx.x, Np = a.Np, L = a.lanes;
  const int shift = __ffs(L) - 1;
  const int slot = tid >> shift, lane = tid & (L - 1);
  const bool lead_lane = lane == 0;
  const int T = blockDim.x >> shift;  // chain slots
  float* s_th = sh;                   // [T, D] the block's groups
  float* s_q = sh + T * D;            // [T] scan scratch
  const DimLanes<D> ln{
      lane, L, shift,
      L < 32 ? ((1u << L) - 1u) << ((tid & 31) & ~(L - 1)) : 0xFFFFFFFFu,
      sh + dim_fold_offset<D>(T) + slot * kDimFolds * DimLanes<D>::kPad};
  const int p = slot % Np;
  const int lead = slot - p;
  const int g = blockIdx.x * (T / Np) + slot / Np;
  const bool valid = g < a.G;
  const int c = valid ? g * Np + p : 0;
  const size_t C = (size_t)a.G * Np;

  // slot j holds dimension ln.dim(j); slots at or past D hold 0 and are
  // never stored
  float th[S], prop[S];
  float w = 0.0f;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int i = ln.dim(j);
    th[j] = (valid && i < D) ? a.theta[(size_t)c * D + i] : 0.0f;
    prop[j] = 0.0f;
  }
  if (valid) w = a.w[c];
  // the bounds of the lane's dimensions, read by a static index (a run-time
  // index into the arguments could move them to local memory)
  float lo[S], hi[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    lo[j] = -INFINITY;
    hi[j] = INFINITY;
#pragma unroll
    for (int i = 0; i < D; ++i)
      if (i == ln.dim(j)) {
        lo[j] = a.lo[i];
        hi[j] = a.hi[i];
      }
  }
  auto stage = [&]() {
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (ln.dim(j) < D) s_th[slot * D + ln.dim(j)] = th[j];
  };
  stage();
  __syncthreads();

  const float half_dm1 = 0.5f * (float)(D - 1);
  int t_out = 0;
  for (int k = 0; k < a.K; ++k) {
    const int it = a.it0 + k;
    const WordSource W = a.words.at(k, (uint32_t)it, a.n_words);
    const Source sk = src.at(k, it);
    auto word = [&](int row) { return W(row, c); };  // the chain's word

    const bool base_phase = !kPost && it <= a.burnin;
    // the sub-sweeps at once where none reads the stage
    const bool together = kSeq && !base_phase;
    auto beta_gate = [&]() {
      return a.r_gate >= 0 &&
             to_uni(W(a.r_gate, valid ? g * Np : 0)) <= a.beta;
    };
    const bool mut_sweep = kSeq && beta_gate();
    bool acc_any = false;

    const int n_sub = kSeq ? (together ? 1 : a.n_members) : 1;
    for (int mi = 0; mi < n_sub; ++mi) {
      const int m = together ? p : mi;
      if (base_phase) {
        if (lead_lane) s_q[slot] = w;
        __syncthreads();
        seg_scan<false>(s_q, slot, p, Np, lead_lane);
        const float mx = s_q[lead + Np - 1];
        __syncthreads();
        if (lead_lane) s_q[slot] = expf(w - (isfinite(mx) ? mx : 0.0f));
        __syncthreads();
        seg_scan<true>(s_q, slot, p, Np, lead_lane);
      }
      if (kSeq ? valid && p == m : true) {
        const Slot s{c, p, lead, m, m * a.stride, m};
        // the shared words, word r on lane r mod L (round r / L): a history
        // index word reduced modulo its span (span, span - 1, span,
        // span - 1, span - 2; the indices-in mode's index as it is), or a
        // step word; unused words are not read
        uint32_t got[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = lane + rr * L;
          const bool hist = r < kQGamma;
          const bool used =
              r < kQWords && (hist ? kSnooker || r < kQIdx + 2
                                   : r < kQSn || r >= kQAcc || kSnooker);
          const int row = hist ? s.set * sk.n_slots + r
                          : r < kQSn ? a.r_gamma + s.off + (r - kQGamma)
                          : r < kQAcc ? a.r_sn + s.off + (r - kQSn)
                                      : a.r_acc + s.off;
          const WordSource ws = hist ? sk.words : W;
          uint32_t v = 0u;
          if (used)
            v = hist && sk.idx ? (uint32_t)sk.idx[(size_t)row * sk.C + c]
                               : ws(row, c);
          if (used && hist && !sk.idx)
            v = v % (sk.span - (r == 1 || r == 3 ? 1u : r == 4 ? 2u : 0u));
          got[rr] = v;
        }
        auto shared = [&](int r) {
          return __shfl_sync(ln.mask, r < L ? got[0] : got[1], r & (L - 1),
                             L);
        };
        // the partners' dimensions, the pair's and the triple's loaded
        // together
        const float *pm, *pn, *pz = nullptr, *pm2 = nullptr, *pn2 = nullptr;
        sk.pair_from(shared(kQIdx), shared(kQIdx + 1), pm, pn);
        if (kSnooker)
          sk.triple_from(shared(kQIdx + 2), shared(kQIdx + 3),
                         shared(kQIdx + 4), pz, pm2, pn2);
        float dd[S], pnv[S], z[S], m2[S], n2[S], e_u[S];
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int i = ln.dim(j);
          const bool in = i < D;
          dd[j] = in ? pm[i] : 0.0f;
          pnv[j] = in ? pn[i] : 0.0f;
          z[j] = kSnooker && in ? pz[i] : 0.0f;
          m2[j] = kSnooker && in ? pm2[i] : 0.0f;
          n2[j] = kSnooker && in ? pn2[i] : 0.0f;
        }
        // the lane's epsilon uniforms, drawn while the loads are in flight
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int i = ln.dim(j);
          dd[j] = dd[j] - pnv[j];  // pm[i] - pn[i]
          e_u[j] = i < D && a.r_eps >= 0
                       ? to_uni(word(a.r_eps + s.off + i)) : 0.0f;
        }
        // random gamma, with the gamma_2 base select in burn-in
        const float ub = to_uni(shared(kQGamma));
        const float g1 = to_uni(shared(kQGamma + 1)) * 0.5f + 0.5f;
        const float g2 = to_uni(shared(kQGamma + 2)) * 0.5f + 0.5f;
        const float* base = nullptr;
        if (base_phase) {
          const float ubs = fmaxf(ub, FLT_MIN) * s_q[lead + Np - 1];
          int cnt = 0;
          for (int o = 0; o < Np; ++o) cnt += s_q[lead + o] < ubs;
          base = s_th + (lead + min(cnt, Np - 1)) * D;
        }
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int i = ln.dim(j);
          const float bterm = base && i < D ? g2 * (base[i] - th[j]) : 0.0f;
          prop[j] = (th[j] + g1 * dd[j]) + bterm;
        }

        bool sn = false, degen = false;
        float den0 = 0.0f;
        if (kSnooker) {
          // |theta - z|^2 and the projections' numerators, folded
          // together; again with the unit direction if z == theta
          float v[3][S], q[3], sp[S];
#pragma unroll
          for (int j = 0; j < S; ++j) {
            sp[j] = th[j] - z[j];
            v[0][j] = sp[j] * sp[j];
            v[1][j] = m2[j] * sp[j];
            v[2][j] = n2[j] * sp[j];
          }
          ln.template fold<D>(v, q);
          den0 = q[0];
          degen = den0 <= FLT_MIN;
          if (degen) {
#pragma unroll
            for (int j = 0; j < S; ++j) {
              sp[j] = 1.0f;
              v[0][j] = sp[j] * sp[j];
              v[1][j] = m2[j] * sp[j];
              v[2][j] = n2[j] * sp[j];
            }
            ln.template fold<D>(v, q);
          }
          const float dens2 = q[0];
          const float q1 = q[1] / dens2;
          const float q2 = q[2] / dens2;
          const float gsn = to_uni(shared(kQSn)) + 1.2f;
          sn = to_uni(shared(kQSn + 1)) <= a.theta_sn;
          if (sn) {
#pragma unroll
            for (int j = 0; j < S; ++j)
              prop[j] = th[j] + gsn * (q1 * sp[j] - q2 * sp[j]);
          }
        }

#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int i = ln.dim(j);
          if (i >= D) continue;
          if (a.r_eps >= 0) prop[j] = prop[j] + (e_u[j] * a.eps2 - a.eps);
        }

        // snooker MH correction on the final proposal; a degenerate draw
        // proposes theta and is rejected with -inf
        float adj = 0.0f;
        if (sn) {
          float a1[1][S], a1sq[1];
#pragma unroll
          for (int j = 0; j < S; ++j) {
            if (degen) prop[j] = th[j];
            const float d1 = prop[j] - z[j];
            a1[0][j] = d1 * d1;
          }
          ln.template fold<D>(a1, a1sq);
          adj = degen ? -INFINITY : half_dm1 * (logf(a1sq[0]) - logf(den0));
        }

        // Box-Muller normals, word rows as the one-thread kernel reads them
        // (radius row r_norm + i, angle row r_norm + D + i)
        const bool mut = kSeq ? mut_sweep : beta_gate();
        if (kNormalsIfGated<D> ? mut : a.r_gate >= 0) {
#pragma unroll
          for (int j = 0; j < S; ++j) {
            const int i = ln.dim(j);
            if (i >= D) continue;
            const float rad = sqrtf(
                -2.0f *
                logf(fmaxf(to_uni(word(a.r_norm + s.off + i)), FLT_MIN)));
            const float u2 = to_uni(word(a.r_norm + s.off + D + i));
            const float nrm = rad * cosf(kTwoPi * u2);
            if (mut) prop[j] = th[j] + a.sigma * nrm;
          }
        }
        if (mut) adj = 0.0f;

        bool inb = true;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          if (ln.dim(j) >= D) continue;
          if (isfinite(lo[j])) inb = inb && prop[j] >= lo[j];
          if (isfinite(hi[j])) inb = inb && prop[j] <= hi[j];
        }
        inb = __all_sync(ln.mask, inb);
        const float lp = dens(prop, ln);
        const float wp = (inb && !isnan(lp)) ? lp : -INFINITY;
        const float u = fmaxf(to_uni(shared(kQAcc)), FLT_MIN);
        float delta = wp - w;
        if (kSnooker) delta = delta + adj;
        const bool acc = logf(u) <= delta;
        if (acc) {
#pragma unroll
          for (int j = 0; j < S; ++j) th[j] = prop[j];
          w = wp;
        }
        acc_any = acc_any || acc;
        if (kSeq) stage();
      }
      if (kSeq) __syncthreads();  // the commit, before the next sub-sweep
    }

    const bool emit =
        k >= a.emit_first && (k - a.emit_first) % a.emit_stride == 0;
    if (valid) {
      const size_t row = (size_t)t_out * C + c;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int i = ln.dim(j);
        if (i >= D) continue;
        if (emit && a.out_theta) a.out_theta[row * D + i] = th[j];
        sk.commit_dim(it, c, i, th[j]);
      }
      if (emit && lead_lane) {
        if (a.out_w) a.out_w[row] = w;
        if (a.out_acc) a.out_acc[row] = acc_any ? 1 : 0;
      }
    }
    t_out += emit;
    if (k + 1 < a.K) {
      __syncthreads();
      if (!kSeq) stage();
      __syncthreads();
    }
  }

  if (!valid) return;
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (ln.dim(j) < D) a.theta[(size_t)c * D + ln.dim(j)] = th[j];
  if (!lead_lane) return;
  a.w[c] = w;
  if (c == 0) {
    const int last = a.K - 1;
    const WordSource W = a.words.at(last, (uint32_t)(a.it0 + last), a.n_words);
    const float uf = to_uni(W.global(a.r_fire, 0));
    *a.fire = (a.alpha > 0.0f && uf <= a.alpha) ? 1 : 0;
  }
}
