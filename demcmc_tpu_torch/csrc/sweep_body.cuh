// The body of the DE sweep kernels sweep_kernel and sweep_kernel_lanes
// (step_body.cuh), included as text inside each: not a header.  In scope:
// the template parameters Density, Source, kSeq, kSnooker, kPost, kNBlk,
// kMode, the kernel's threads a chain at most kBodyLanes and the arguments
// a (StepArgs), dens and src.
  constexpr int D = Density::D;
  constexpr int kL = kBodyLanes;
  extern __shared__ float sh[];
  const int tid = threadIdx.x, Np = a.Np;
  // the thread's chain slot in the block and its lane (kL == 1: the thread)
  const int L = kL > 1 ? a.lanes : 1;
  const int lshift = kL > 1 ? __ffs(L) - 1 : 0;
  const int slot = tid >> lshift, lane = tid & (L - 1);
  const bool lead_lane = lane == 0;
  const ChainLanes ln{
      lane, L,
      kL > 1 && L < 32 ? ((1u << L) - 1u) << ((tid & 31) & ~(L - 1))
                       : 0xFFFFFFFFu};
  const int T = blockDim.x >> lshift;  // chain slots
  float* s_th = sh;         // [T, D] the block's groups
  float* s_q = sh + T * D;  // [T] scan scratch
  const int p = slot % Np;
  const int lead = slot - p;
  const int g = blockIdx.x * (T / Np) + slot / Np;
  const bool valid = g < a.G;
  const int c = valid ? g * Np + p : 0;
  const size_t C = (size_t)a.G * Np;
  // a replicated launch: the chain's replication's density and words
  if constexpr (kRepOf<Source>) src.bind(c, a.words, dens);

  float th[D], prop[D];
  float w = 0.0f;
  for (int i = 0; i < D; ++i) th[i] = valid ? a.theta[(size_t)c * D + i] : 0.0f;
  if (valid) w = a.w[c];
  if (lead_lane)
    for (int i = 0; i < D; ++i) s_th[slot * D + i] = th[i];
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
          if (lead_lane) s_q[slot] = wb;
          __syncthreads();
          seg_scan<false>(s_q, slot, p, Np, lead_lane);
          const float mx = s_q[lead + Np - 1];
          __syncthreads();
          if (lead_lane) s_q[slot] = expf(wb - (isfinite(mx) ? mx : 0.0f));
          __syncthreads();
          seg_scan<true>(s_q, slot, p, Np, lead_lane);
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
          // row), and only in bounds: out of them its value is discarded,
          // and every lane of the chain agrees; the greedy modes score the
          // objective alone
          float lp;
          if constexpr (kMode != kAcceptMH)
            lp = dens.like(prop);
          else if constexpr (Density::kNoise)
            lp = inb ? dens(prop, Wc, a.r_noise + s.off, ln) : 0.0f;
          else if constexpr (Density::kLanes > 1)
            lp = dens(prop, ln);  // its data split over the lanes (LBA)
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
          if (kSeq && lead_lane)
            for (int i = 0; i < D; ++i) s_th[slot * D + i] = th[i];
        }
        if (kSeq) __syncthreads();  // the commit, before the next sub-sweep
      }
      if constexpr (kNBlk > 1 && !kSeq) {
        // the next block reads this one's state: the synchronous sweep's
        // stage is refreshed between two barriers, as between iterations
        if (b + 1 < kNBlk) {
          __syncthreads();
          if (lead_lane)
            for (int i = 0; i < D; ++i) s_th[slot * D + i] = th[i];
          __syncthreads();
        }
      }
    }  // block sweeps

    const bool emit =
        k >= a.emit_first && (k - a.emit_first) % a.emit_stride == 0;
    if (valid && lead_lane) {
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
      if (!kSeq && lead_lane)
        for (int i = 0; i < D; ++i) s_th[slot * D + i] = th[i];
      __syncthreads();
    }
  }

  if (!valid || !lead_lane) return;
  for (int i = 0; i < D; ++i) a.theta[(size_t)c * D + i] = th[i];
  a.w[c] = w;
  if constexpr (kRepOf<Source>) {
    // replication r's gate, from its first chain's word
    if (c % src.c_rep == 0) {
      const int last = a.K - 1;
      const WordSource W =
          a.words.at(last, (uint32_t)(a.it0 + last), a.n_words);
      const float uf = to_uni(W(a.r_fire, c));
      a.fire[c / src.c_rep] = (a.alpha > 0.0f && uf <= a.alpha) ? 1 : 0;
    }
  } else if (c == 0) {
    const int last = a.K - 1;
    const WordSource W = a.words.at(last, (uint32_t)(a.it0 + last), a.n_words);
    const float uf = to_uni(W.global(a.r_fire, 0));  // every shard: chain 0
    *a.fire = (a.alpha > 0.0f && uf <= a.alpha) ? 1 : 0;
  }
