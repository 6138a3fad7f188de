// The body of the DE sweep kernel sweep_kernel_hoist (step_body.cuh),
// included as text: not a header.  In scope: the template parameters
// Density, Source, kSeq, kSnooker, kPost, kNBlk, kMode and the arguments a
// (StepArgs), dens and src.
//
// The iteration of sweep_body.cuh for a narrow density with one thread a
// chain (kHoist: the d = 2 Gaussian and Rastrigin), the same words through
// the same maps and the same float operations in the same order, so bit for
// bit that body; only where the draws are computed moves.  sweep_body.cuh
// generates a chain's Philox blocks as its rows are first read, between
// the operations that use them, so an iteration is one dependent chain of
// block after block, Box-Muller and the density (about 3,800 cycles at the
// 4,096-chain Gaussian, and in the sequential sweep Np of them an
// iteration, PERF.md).  None of the draws reads the state, so here each
// block sweep starts by taking all of them at once, as independent
// instruction streams:
//   - every word of the chain's sub-sweep block (its Philox blocks
//     together, in straight-line code, into the thread's column of a
//     table in shared memory) and, in K3, its history index words
//     (RESAMPLE_NS);
//   - from them: the partner indices (K1: group slots; K3: flat history
//     indices, reduced modulo their spans), the gammas, the snooker gamma
//     and gate, the epsilon terms, the kappa keeps, the beta gate (the
//     group leader's word), the Box-Muller normals and log u of the accept.
// What is left reads the state: the base select, the partners' loads, the
// proposal and snooker projection, the bounds, the density, the accept and
// the commit.  The sequential sweep draws its own sub-sweep's (slot p's)
// before sub-sweep 0, where sweep_body.cuh waits at the barriers, so each
// of its Np sub-sweeps costs the state's part alone.
//
// K3's window (a kOneCta source, K > 1) runs over a thread block cluster
// (launch_sweep): whole groups in each CTA, the cluster barrier between
// iterations, which orders history row it - 1, written by one CTA, before
// the next iteration's reads in another.  It stands after the next
// iteration's Philox blocks, which read no history, so the row's stores
// are done when it releases them; the reads bypass L1 (ld.global.cg), so
// no SM reads a line it cached before the write.
  constexpr int D = Density::D;
  static_assert(Density::kLanes == 1 && !Density::kNoise &&
                    Density::kIntMask == 0u,
                "sweep_kernel_hoist: one thread a chain, no noise panel, no "
                "integer dimensions");
  extern __shared__ float sh[];
  const int tid = threadIdx.x, Np = a.Np;
  const int T = blockDim.x;  // chain slots
  float* s_th = sh;          // [T, D] the block's groups
  float* s_q = sh + T * D;   // [T] scan scratch
  // [4 kHoistBlocks, T] each thread's words of its sub-sweep block: its own
  // column, read back by row (shared memory, so neither registers nor a
  // thread's local memory hold a table read at a run-time row)
  uint32_t* s_w = reinterpret_cast<uint32_t*>(s_q + T);
  const int p = tid % Np;
  const int lead = tid - p;
  const int g = blockIdx.x * (T / Np) + tid / Np;
  const bool valid = g < a.G;
  const int c = valid ? g * Np + p : 0;
  const size_t C = (size_t)a.G * Np;
  // a replicated launch: the chain's replication's density and words
  if constexpr (kRepOf<Source>) src.bind(c, a.words, dens);

  float th[D], prop[D];
  float w = 0.0f;
  for (int i = 0; i < D; ++i) th[i] = valid ? a.theta[(size_t)c * D + i] : 0.0f;
  if (valid) w = a.w[c];
  for (int i = 0; i < D; ++i) s_th[tid * D + i] = th[i];
  __syncthreads();

  // a partner's row: from the stage (K1) or, past L1, the history (K3)
  auto load = [&](const float* r, float* v) {
    for (int i = 0; i < D; ++i) {
      if constexpr (Source::kOneCta)
        v[i] = __ldcg(r + i);
      else
        v[i] = r[i];
    }
  };
  const float half_dm1 = 0.5f * (float)(D - 1);
  const int r_first = a.r_acc + 1 - a.stride;  // a sub-sweep block's first row
  int t_out = 0;  // trajectory rows written so far
  int next_emit = a.emit_first;  // the next window iteration stored
#pragma unroll 1
  for (int k = 0; k < a.K; ++k) {
    const int it = a.it0 + k;
    const WordSource W = a.words.at(k, (uint32_t)it, a.n_words);
    const Source sk = src.at(k, it);

    const bool base_phase = !kPost && a.random_gamma && it <= a.burnin;
    bool acc_any = false;

    for (int b = 0; b < kNBlk; ++b) {
      const int bo = b * a.blk_stride;  // the block sweep's first row
      acc_any = false;  // the last block's accepts are recorded
      // ---- the draws of the sub-sweep this chain proposes in
      const int mine = kSeq ? p : 0;
      const int off = bo + mine * a.stride;
      const int wb0 = (r_first + off) >> 2;
      // its words (the Philox blocks of rows r_first + off .. r_acc + off:
      // in the synchronous sweep exactly those, the same in every thread;
      // in the sequential one, whose threads' rows differ, the most any
      // alignment needs), and the group leader's beta-gate word (W adds
      // chain0: the leader's index in the population; row bo when the
      // configuration has no gate, and unused): where the synchronous
      // sweep's group lies in one warp (Np divides 32) from the leader's
      // own words across the warp, else from its own Philox block
      const int nb = kSeq ? (a.stride + 6) >> 2
                          : ((a.r_acc + off) >> 2) - wb0 + 1;
      const bool gate_lane = !kSeq && 32 % Np == 0;
      uint32_t w_gate = draw_words<kHoistBlocks<D>>(
          s_w + tid, T, W, c, wb0, nb, a.n_words, !gate_lane,
          max(a.r_gate, 0) + bo, valid ? g * Np : 0);
      auto word = [&](int row) {
        return s_w[(row + off - 4 * wb0) * T + tid];
      };
      if (gate_lane && a.r_gate >= 0)
        w_gate = __shfl_sync(__activemask(), word(a.r_gate), lead & 31);
      // partners: K1's group slots, K3's flat history indices (slots 0-1
      // the pair, 2-4 the triple, without replacement in each)
      int ia = 0, ib = 0, az = 0, bz = 0, cz = 0;
      uint32_t f[5] = {0u, 0u, 0u, 0u, 0u};
      if constexpr (Source::kOneCta) {
        const int n_slots = kSnooker ? 5 : 2;
        const int row0 = (b * a.n_members + mine) * n_slots;
        if (sk.idx) {
          for (int j = 0; j < n_slots; ++j)
            f[j] = (uint32_t)sk.idx[(size_t)(row0 + j) * sk.C + c];
        } else {
          // the index words: rows row0 .. row0 + n_slots - 1, two Philox
          // blocks
          const int ib0 = row0 >> 2;
          const ChainWords iw(sk.words, c);
          const uint4 v0 = iw.block((uint32_t)ib0),
                      v1 = iw.block((uint32_t)ib0 + 1u);
          for (int j = 0; j < n_slots; ++j) {
            const int r = row0 + j;
            f[j] = lane((r >> 2) == ib0 ? v0 : v1, (uint32_t)r);
          }
          f[0] = f[0] % sk.span;
          f[1] = f[1] % (sk.span - 1u);
          f[1] += f[1] >= f[0];
          if (kSnooker) {
            f[2] = f[2] % sk.span;
            f[3] = f[3] % (sk.span - 1u);
            f[4] = f[4] % (sk.span - 2u);
            f[3] += f[3] >= f[2];
            const uint32_t lo = min(f[2], f[3]), hi = max(f[2], f[3]);
            f[4] += f[4] >= lo;
            f[4] += f[4] >= hi;
          }
        }
      } else {
        ia = (int)(word(a.r_part) % (uint32_t)(Np - 1));
        ib = (int)(word(a.r_part + 1) % (uint32_t)(Np - 2));
        ib += ib >= ia;
        ia += ia >= p;
        ib += ib >= p;
        if (kSnooker) {
          az = (int)(word(a.r_triple) % (uint32_t)Np);
          bz = (int)(word(a.r_triple + 1) % (uint32_t)(Np - 1));
          cz = (int)(word(a.r_triple + 2) % (uint32_t)(Np - 2));
          bz += bz >= az;
          const int lo = min(az, bz), hi = max(az, bz);
          cz += cz >= lo;
          cz += cz >= hi;
        }
      }
      // the partners' rows: from the history at once, so their loads
      // overlap the draws below (in a window, after the cluster barrier
      // that makes the last iteration's history row seen, placed behind
      // the Philox blocks above, so the row's stores are done by then);
      // from the stage (a short load) where they are used
      float pm[D], pn[D], z[D], zm[D], zn[D];
      auto load_partners = [&]() {
        if constexpr (Source::kOneCta) {
          load(sk.at(f[0]), pm);
          load(sk.at(f[1]), pn);
          if (kSnooker) {
            load(sk.at(f[2]), z);
            load(sk.at(f[3]), zm);
            load(sk.at(f[4]), zn);
          }
        } else {
          load(s_th + (lead + ia) * D, pm);
          load(s_th + (lead + ib) * D, pn);
          if (kSnooker) {
            load(s_th + (lead + az) * D, z);
            load(s_th + (lead + bz) * D, zm);
            load(s_th + (lead + cz) * D, zn);
          }
        }
      };
      if constexpr (Source::kOneCta) {
        if (b == 0 && k > 0) cluster_sync();
        load_partners();
      }
      float ub = 0.0f, g1 = 0.0f, g2 = 0.0f;
      if (a.random_gamma) {
        ub = to_uni(word(a.r_gamma));
        g1 = to_uni(word(a.r_gamma + 1)) * 0.5f + 0.5f;
        g2 = to_uni(word(a.r_gamma + 2)) * 0.5f + 0.5f;
      }
      float gsn = 0.0f;
      bool sn = false;
      if (kSnooker) {
        gsn = to_uni(word(a.r_sn)) + 1.2f;
        sn = to_uni(word(a.r_sn + 1)) <= a.theta_sn;
      }
      float eterm[D], nrm[D];
      bool keep[D];
      for (int i = 0; i < D; ++i) {
        eterm[i] = a.r_eps >= 0 ? to_uni(word(a.r_eps + i)) * a.eps2 - a.eps
                                : 0.0f;
        keep[i] = a.r_kappa >= 0 && !(to_uni(word(a.r_kappa + i)) >
                                      a.kappa_keep);
        nrm[i] = 0.0f;
      }
      // log u of the accept (the accept row is read in every mode)
      const float log_u =
          kMode == kAcceptMH ? logf(fmaxf(to_uni(word(a.r_acc)), FLT_MIN))
                             : 0.0f;
      // beta mutation: one gate per group and sweep, from the leader's
      // word; the normals in every chain, the radii from the first d rows,
      // then the angles (last: cosf's branch to its slow path ends the
      // code the compiler can interleave)
      const bool mut = a.r_gate >= 0 && to_uni(w_gate) <= a.beta;
      if (a.r_gate >= 0) {
        for (int i = 0; i < D; ++i) {
          const float u1 = fmaxf(to_uni(word(a.r_norm + i)), FLT_MIN);
          const float u2 = to_uni(word(a.r_norm + D + i));
          nrm[i] = sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
        }
      }

      // ---- the state's part, sub-sweep by sub-sweep
      for (int m = 0; m < (kSeq ? a.n_members : 1); ++m) {
        if (base_phase) {
          // softmax(w) CDF over each group (every thread takes part); min
          // mode's +inf weights (out-of-bounds scores) clamped, so the
          // exponentials stay finite
          const float wb = kMode == kAcceptMin ? fminf(w, kMinModeClamp) : w;
          s_q[tid] = wb;
          __syncthreads();
          seg_scan<false>(s_q, tid, p, Np, true);
          const float mx = s_q[lead + Np - 1];
          __syncthreads();
          s_q[tid] = expf(wb - (isfinite(mx) ? mx : 0.0f));
          __syncthreads();
          seg_scan<true>(s_q, tid, p, Np, true);
        }
        // the synchronous sweep runs every thread through the body (chain
        // 0's words and a zero group for the threads past the last group,
        // whose results are never written); in the sequential one only
        // group slot m proposes
        if (kSeq ? valid && p == m : true) {
          if constexpr (!Source::kOneCta) load_partners();
          if (a.random_gamma) {
            // past burn-in the base term is +0.0 and is still added: the
            // add turns -0.0 into +0.0 (sweep_body.cuh)
            float bterm[D];
            for (int i = 0; i < D; ++i) bterm[i] = 0.0f;
            if (base_phase) {
              // base chain drawn from softmax(w) over the group by inverse
              // CDF
              const float ubs = fmaxf(ub, FLT_MIN) * s_q[lead + Np - 1];
              int cnt = 0;
#pragma unroll 4
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

          // snooker: project the triple's zm, zn onto theta - z
          bool degen = false;
          float den0 = 0.0f;
          if (kSnooker) {
            float sp[D];
            for (int i = 0; i < D; ++i) sp[i] = th[i] - z[i];
            den0 = dot<D>(sp, sp);
            degen = den0 <= FLT_MIN;
            if (degen)
              for (int i = 0; i < D; ++i) sp[i] = 1.0f;
            const float dens2 = dot<D>(sp, sp);
            const float q1 = dot<D>(zm, sp) / dens2;
            const float q2 = dot<D>(zn, sp) / dens2;
            if (sn)
              for (int i = 0; i < D; ++i)
                prop[i] = th[i] + gsn * (q1 * sp[i] - q2 * sp[i]);
          }

          if (a.r_eps >= 0)
            for (int i = 0; i < D; ++i) prop[i] = prop[i] + eterm[i];
          if (a.r_kappa >= 0)
            for (int i = 0; i < D; ++i)
              if (keep[i]) prop[i] = th[i];
          // the block's dimensions only; a static index into the masks
          if constexpr (kNBlk > 1) {
            const uint32_t bm = b == 0 ? a.blk_mask[0] : a.blk_mask[1];
            for (int i = 0; i < D; ++i)
              if (!((bm >> i) & 1u)) prop[i] = th[i];
          }

          // snooker MH correction on the final proposal; a degenerate draw
          // z == theta proposes theta and is rejected with -inf
          float adj = 0.0f;
          if (sn) {
            if (degen)
              for (int i = 0; i < D; ++i) prop[i] = th[i];
            float a1[D];
            for (int i = 0; i < D; ++i) a1[i] = prop[i] - z[i];
            const float a1sq = dot<D>(a1, a1);
            adj = degen ? -INFINITY : half_dm1 * (logf(a1sq) - logf(den0));
          }
          if (mut) {
            for (int i = 0; i < D; ++i) prop[i] = th[i] + a.sigma * nrm[i];
            adj = 0.0f;  // a mutation carries no snooker correction
          }

          bool inb = true;
          for (int i = 0; i < D; ++i) {
            if (isfinite(a.lo[i])) inb = inb && prop[i] >= a.lo[i];
            if (isfinite(a.hi[i])) inb = inb && prop[i] <= a.hi[i];
          }
          float lp;
          if constexpr (kMode != kAcceptMH)
            lp = dens.like(prop);
          else
            lp = dens(prop);
          const float bad = kMode == kAcceptMin ? INFINITY : -INFINITY;
          const float wp = (inb && !isnan(lp)) ? lp : bad;
          bool acc;
          if constexpr (kMode == kAcceptMH) {
            float delta = wp - w;
            if (kSnooker) delta = delta + adj;
            acc = log_u <= delta;
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

    // the emission rule: k >= emit_first and (k - emit_first) %
    // emit_stride == 0, counted, not divided
    const bool emit = k == next_emit;
    if (emit) next_emit += a.emit_stride;
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
      // the next iteration reads this one's state: in K3 the history row
      // just written, by every CTA of the cluster (the cluster barrier
      // before the next iteration's history loads); the synchronous
      // sweep's stage is refreshed (the sequential sweep's is current)
      __syncthreads();
      if (!kSeq)
        for (int i = 0; i < D; ++i) s_th[tid * D + i] = th[i];
      __syncthreads();
    }
  }

  if (!valid) return;
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
