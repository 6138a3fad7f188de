"""Smoke test of the PyTorch/CUDA port (``demcmc_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero.  Every
``sample()`` of a model with a CUDA density runs as planned windows of
at most K iterations per K1 (K3) launch, cut where a migration gate
opens (K2 runs between two windows) and at the burn-in switch to the
post variant.  Its launch checks are the counts of
``plan_counts``, which this script derives from the gates alone.

1. build   the CUDA kernels from ``demcmc_tpu_torch/csrc`` (one ``nvcc``
           per source, all started together), in a thread while the main
           thread runs phase 37, ``main-hier``, which launches no kernel
           of the port;
2. philox  device Philox words equal the plain torch words bit for bit,
           and the noise panel fill's uniforms (10,000 × 3,072 at an
           evaluation's rows, two chain offsets) its plain version's;
3. K2      the migration kernel, in both its forms (one CTA; spread over
           the card: victims, ranks by counting, scatter), equals its
           plain version bit for bit, in bits-in mode, at (G, Np, d) =
           (8, 4, 2), (256, 16, 2), (4096, 16, 2), (4096, 4, 2) and
           (8192, 16, 2) with tied uniforms in pairs, and at G = 256 and
           4,096 with every leader's uniform tied; ±inf weights and -0.0
           victim values in every case;
4. K1      the DE-step kernel against its plain version at 4,096 chains:
           8 bits-in iterations crossing burn-in 4 with the migration gate
           set at the start, then one iteration on Philox words;
5. k1-super  K1 windows of K = super_k() iterations against K single
           launches and the plain window version, bit for bit, with every
           emission rule across burn-in and the post variant past it, on
           the 4,096-chain Gaussian, snooker at G = 4,096, the sequential
           sweep, LBA, the ABC noise panel and the discrete binomial;
6. k3-super  K3 windows (one CTA; on the Gaussian one thread block
           cluster) at the MVN flagship's shapes (32 lanes a chain over
           the dimensions; K = 64 asserted), at the MVN's C = 64 (8
           lanes) and on the Gaussian at C = 512 and 2,048 against single
           launches and the plain window, history included; then the
           window rule at its edge (the Gaussian with snooker at 1,024
           chains, the 30-dim MVN at 512): the chains a window of the
           kernel holds, a window at that many, ``sample()`` at the full
           population against its loop;
7. main    ``demcmc_tpu_torch.sample`` on the Gaussian (50 observations
           from numpy seed 0, G=256 groups of Np=16, burn-in 1,000, 3,000
           iterations) on ``cuda``: launches as planned, posterior means
           and sds within 0.01 of the quadrature oracle, max R̂ < 1.01;
8. main-super  ``sample()`` through planned windows against the
           one-launch-per-iteration loop, bit for bit, on the 4,096-chain
           Gaussian (thin 1) and the 65,536-chain snooker Gaussian (thin
           10): µs and launches per iteration of both, in turns;
9. trace   phase 7's ``sample()`` and its loop twin under
           ``torch.profiler``: every planned launch in the device trace;
           the device's busy time and idle share over each run;
10. timing  each kernel's device time per launch at the main path's
           shapes beside its plain version's and its bound;
11. K1-sync, K1-sequential  K1 with snooker (θs = 0.5) against its plain
           version at (G, Np, d) = (4096, 16, 2) synchronous and (4096, 4,
           2) sequential: 8 bits-in iterations crossing burn-in 4 with the
           gate set at the start, then one on Philox words; degenerate
           snooker draws (z = θ) must occur; then a window of 16 against
           its single launches and the plain window, bit for bit;
12. K3     the DE-MCz kernel against its plain version at the MVN shapes
           (C = 3, d = 30, n_initial = 124, sequential), at the MVN's C =
           32 and 64 (16 and 8 lanes a chain), C = 16 synchronous and C =
           3 without snooker, and
           at C = 512 and 2,048 (G = 128 and 512, Np = 4, synchronous),
           θs = 0.5: 8
           iterations with random history indices and words crossing
           burn-in, then one on Philox words and indices; the history row
           written must agree too, on the MVN bit for bit;
13. main-65k  path A, ``sample()`` on the 65,536-chain snooker Gaussian
           (G = 4,096, Np = 16, α = 0.1, θs = 0.1; burn-in 1,000, 3,000
           iterations, thin 10): launches as planned, posterior within
           0.01 of the oracle, max R̂ < 1.01;
14. main-mvn  path B, ``sample()`` on the 30-dim MVN DE-MCz flagship
           (burn-in 2,000, 50,000 iterations) against its loop twin, bit
           for bit: the reference's four assertions;
15. main-wide  the C = 512 DE-MCz Gaussian through ``sample()`` and its
           loop twin: posterior within 0.01, max R̂ < 1.01;
16. main-seq  path A's configuration with Np = 4, so the sequential sweep
           (16,384 chains), and its loop twin: posterior within 0.01, max
           R̂ < 1.01;
17. trace2  the 65,536-chain cell (1,500 iterations) and the MVN cell
           (5,000 iterations, and its loop twin) under ``torch.profiler``:
           every planned launch in the device trace, the idle share;
18. timing2  device ms per launch of K1 with snooker at 4,096 × 16 and
           sequential at 4,096 × 4, K2 fired and unfired at G = 4,096, K3
           at the MVN shape and at C = 512, beside the plain versions and
           the bounds;
19. K1-zoo  K1 against its plain version, bit for bit, on the LBA (256 ×
           16, 100 trials), pseudo-marginal ABC binomial (512 × 8, n_sim =
           10,000) and discrete binomial (256 × 12) densities, and on the
           ABC binomial at 4 × 64 and 2 × 64 sequential (16 lanes a
           chain) and at 2 groups of its ``block_chains`` limit (one
           lane a chain; the limit logged), and LBA at 256 × 16, 4 × 64
           and 2 groups of its limit (32, 16 and 1 lanes a chain over the
           trials), each on 100 and 37 trials with proposals putting
           trials at rt ≤ τ, and the discrete binomial at 2 × 256, 2 ×
           512 and 2 groups of its limit (4, 2 and 1 lanes a chain over
           the unique counts; the cell's 8) and on 20 unique counts: 8
           bits-in
           iterations crossing burn-in 4 with the gate set at the start,
           then one on Philox words; every discrete N integral and moved;
20. main-lba  ``sample()`` on the 4,096-chain LBA cell (burn-in 1,000,
           5,000 iterations; the cells, oracles and gates of phases 20-22
           are in ``port_cells.py``) and its loop twin, bit for bit: each
           posterior mean within 0.1 sd and sd within 10% of a float64
           importance-sampling oracle (ESS ≥ 10,000), max R̂ < 1.01;
21. main-abc  the 4,096-chain ABC binomial cell (3,000 iterations): θ's
           mean and sd within 0.01 of Beta(7, 5), max R̂ < 1.01;
22. main-discrete  the 3,072-chain discrete binomial cell (11,000
           iterations): every stored N integral, means and sds of N and p
           against the exact oracle, max R̂ < 1.01;
23. trace3  the three cells under ``torch.profiler``: every planned
           launch traced, the device's idle share;
24. timing3  device ms per launch of K1 on each new density beside its
           plain version and its bound;
25. k4     the KDE kernel K4 against its plain version at the abc_kde
           cell's shape (3,072 chains × 50 points × 10,000 simulations),
           at (5, 37, 1,537) and at (64, 1, 10,000), (40, 33, 4,173) and
           (8, 300, 2,500) with subnormal, tiny and huge bandwidths on the
           first chains (the true division forced on two): |K4 − plain| ≤
           2e-5·(1 + |plain|), every output finite;
26. main-kde  ``sample()`` on the 3,072-chain abc_kde cell through the
           unfused step (the cells, oracles and gates of phases 26-28 are
           in ``port_cells.py``): K4 launched once per iteration and once
           for the initial weights, K1, K2 and K3 never; (μ, σ) within
           0.01 of the float64 grid quadrature of the fixed-panel
           posterior, max R̂ < 1.01;
27. main-unfused-gauss  the 4,096-chain Gaussian with
           ``allow_fused=False``: no kernel of the port launched,
           posterior within 0.01 of the quadrature oracle, max R̂ < 1.01;
           the step's sweeps as CUDA graphs against eager, bit for bit
           (every unfused phase logs whether its step kept its graphs);
28. main-lnr  the 3,072-chain LNR cell (per-cell density through
           ``torch.func.vmap``): means and sds within 5% of a float64
           importance-sampling oracle, max R̂ < 1.01;
29. trace4  the abc_kde cell and the unfused Gaussian under
           ``torch.profiler``: kernel launches per iteration, K4's count,
           the device's idle share (the profiler traces a graph's kernels
           one by one, so the graphed Gaussian's times there are not its
           untraced times);
30. timing4  K4's device ms per launch at the cell's shape beside its
           plain version and its bound;
31. k-sweep  ``sample()`` with at most K ∈ {4, 16, 64, 256} iterations
           per launch on the 4,096-chain Gaussian (α = 0.1) and the MVN
           flagship (α = 0): µs and launches per iteration;
32. timing5  device ms per window launch of K1 (4,096 chains, past
           burn-in and in it) and K3 (MVN, C = 512) at the chosen K,
           beside the plain window version and the window's bound (K
           iterations' operations; the state moved once, the stored rows).
33. k3-mig  K3 with its migration gate and K2 between K3 iterations
           against the plain versions, bit for bit, at C = 512 (G = 128 ×
           Np = 4, synchronous) and at G = 4 × Np = 3, d = 30
           (sequential), θs = 0.5: 8 bits-in iterations crossing burn-in
           with gates open at the start and inside, then one on Philox
           words (θ, w, the history row, the accept flags, the gate
           written); a window of 16 against single launches;
34. k-blocks  K1 (4,096 × 16 synchronous, 4,096 × 4 sequential) and K3
           (C = 512) with the blocks (μ), (σ) against the plain versions,
           bit for bit, windows against single launches; ``sample()`` of
           the K3 case against its loop;
35. main-mcz-mig  the C = 512 DE-MCz Gaussian with α = 0.1
           (``port_cells.MCZ_MIG_CELL``) through ``sample()`` and its loop
           twin: one K3 per window, one K2 per open gate, bit for bit,
           posterior within 0.01, max R̂ < 1.01;
36. main-blocked  the 4,096-chain Gaussian with two blocks
           (``port_cells.BLOCKED_CELL``), the same gates;
37. main-hier  (run beside phase 1) the hierarchical model (20 subjects
           × 50 observations, d = 23, 6 chains; ``port_cells.HIER_CELL``)
           through the unfused step, no kernel launched: posterior means
           against a float64 quadrature with β0 integrated out, max R̂
           written down;
38. trace5  the mcz-mig and blocked cells under ``torch.profiler``;
39. timing6  device ms per launch of K1 and K3 with two blocks and of K3
           with the gate (one iteration and a window of K), and K2 at G =
           128, beside the plain versions and the bounds;
40. k1-greedy  K1 with the greedy accept, max (the bench Gaussian's
           objective) and min (the 2-d Rastrigin), against its plain
           version bit for bit at 4,096 × 16 (synchronous, θs = 0.5), 4,096
           × 4 (sequential) and with two constant blocks: 8 bits-in
           iterations crossing burn-in 4 with the gate set at the start
           and ∓inf weights in a group (min mode: the base select's
           clamp), then one on Philox words; out-of-bounds proposals
           scoring ∓inf; windows of 16 (every iteration stored, and none)
           and of K against single launches and the plain window;
41. main-opt-rastrigin  ``optimize()`` on the 2-d Rastrigin in float32
           through K1 min (``port_cells.OPT_RASTRIGIN_CELL``: 4,096
           chains, burn-in 1,000, 3,000 iterations, α = 0.1) in turns with
           its one-launch-per-iteration loop: launches as planned, no
           trajectory, final populations bit for bit equal, the optimum
           within the gate fixed on the CPU;
42. main-opt-mle  the same on the bench Gaussian's MLE through K1 max
           (``port_cells.OPT_MLE_CELL``): μ̂, σ̂ against the closed form;
43. main-opt-f64  the reference's float64 optimizations through the
           unfused step, no port kernel launched: ``examples/optimize.py``
           (best within 1e-8 of 0, argmin within 1e-5) and
           ``tests/test_optimization.py::test_gaussian_mle`` (1e-4); µs
           per iteration;
44. timing7  device ms per launch of K1 max and K1 min at 4,096 chains,
           one iteration and a window of K storing no row, beside the
           plain versions and the bounds.
45. k1-shard  K1 with ``chain0`` on each of 4 shards of the 4,096-chain
           Gaussian (θs = 0.25) against its plain version on the shard
           and the shard's slice of a launch on the whole population, bit
           for bit: 8 bits-in iterations (each shard reading its columns
           of the population's buffer) crossing burn-in with the gate set
           at the start, then one on Philox words;
46. main-mesh  ``sample()`` and ``optimize()`` with ``mesh=chain_mesh(
           devices=[cuda:0] * D)``: the 4,096-chain Gaussian and the
           65,536-chain snooker Gaussian on D = 2 and 4 (the unsharded run
           and each D in turns), the 4,096-chain Gaussian through the
           unfused step and opt-mle on 2 and 4, LBA and the ABC binomial
           at 4,096 chains (128 iterations) and abc_kde at 3,072 (32
           iterations, K4 per shard) on 2: every sharded run bit for bit
           the unsharded one, K1 launched once per planned window and
           shard, K2 once per open gate on the gathered population; µs
           and launches per iteration for each D;
47. timing8  device ms per fired exchange under a 4-shard mesh (the
           population gathered, K2, each shard's rows copied back) at G =
           256 and 4,096, checked bit for bit against the plain exchange
           and for not waiting on the card (issued behind a spin),
           beside the plain exchange and K2's bound; K1 on one shard of
           four beside its plain version and its bound.

48. main-chunked  ``sample()`` plain, with ``progress=True`` (20 chunks)
           and with ``checkpoint_every=700`` (chunks that do not divide
           the run), each bit for bit the others and the loop's kept rows
           (the only rows a run stores, streamed chunk by chunk to pinned
           host memory), launches as the plan with the chunks' edges: the
           Gaussian 4,096, on 2 shards of the card too, the snooker
           Gaussian 65,536 (thin 10), the mcz-mig cell (K3 and K2, a chunk
           edge on an open gate), LBA 4,096 and abc_kde 3,072 (300
           iterations, K4 through the unfused step);
49. main-ckpt  the Gaussian 4,096 (K1), the mcz-mig cell (K3 and K2, its
           saved gate open) and the unfused Gaussian interrupted at a
           checkpoint, loaded and resumed: bit for bit the uninterrupted
           run; each asynchronous write's ms and whether it overlapped the
           next chunk;
50. main-monitor  the Gaussian 4,096 with ``monitor=True`` (the streaming
           split-R̂ within 1e-2 of the draws'), and with ``stop_rhat=1.01``
           over 20,000 iterations (an early stop, R̂max ≤ 1.01, the draws
           through ``[main]``'s quadrature gate);
51. trace-chunked  the Gaussian 4,096 ``sample()`` under
           ``torch.profiler``: the copies to the host overlap the K1
           windows; hidden and exposed copy ms, the idle share, the host's
           final wait; the pinned allocation's cost cold and cached.
52. main-kde-fresh  ``sample()`` on the fresh-noise abc_kde cell (3,072
           chains, 10,000 simulations an evaluation, a new panel each
           time; ``port_cells.KDE_FRESH_CELL``) through the unfused step:
           K4 and the noise panel fill once per iteration and once for
           the initial weights, K1, K2 and K3 never; (μ, σ) within 0.01 of
           the quadrature of the synthetic likelihood averaged over 32
           panels, max R̂ < 1.01;
53. main-abc-fixed  the fixed-noise ABC binomial (4,096 chains, n_sim =
           10,000) through the unfused step, no port kernel launched: θ
           within 0.01 of the exact posterior of its step-function
           likelihood, max R̂ < 1.01;
54. main-custom  the unfused 4,096-chain Gaussian with custom strategy
           slots: a ``sample`` and a ``generate_proposal`` slot that
           delegate to their built-ins bit for bit the built-in run; the
           random walk from its key (two fills an iteration) near the
           quadrature posterior; tempering (sd ratio > 1.25);
           always-accept (acceptance 1); the tempered fitness on the
           fresh abc_kde cell (3,072 chains): one K4 launch for every
           cell under vmap, half the built-in fitness, then ``sample()``
           with K4 and the fill once an evaluation;
55. main-lv  Lotka–Volterra at the reference example's width (36
           chains): the card's density against the CPU's on 4,096 prior
           draws, then ``sample()`` (``port_cells.LV_CELL``), µs per
           iteration;
56. trace-kde-fresh  the fresh-noise cell under ``torch.profiler``: K4's
           and the fill's counts and device µs per iteration, the idle
           share;
57. timing9  the fill's device ms per launch at the panel's shape beside
           its plain version and its bound; K4's row on the fresh cell's
           inputs, held against its plain version.
58. k1-rep  the replicated K1 (``csrc/de_step_rep.cu``) against its plain
           version, bit for bit: the Gaussian (16 replications × 4 × 4;
           local chain words and, at α = 0, a packed run's global ones,
           windows of 16), LBA (4 replications of 100 trials each, lanes),
           the ABC and discrete binomials' data tables, the Gaussian
           MLE's greedy max: bits-in iterations crossing burn-in with
           every gate set at the start, then Philox words; then the
           main paths' shapes: ``[main-rep]``'s 64 × 4 × 4 on its seeds
           across the burn-in switch, ``[main-packed]``'s global words
           with a window of 16, ``[main-opt-rep]``'s greedy max at
           64 × 2 × 12; each replication's rows of a window of 16 bit for
           bit a solo K1 launch on its model, seed and chains;
59. k2-rep  the segmented K2 against its plain version and a per-segment
           numpy oracle, bit for bit, at 64 replications × 4 × 4: each
           replication's gate (local and global words), and a packed
           window's events;
60. main-rep  ``sample_replicated`` at ``bench.py:133-161``'s width
           (``port_cells.REP_CELL``: 64 Gaussian datasets of 50
           observations from numpy seed 5, 4 × 4 chains each, burn-in 100,
           α = 0.1): launches as the plan over the 64 replications' gates
           (K1 windows and K2 launches per iteration logged),
           replications 0, 31 and 63 bit for bit their solo ``sample()``,
           each replication's posterior means within ``REP_TOL`` of its
           quadrature, max R̂ < 1.01; the 64 run in turn through
           ``sample()``, wall time against the batch's;
61. main-packed  ``sample_replicated_packed`` on the same cell: K1
           windows of ``SUPER_K``, one K2 a window with an event, the same
           gates;
62. main-opt-rep  ``optimize_replicated`` through the replicated K1's
           greedy max on 64 datasets (``port_cells.OPT_REP_CELL``):
           replications 0, 31 and 63 bit for bit their solo
           ``optimize()``, each MLE within ``OPT_REP_TOL`` of the closed
           form;
63. main-rep-mesh  ``[main-rep]`` on 4 shards of the card, bit for bit;
64. trace-rep  ``[main-rep]`` and ``[main-packed]`` at 2,100 iterations
           under ``torch.profiler``: µs and launches per iteration, the
           idle share;
65. timing10  the replicated K1's and the segmented K2's device ms per
           launch at ``[main-rep]``'s shape beside their plain versions
           and their bounds;
66. k3-shard  K3 with ``chain0`` on each of 4 shards of the mcz-mig
           population (C = 512, α = 0.1, the population's history, one
           launch): 8 bits-in iterations crossing burn-in (gates forced
           open at two), then one on Philox words, bit for bit its plain
           version and the unsharded K3's slice; each shard writes its
           own history columns and no other;
67. main-mesh-mcz  the mcz-mig cell at its 5,000 iterations and the
           two-block DE-MCz Gaussian (300) on 2 and 4 shards of the card,
           each bit for bit the unsharded run, history included: K3 once
           per iteration and shard, K2 once per open gate; µs per
           iteration beside the unsharded run's;
68. main-data-mesh  the 4,096-chain Gaussian (50 observations) on
           ``data_mesh(2, 2)`` of the card at 3,000 iterations: within
           0.01 of the quadrature, max R̂ < 1.01, bit for bit its
           piecewise-sum twin (the loglike of the two pieces summed in
           order, unsharded); LBA at 4,096 chains on ``data_mesh(2, 4)``
           (128 iterations), bit for bit its twin; every piece a tensor
           on its device; no kernel of the port launched (the unfused
           step);
69. main-dist  ``tools/dist_cards.py`` under torchrun: 2 processes on the
           card (gloo, staged through pinned memory) and, with 2 cards or
           more, 2 with a card each (NCCL), through
           ``global_chain_mesh()``: the 4,096-chain Gaussian and the
           mcz-mig cell, every rank bit for bit the single-process run;
           backend and µs per iteration logged;
70. rep-f7  two replications of the bench Gaussian (G = 256, Np = 16, α =
           0.1: 4,096 chains a replication, wider than K2's one CTA)
           through ``sample_replicated``: in turn, each bit for bit its
           solo ``sample()``, no replicated K1 or segmented K2 launch;
           ``sample_replicated_packed`` raises before any launch;
71. timing11  K3 on one shard of 4 of the mcz-mig population (128 chains,
           one iteration past burn-in) beside its plain version and its
           bound (row 3B-shard).

Before them, the host seconds of each cell's ``Chains.rhat()`` and the
script's total, each beside the card's name and power limit.  The last
three lines of standard output are the kernels' JSON line, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""

import contextlib
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import port_cells as pc

# comparison tolerance of K1 against its plain version, for θ and w:
# |kernel − plain| <= ATOL + RTOL·|plain|, about 8 float32 ulp
ATOL, RTOL = 1e-6, 1e-6
NEAR_TIE = 1e-4           # |log u − Δ| at or below this: accept may differ

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor op/s
PEAK_BYTES, PEAK_OPS = 3.35e12, 67e12
PHILOX_OPS = 100          # one block: 10 rounds of 2 mul.hi, 2 mul.lo,
                          # 4 xor, 2 key adds
K1_F32_OPS = 70           # per chain: proposal, ε, Box–Muller, density, MH
K2_F32_OPS = 8            # per chain: uniform, two logs, subtraction, max

G, NP, D = 256, 16, 2     # the bench configuration: 4,096 chains
C = G * NP
N_ITER, BURNIN = 3000, 1000
OUT = Path(__file__).resolve().parent / "chiprun_out"


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def ints(x):
    """Bit pattern of a float32 or uint32 tensor, for bitwise comparison."""
    return x.contiguous().view(torch.int32)


def random_words(rng, n_rows, n, dev):
    w = rng.integers(0, 2 ** 32, (n_rows, n), dtype=np.uint64)
    return torch.from_numpy(w.astype(np.uint32)).to(dev)


# ------------------------------------------- the launches a run must make


def _gates(key, it0, n, cfg):
    """The migration gates iterations it0 .. it0+n-1 write, from this
    script's own Philox call on the fire row (chain 0)."""
    from demcmc_tpu_torch import rng
    if cfg.alpha <= 0.0:
        return np.zeros(n, dtype=bool)
    w = rng.words_block(key, it0, n, 1, 1, row0=cfg.rows.fire)[:, 0, 0]
    return (rng.to_uni(w) <= np.float32(cfg.alpha)).numpy()


def plan_counts(model, de, n_iter, key, it0=None, k_max=None, thin=1,
                chunked=None, packed_key=None):
    """The launches ``sample(model, de, n_iter, key=key)`` must make,
    counted here from the gates alone: a K1 (K3) launch per window of at
    most ``k_max`` (the configured K) iterations, a new window at every
    iteration whose migration gate is open, at the burn-in switch to the
    post variant and, with ``chunked`` (the call's ``progress``,
    ``checkpoint_every`` and ``stop_rhat`` options), at every chunk's
    edge (``sampler.chunk_schedule``, held to the JAX loop's on the CPU);
    a K2 launch per open gate (the first one from the run's own GATE_NS
    word).

    ``key`` a list of seeds: a replicated run of them (replicated K1 and
    segmented K2), a gate open where any replication's opens; with
    ``packed_key`` too, the packed run of that many replications, its K1
    windows cut only at K and the switch, a K2 before each window that
    holds an (iteration, replication) event (PACKED_GATE_NS words of
    ``packed_key``)."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import rng, sampler
    from demcmc_tpu_torch.ops import fused_step, resample_step
    spec = tdm.make_spec(model, de)
    cfg = fused_step.StepConfig.make(model, de, spec)
    it0 = de.n_initial + 1 if it0 is None else it0
    if k_max is None:
        k_max = (resample_step.resample_super_k(cfg, "cuda")
                 if cfg.resample else fused_step.super_k())
    rep = isinstance(key, (list, tuple))
    keys = list(key) if rep else [key]
    fire0, gates = False, np.zeros(n_iter, dtype=bool)
    events = np.zeros(n_iter, dtype=bool)
    if packed_key is None:
        for k in keys:
            u0 = float(rng.to_uni(rng.words(k, it0, 1, 1,
                                            ns=rng.GATE_NS))[0, 0])
            fire0 |= cfg.alpha > 0.0 and u0 <= np.float32(cfg.alpha)
            gates |= _gates(k, it0, n_iter, cfg)
    elif cfg.alpha > 0.0:
        w = rng.words_block(packed_key, it0, n_iter, 1, len(keys),
                            ns=rng.PACKED_GATE_NS)[:, 0]
        events = (rng.to_uni(w) <= np.float32(cfg.alpha)).numpy().any(1)
    switch = de.burnin - (it0 - 1) if (cfg.random_gamma
                                        and de.burnin > 0) else None
    cuts = set()
    if chunked:
        chunks = sampler.chunk_schedule(
            n_iter, thin, chunked.get("checkpoint_every", 0),
            bool(chunked.get("progress")),
            chunked.get("stop_rhat") is not None,
            switch if switch is not None and switch > 0 else None)
        cuts = set((np.cumsum(chunks)[:-1] * thin).tolist())
    windows = opened = length = 0
    has_event = False
    for i in range(n_iter):
        opens = fire0 if i == 0 else bool(gates[i - 1])
        if i == 0 or opens or length == k_max or i == switch or i in cuts:
            opened += has_event
            windows, length, has_event = windows + 1, 0, False
        opened += int(opens)
        has_event |= bool(events[i])
        length += 1
    opened += has_event
    if rep:
        return {"de_step_rep": windows, "migrate_segments": opened}
    out = {"resample_step" if cfg.resample else "de_step": windows,
           "migrate": opened}
    if model.stochastic:        # the initial weights' noise panel
        out["philox_fill"] = 1
    return out


def quiet_start(key, cfg, lo, hi, K):
    """``(key, it)``: the first key from ``key`` on with an iteration ``it``
    in [lo, hi] that opens a window of ``K`` with no gate open before its
    last iteration (a window the sampler launches; at α = 0.1 one start in
    ~800 opens a quiet window of 64)."""
    n = hi - lo + 1
    for k in range(key, key + 256):
        c = np.concatenate([[0], np.cumsum(_gates(k, lo, n + K - 2, cfg))])
        quiet = np.flatnonzero(c[K - 1:K - 1 + n] == c[:n])
        if quiet.size:
            return k, lo + int(quiet[0])
    raise AssertionError(f"no quiet window of {K} in [{lo}, {hi}]")


# ---------------------------------------------------------------- phases


def phase_build():
    from demcmc_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    log("build", f"{len(paths)} libraries in "
        f"{time.perf_counter() - t0:.2f} s: "
        + ", ".join(p.name for p in paths.values()))
    for name in paths:
        for line in (_build.BUILD / f"lib{name}.log").read_text().splitlines():
            if "registers" in line or "bytes stack" in line:
                log("build", f"{name}: {line.strip()}")


def phase_build_beside_hier(dev):
    """The kernels' build (:func:`phase_build`, its nvcc processes) in a
    thread while the main thread runs ``[main-hier]``, which launches no
    kernel of the port: the host-bound hierarchical cell takes the
    build's minute off the script's clock.  Loading a library in that
    time raises (it would start a second nvcc for a source being built).
    Returns ``[main-hier]``'s launches and metrics; raises what the build
    raised."""
    import threading
    from demcmc_tpu_torch.ops import _build
    failed, secs = [], {}

    def build():
        t0 = time.perf_counter()
        try:
            phase_build()
        except BaseException as e:      # re-raised in the main thread
            failed.append(e)
        secs["build"] = time.perf_counter() - t0

    def refuse(name):
        raise AssertionError(f"main-hier loaded the {name} library while "
                             "the kernels build")
    thread = threading.Thread(target=build, name="build", daemon=True)
    library, _build.library = _build.library, refuse
    thread.start()
    try:
        t0 = time.perf_counter()
        out = phase_main_hier(dev)
        secs["hier"] = time.perf_counter() - t0
    finally:
        _build.library = library
        thread.join()
    if failed:
        raise failed[0]
    log("build", f"the build took {secs['build']:.1f} s and [main-hier] "
        f"{secs['hier']:.1f} s beside it")
    return out


def phase_philox(dev):
    """The device Philox fill against the plain torch words on the card,
    bit for bit: words of the step's namespace, and the uniforms of a
    stochastic model's noise panel at the fresh abc_kde cell's shape
    (10,000 × 3,072) at an evaluation's rows (block 1, member 2) and a
    shard's chains.  Returns 0.0, the largest |fill − plain| (any
    difference raises)."""
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import fused_step
    seed, it = (0x9E3779B97F4A7C15, 1234)
    out = torch.empty((17, C), dtype=torch.uint32, device=dev)
    fused_step.philox_fill(out, seed, it, rng.STEP_NS)
    want = rng.words(seed, it, 17, C, device=dev)
    torch.cuda.synchronize()
    if not torch.equal(ints(out), ints(want)):
        raise AssertionError("device Philox words differ from plain ones")
    log("philox", f"[17, {C}] device words equal the plain words bit for bit")
    c = pc.KDE_FRESH_CELL
    n, rows = c["n_groups"] * c["Np"], pc.KDE_N_SIM
    row0 = rng.eval_row(1, 2, c["Np"], rows)
    for chain0 in (0, 6 * c["Np"]):
        got = fused_step.philox_uniforms(seed, it, rows, n, rng.EVAL_NS, dev,
                                         row0=row0, chain0=chain0)
        plain = rng.to_uni(rng.words(seed, it, rows, n, rng.EVAL_NS, dev,
                                     row0=row0, chain0=chain0))
        torch.cuda.synchronize()
        if not torch.equal(got, plain):
            raise AssertionError("the device noise panel differs from the "
                                 "plain one")
    log("philox", f"[{rows}, {n}] noise panel (rows {row0}.., chains 0.. "
        f"and {6 * c['Np']}..) equal to the plain uniforms bit for bit")
    return 0.0


def _mig_case(rng, G_, Np_, dev, ties="pairs"):
    """θ with -0.0, w with ±inf and -0.0 (victims whose values the
    exchange turns to +0.0), words whose odd groups' leader words tie with
    the previous group's (same top 23 bits; ``ties="all"``: every leader's,
    so the ranks follow the group index alone)."""
    C_ = G_ * Np_
    theta = (rng.standard_normal((C_, D)) * 1e3
             + rng.random((C_, D)) * 1e-4).astype(np.float32)
    theta[rng.random((C_, D)) < 0.05] = -0.0
    theta[:Np_] = -0.0                   # group 0's victim: all -0.0
    w = rng.standard_normal(C_).astype(np.float32)
    w[rng.random(C_) < 0.1] = -np.inf
    w[rng.random(C_) < 0.05] = np.inf
    w[rng.random(C_) < 0.05] = -0.0
    words = rng.integers(0, 2 ** 32, (3, C_), dtype=np.uint64)
    if ties == "all":
        lead = np.arange(0, C_, Np_)
        words[0, lead] = ((words[0, 0] & ~np.uint64(0x1FF))
                          | rng.integers(0, 0x200, lead.size).astype(
                              np.uint64))
    else:
        lead = np.arange(Np_, C_, 2 * Np_)
        words[0, lead] = ((words[0, lead - Np_] & ~np.uint64(0x1FF))
                          | rng.integers(0, 0x200, lead.size).astype(
                              np.uint64))
    return (torch.tensor(theta, device=dev), torch.tensor(w, device=dev),
            torch.from_numpy(words.astype(np.uint32)).to(dev))


# K2's checked shapes (G, Np): the bench, the 65,536-chain cell, main-seq's
# 4,096 × 4 and the group limit, each in both forms of the kernel
K2_SHAPES = ((8, 4), (256, 16), (4096, 16), (4096, 4), (8192, 16))


@contextlib.contextmanager
def k2_form(mig, spread):
    """K2 held to one form inside the block: its chain threshold
    (``migration.ONE_CTA_MAX_CHAINS``) set to 0 (the spread form) or past
    every shape (one CTA), then restored."""
    keep = mig.ONE_CTA_MAX_CHAINS
    mig.ONE_CTA_MAX_CHAINS = 0 if spread else 1 << 30
    try:
        yield
    finally:
        mig.ONE_CTA_MAX_CHAINS = keep


def phase_k2(dev):
    """K2 in both forms (one CTA and spread) against its plain version,
    bit for bit, in bits-in mode at every shape of ``K2_SHAPES`` with tied
    leader words in pairs, and at G = 256 and 4,096 with every leader word
    tied; -0.0 victim values (turned to +0.0) in every case; fire = 0
    leaves the state as it was."""
    from demcmc_tpu_torch.ops import migration as mig
    rng = np.random.default_rng(2)
    worst = 0.0
    cases = [(G_, Np_, "pairs") for G_, Np_ in K2_SHAPES]
    cases += [(256, 16, "all"), (4096, 16, "all")]
    for G_, Np_, ties in cases:
        theta, w, words = _mig_case(rng, G_, Np_, dev, ties)
        one = torch.ones(1, dtype=torch.int32, device=dev)
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        tp, wp = theta.clone(), w.clone()
        mig.migrate_plain(tp, wp, one, words, G_, Np_)
        moved = int((ints(tp) != ints(theta)).any(1).sum())
        # the victims' values with -0.0, which the exchange writes as +0.0
        _, _, gum = mig.draws(words, G_, Np_)
        vid = torch.argmax(gum - w.view(G_, Np_), dim=1)
        gi = torch.arange(G_, device=dev)
        zeros = int((ints(theta.view(G_, Np_, D)[gi, vid]) == -2 ** 31).sum()
                    + (ints(w.view(G_, Np_)[gi, vid]) == -2 ** 31).sum())
        for spread in (False, True):
            tk, wk = theta.clone(), w.clone()
            tz, wz = theta.clone(), w.clone()
            with k2_form(mig, spread):
                mig.migrate(tk, wk, one, G_, Np_, bits=words)
                mig.migrate(tz, wz, zero, G_, Np_, bits=words)
            torch.cuda.synchronize()
            form = "spread" if spread else "one-CTA"
            if not (torch.equal(ints(tk), ints(tp))
                    and torch.equal(ints(wk), ints(wp))):
                raise AssertionError(f"K2 ({form}) differs from its plain "
                                     f"version at G={G_}, Np={Np_}, "
                                     f"ties={ties}")
            if not (torch.equal(ints(tz), ints(theta))
                    and torch.equal(ints(wz), ints(w))):
                raise AssertionError(f"K2 ({form}) changed the state with "
                                     f"fire = 0")
            fin = torch.isfinite(wp)
            worst = max(worst, float((tk - tp).abs().max()),
                        float((wk[fin] - wp[fin]).abs().max()))
        if moved == 0 or zeros == 0:
            raise AssertionError(f"K2 comparison at G={G_}, Np={Np_} moved "
                                 f"{moved} chains, {zeros} -0.0 victim "
                                 f"values")
        log("K2", f"G={G_} Np={Np_} ties={ties}: one-CTA and spread forms "
            f"bitwise equal to the plain version ({moved} chains moved, "
            f"{zeros} -0.0 victim values made +0.0); fire=0 leaves the "
            f"state unchanged")
    return worst


def _k1_setup(dev, burnin):
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian
    from demcmc_tpu_torch.ops import fused_step
    data = np.random.default_rng(0).standard_normal(50).astype(np.float32)
    model, de = gaussian.make(data=data, Np=NP, n_groups=G, burnin=burnin)
    spec = tdm.make_spec(model, de)
    cfg = fused_step.StepConfig.make(model, de, spec)
    return tdm, model, de, spec, cfg


def _check_close(pairs, clear, what, it):
    """Kernel and plain values agree within ATOL + RTOL·|plain| on the
    chains ``clear`` of near-ties, with the same infinities; returns the
    largest difference."""
    worst = 0.0
    for a, b in pairs:
        a, b = a[clear], b[clear]
        if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
            raise AssertionError(f"{what} finiteness differs at it={it}")
        fin = torch.isfinite(b)
        diff = (a[fin] - b[fin]).abs()
        if not bool((diff <= ATOL + RTOL * b[fin].abs()).all()):
            raise AssertionError(f"{what} differs from its plain version at "
                                 f"it={it}: max |diff| {float(diff.max())}")
        if not torch.equal(a[~fin], b[~fin]):
            raise AssertionError(f"{what} infinities differ at it={it}")
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    return worst


def _compare_iteration(cfg, model, spec, state, it, words=None, seed=0,
                       exact=False):
    """One iteration (K2 then K1) by the kernels and by the plain versions
    from the same state; returns the plain result, the largest θ/w
    difference, the number of chains excluded as near-ties and the
    number accepted.  ``exact``: θ, w, the trajectory row and every accept
    flag must be equal bit for bit (no near-tie excluded)."""
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import fused_step, migration as mig
    theta, w, fire = state
    dev = theta.device
    G_, Np_, C_ = cfg.G, cfg.Np, cfg.G * cfg.Np
    migrates = cfg.rows.mig >= 0
    k = [x.clone() for x in state]
    p = [x.clone() for x in state]
    ok = (torch.empty((C_, cfg.d), device=dev), torch.empty(C_, device=dev),
          torch.empty(C_, dtype=torch.bool, device=dev))
    op = tuple(torch.empty_like(x) for x in ok)
    if words is None:
        if migrates:
            mig.migrate(k[0], k[1], k[2], G_, Np_, seed=seed, it=it)
        fused_step.de_step(cfg, model, spec, *k, it, seed=seed, out=ok)
        words = rng.words(seed, it, cfg.rows.n_words, C_, device=dev)
    else:
        if migrates:
            mig.migrate(k[0], k[1], k[2], G_, Np_, bits=words)
        fused_step.de_step(cfg, model, spec, *k, it, out=ok, bits=words)
    if migrates:
        mig.migrate_plain(p[0], p[1], p[2], words, G_, Np_)
    margin = fused_step.de_step_plain(cfg, model, spec, *p, it, words,
                                      out=op)
    torch.cuda.synchronize()
    if exact:
        worst = 0.0
        for a, b in ((k[0], p[0]), (k[1], p[1]), (ok[0], op[0]),
                     (ok[1], op[1])):
            fin = torch.isfinite(a) & torch.isfinite(b)
            if bool(fin.any()):
                worst = max(worst, float((a[fin] - b[fin]).abs().max()))
        for a, b, what in ((k[0], p[0], "theta"), (k[1], p[1], "w"),
                           (ok[0], op[0], "trajectory theta"),
                           (ok[1], op[1], "trajectory w"),
                           (ok[2], op[2], "accept flags")):
            if not torch.equal(a.view(torch.uint8) if a.dtype == torch.bool
                               else ints(a), b.view(torch.uint8)
                               if b.dtype == torch.bool else ints(b)):
                raise AssertionError(f"K1 {what} differ from the plain "
                                     f"version at it={it}")
        if int(k[2][0]) != int(p[2][0]):
            raise AssertionError(f"K1 next migration gate differs at it={it}")
        return p, worst, 0, int(op[2].sum())
    clear = margin.abs() > NEAR_TIE
    if not torch.equal(ok[2][clear], op[2][clear]):
        raise AssertionError(f"K1 accept flags differ at it={it}")
    if int(k[2][0]) != int(p[2][0]):
        raise AssertionError(f"K1 next migration gate differs at it={it}")
    worst = _check_close(((k[0], p[0]), (k[1], p[1]), (ok[0], op[0]),
                          (ok[1], op[1])), clear, "K1", it)
    return p, worst, int((~clear).sum()), int(op[2].sum())


def phase_k1(dev):
    tdm, model, de, spec, cfg = _k1_setup(dev, burnin=4)
    s = tdm.init_state(model, de, spec, 3, device=dev)
    state = [s.theta, s.weight, torch.ones(1, dtype=torch.int32, device=dev)]
    rng = np.random.default_rng(4)
    worst = 0.0
    for it in range(1, 9):
        words = random_words(rng, cfg.rows.n_words, C, dev)
        state, err, ties, n_acc = _compare_iteration(cfg, model, spec,
                                                     state, it, words=words)
        worst = max(worst, err)
        log("K1", f"bits-in it={it} ({'burn-in' if it <= 4 else 'sampling'}"
            f", fire in={'1' if it == 1 else 'drawn'}): {n_acc} accepted, "
            f"max |diff| {err:.3g}, {ties} near-ties excluded")
    state, err, ties, n_acc = _compare_iteration(cfg, model, spec, state, 9,
                                                 seed=77)
    worst = max(worst, err)
    log("K1", f"Philox it=9: {n_acc} accepted, max |diff| {err:.3g}, "
        f"{ties} near-ties excluded")
    log("K1", f"tolerance |kernel - plain| <= {ATOL:g} + {RTOL:g}|plain|; "
        f"max |diff| over all iterations {worst:.3g}")
    return worst


def phase_main(dev):
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian
    from demcmc_tpu_torch.ops import fused_step
    data = np.random.default_rng(0).standard_normal(50).astype(np.float32)
    model, de = gaussian.make(data=data, Np=NP, n_groups=G, burnin=BURNIN)
    n_iter = N_ITER

    _reset_counts()
    chains = tdm.sample(model, de, n_iter, key=0)
    torch.cuda.synchronize()
    launches = _counts()
    want = plan_counts(model, de, n_iter, key=0)
    log("main", f"launches on the main path: {launches} (the gates' plan: "
        f"{want})")
    _counts(**want)

    truth = gaussian.posterior_grid(data)
    for name in ("mu", "sigma"):
        m, s = chains.mean(name), chains.std(name)
        tm, ts = truth[name]["mean"], truth[name]["std"]
        log("main", f"{name}: mean {m:.5f} (oracle {tm:.5f}), sd {s:.5f} "
            f"(oracle {ts:.5f})")
        if abs(m - tm) >= 0.01 or abs(s - ts) >= 0.01:
            raise AssertionError(f"{name} posterior off the oracle")
    rhat = float(np.max(chains.rhat()))
    draws = chains.data
    if draws.shape != (n_iter - de.burnin, D, C) or not np.isfinite(
            draws).all():
        raise AssertionError(f"bad draws: shape {draws.shape}")
    acc = float(chains.acceptance.mean())
    log("main", f"max R-hat {rhat:.5f}, acceptance {acc:.4f}, "
        f"draws {draws.shape}")
    if not rhat < 1.01:
        raise AssertionError("max R-hat >= 1.01")

    # the plain PyTorch versions driven the same way on the card
    spec = tdm.make_spec(model, de)
    cfg = fused_step.StepConfig.make(model, de, spec)
    s = tdm.init_state(model, de, spec, 0, device=dev)
    st = [s.theta, s.weight, s.fire]
    plain_iteration(cfg, model, spec, st, 1)
    torch.cuda.synchronize()
    n_plain = 200
    t0 = time.perf_counter()
    for it in range(2, 2 + n_plain):
        plain_iteration(cfg, model, spec, st, it)
    torch.cuda.synchronize()
    dtp = time.perf_counter() - t0
    log("main", f"plain versions on the card: {dtp / n_plain * 1e6:.2f} "
        f"us/iteration")
    return launches, {"acceptance": acc, "rhat_max": rhat,
                      "plain_us_per_iteration": dtp / n_plain * 1e6}


def _loop_run(model, de, n_iter, key, thin=1):
    """``sample()``'s work with one launch per iteration
    (``sampler.run_loop``: K2 and K1 at every iteration, or K3): returns
    the chains and the final state."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import sampler
    spec = tdm.make_spec(model, de)
    state = sampler._grow_history(tdm.init_state(model, de, spec, key),
                                  n_iter)
    step = tdm.build_step(model, de, spec)
    state, ys = sampler.run_loop(step, state, n_iter, thin)
    return sampler.bundle_samples(model, de, spec, ys, n_iter, thin), state


def _same_draws(tag, ca, cb, between):
    """Raise unless two ``Chains`` are equal bit for bit: draws, lp,
    acceptance."""
    for x, y, what in ((ca.data, cb.data, "draws"), (ca.lp, cb.lp, "lp"),
                       (ca.acceptance, cb.acceptance, "acceptance")):
        x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
        if x.shape != y.shape or x.tobytes() != y.tobytes():
            raise AssertionError(f"{tag}: {what} differ between {between}")


def _same_run(tag, a, b, between="the planned windows and the loop"):
    """Raise unless two ``(chains, state)`` results are equal bit for
    bit: draws, lp, acceptance and the final θ, w, gate and history."""
    (ca, sa), (cb, sb) = a, b
    _same_draws(tag, ca, cb, between)
    if sa.iteration != sb.iteration:
        raise AssertionError(f"{tag}: final iterations differ")
    for k in ("theta", "weight", "fire", "history"):
        x, y = getattr(sa, k), getattr(sb, k)
        if x is not None and not torch.equal(ints(x).cpu(), ints(y).cpu()):
            raise AssertionError(f"{tag}: final {k} differs between "
                                 f"{between}")


def _windows_vs_loop(tag, model, de, n_iter, key, thin=1,
                    turns=("windows", "loop")):
    """``sample()`` through planned windows against the same run with
    one launch per iteration (:func:`_loop_run`), in this call: equal bit
    for bit (:func:`_same_run`); the windows' launches the plan's
    (:func:`plan_counts`), the loop's one of each kernel per iteration.
    Each run is one synchronised call on the host clock, in the order
    ``turns``.  Returns µs and launches per iteration of both."""
    import demcmc_tpu_torch as tdm
    want = {"windows": plan_counts(model, de, n_iter, key),
            "loop": {"resample_step" if de.uses_resample else "de_step":
                     n_iter, "migrate": n_iter if de.alpha > 0.0 else 0,
                     "philox_fill": int(model.stochastic)}}
    runs, secs = {}, {}
    for which in turns:
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if which == "windows":
            out = tdm.sample(model, de, n_iter, key=key, thin=thin,
                             return_state=True)
        else:
            out = _loop_run(model, de, n_iter, key, thin)
        torch.cuda.synchronize()
        secs.setdefault(which, []).append(time.perf_counter() - t0)
        got = _counts()
        if got != {k: want[which].get(k, 0) for k in got}:
            raise AssertionError(f"{tag} {which}: launches {got}, expected "
                                 f"{want[which]}")
        runs[which] = out
    _same_run(tag, runs["windows"], runs["loop"])
    C_ = de.n_chains
    m = {"launches": want["windows"]}
    for which in ("windows", "loop"):
        us = float(np.mean(secs[which])) / n_iter * 1e6
        per = sum(v for k, v in want[which].items()
                  if k != "philox_fill") / n_iter
        m[f"{which}_us_per_iteration"] = us
        m[f"{which}_launches_per_iteration"] = per
        log(tag, f"{which}: {n_iter} iterations in "
            + ", ".join(f"{x:.4f}" for x in secs[which])
            + f" s = {us:.2f} us/iteration, {C_ / us * 1e6:.4g} "
            f"chain-steps/s; {per:.4f} launches/iteration "
            f"({want[which]})")
    log(tag, "the planned windows' draws, lp, acceptance and final state "
        "equal the one-launch-per-iteration loop's bit for bit")
    return m, runs["windows"][0]


def plain_iteration(cfg, model, spec, st, it, seed=0):
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import fused_step, migration as mig
    words = rng.words(seed, it, cfg.rows.n_words, C, device=st[0].device)
    mig.migrate_plain(st[0], st[1], st[2], words, G, NP)
    fused_step.de_step_plain(cfg, model, spec, *st, it, words)


def _device_to_host(e):
    """A device-to-host copy in a ``torch.profiler`` trace (CUPTI names
    them ``Memcpy DtoH``)."""
    return e["cat"] == "gpu_memcpy" and "DtoH" in e["name"]


def _busy(spans, lo=-float("inf"), hi=float("inf")):
    """Length of the union of the (start, end) spans, clipped to [lo, hi]."""
    busy, end = 0.0, lo
    for a, b in sorted(spans):
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy


def _trace_sample(tag, model, de, n_iter, names, fname, key=2, thin=1,
                  loop=False):
    """``sample()`` (``loop``: its one-launch-per-iteration twin,
    :func:`_loop_run`) under ``torch.profiler`` (CUPTI): the device trace
    must hold each kernel of ``names`` (key -> a substring of the name of
    the one kernel a call launches, or a tuple of them where a call
    launches several: K2's, :func:`k2_kernels`) as often as the plan
    (:func:`plan_counts`) or the loop says calls, and no other K2 kernel.
    Returns the device's busy time and idle share over the iteration loop
    (first to last launch of these kernels) and over the whole call (first
    to last device event), kernel launches per iteration and the time of
    the trajectory's copies to the host, while the kernels ran (hidden)
    and after the last launch (exposed); the mean traced time of a call
    (of its kernels summed) is logged."""
    import demcmc_tpu_torch as tdm
    from torch.profiler import ProfilerActivity, profile
    want = ({k: n_iter if k != "migrate" or de.alpha > 0.0 else 0
             for k in names} if loop
            else plan_counts(model, de, n_iter, key))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if loop:
            _loop_run(model, de, n_iter, key, thin)
        else:
            tdm.sample(model, de, n_iter, key=key, thin=thin)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    OUT.mkdir(exist_ok=True)
    path = OUT / fname
    prof.export_chrome_trace(str(path))
    dev_ev = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]

    def spans(pred):
        return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                for e in dev_ev if pred(e)]

    def named(e, x):
        return e["cat"] == "kernel" and x in e["name"]

    subs = {k: (n,) if isinstance(n, str) else tuple(n)
            for k, n in names.items()}
    each = {x: spans(lambda e, x=x: named(e, x))
            for xs in subs.values() for x in xs}
    counts = {x: len(v) for x, v in each.items()}
    calls = {k: want.get(k, 0) for k in names}
    log(tag, f"kernels in the device trace: {counts} "
        f"({'the loop' if loop else 'the plan'}: {want} calls)")
    if counts != {x: calls[k] for k, xs in subs.items() for x in xs}:
        raise AssertionError(f"{tag}: traced launches {counts}, expected "
                             f"{want} calls of {subs}")
    if "migrate" in names:      # no kernel of K2's other form
        k2 = sum(named(e, x) for e in dev_ev for x in K2_ONE_CTA + K2_SPREAD)
        if k2 != calls["migrate"] * len(subs["migrate"]):
            raise AssertionError(f"{tag}: {k2} K2 kernels traced, expected "
                                 f"{calls['migrate']} calls of "
                                 f"{subs['migrate']}")
    ours = {k: [sp for x in xs for sp in each[x]] for k, xs in subs.items()}
    every = spans(lambda e: True)
    lo = min(a for v in ours.values() for a, _ in v)
    hi = max(b for v in ours.values() for _, b in v)
    loop_busy = _busy(every, lo, hi)
    call = max(b for _, b in every) - min(a for a, _ in every)
    call_busy = _busy(every)
    d2h = spans(_device_to_host)
    copy = _busy(d2h, hi)
    hidden = _busy(d2h, lo, hi)
    mean = {k: sum(b - a for a, b in v) / calls[k]
            for k, v in ours.items() if calls[k]}
    out = {"traced_us_per_iteration": wall / n_iter * 1e6,
           "launches_per_iteration": sum(counts.values()) / n_iter,
           "span_us_per_iteration": (hi - lo) / n_iter,
           "span_busy_us_per_iteration": loop_busy / n_iter,
           "span_idle_share": 1.0 - loop_busy / (hi - lo),
           "call_idle_share": 1.0 - call_busy / call,
           "trajectory_copy_ms": copy / 1e3,
           "trajectory_copy_hidden_ms": hidden / 1e3,
           "trajectory_copies": len(d2h)}
    log(tag, f"sample() traced: {out['traced_us_per_iteration']:.2f} "
        f"us/iteration on the host clock; first to last launch "
        f"{out['span_us_per_iteration']:.2f} us/iteration on the device "
        f"clock, busy {out['span_busy_us_per_iteration']:.3f}, idle share "
        f"{out['span_idle_share']:.4f}; whole call {call / 1e3:.3f} ms, idle "
        f"share {out['call_idle_share']:.4f}; trajectory copies to the "
        f"host: {len(d2h)}, {hidden / 1e3:.3f} ms of them while the "
        f"kernels ran (hidden), {copy / 1e3:.3f} ms after the last launch "
        f"(exposed); "
        f"{out['launches_per_iteration']:.4f} kernel launches/iteration; "
        "mean traced time a call "
        + ", ".join(f"{k} {v:.3f} us" for k, v in mean.items())
        + f"; {len(every)} device events (trace in {path.name})")
    return out


# kernel names in the device trace: K1 and K3 are instantiations of
# step_body.cuh's sweep_kernel (sweep_kernel_lanes on the ABC binomial and
# LBA, sweep_kernel_dims on the MVN) over their partner sources; a K2 call
# is one kernel in its one-CTA form, three in its spread form
K1_NAME, K3_NAME = "GroupPartners", "HistoryPartners"
K2_ONE_CTA = ("migrate_kernel",)
K2_SPREAD = ("migrate_victims_kernel", "migrate_rank_kernel",
             "migrate_scatter_kernel")


def k2_kernels(de):
    """The kernels one K2 call launches on ``de``'s population."""
    from demcmc_tpu_torch.ops import migration as mig
    return (K2_SPREAD if de.n_groups * de.Np > mig.ONE_CTA_MAX_CHAINS
            else K2_ONE_CTA)


def phase_trace(dev):
    """``sample()`` as in phase 7 under ``torch.profiler``, and its
    one-launch-per-iteration twin: every launch the plan (the loop) says in
    the device trace; the device's busy time and idle share over each
    run."""
    from demcmc_tpu_torch.models import gaussian
    data = np.random.default_rng(0).standard_normal(50).astype(np.float32)
    model, de = gaussian.make(data=data, Np=NP, n_groups=G, burnin=BURNIN)
    names = {"de_step": K1_NAME, "migrate": k2_kernels(de)}
    out = {"trace_" + k: v for k, v in _trace_sample(
        "trace", model, de, N_ITER, names, "trace_main.json").items()}
    out.update({"trace_loop_" + k: v for k, v in _trace_sample(
        "trace-loop", model, de, N_ITER, names, "trace_main_loop.json",
        loop=True).items()})
    return out


# ---------------------------------------------------------------- timing


_cycles_per_ms = []


def cycles_per_ms():
    """Clock of ``torch.cuda._sleep`` (the spin kernel that holds the
    stream while launches are queued behind it)."""
    if not _cycles_per_ms:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        a.record()
        torch.cuda._sleep(20_000_000)
        b.record()
        torch.cuda.synchronize()
        _cycles_per_ms.append(20_000_000 / a.elapsed_time(b))
    return _cycles_per_ms[0]


def gapped_ms(fn, n=1):
    """Device time per call of ``fn`` over ``n`` calls enqueued right after a
    synchronisation, host gaps included (for a plain version that waits
    for the device inside, where no spin can queue its calls)."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / n
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n, False, enqueue_ms


def device_ms(fn, n):
    """Device time per call of ``fn``: ``n`` calls queued behind a spin
    kernel, so they run back to back whatever the host's enqueue time,
    timed with CUDA events.  Returns ``(ms, queued, host_ms)``: ``queued``
    is False when the spin ended before the host had queued every call
    (then the time includes host gaps); ``host_ms`` is the host's time to
    enqueue one call.  A ``fn`` that waits for the device inside (a host
    read, a copy from pageable memory) cannot be queued: it is timed by
    :func:`gapped_ms`."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    spin_ms = max(2.0 * n * host_ms, 5.0)
    # one call behind a spin twice its host time: if the spin is over when
    # it returns, the call waited for it
    torch.cuda._sleep(int(max(2.0 * host_ms, 5.0) * cycles_per_ms()))
    e = torch.cuda.Event()
    e.record()
    fn()
    blocks = e.query()
    torch.cuda.synchronize()
    if blocks:
        return gapped_ms(fn, n)
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * cycles_per_ms()))
        a.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        issue_ms = (time.perf_counter() - t0) * 1e3 / n
        b.record()
        queued = not a.query()
        torch.cuda.synchronize()
        if queued:
            break
        spin_ms *= 4
    return a.elapsed_time(b) / n, queued, issue_ms


def _exchange_work(G_, Np_, d):
    """(bytes, operations) of one fired K2 launch on ``G_ × Np_`` chains
    of dimension ``d``: the gate and every w read, the victims' θ and w
    read and written; a Philox block and the rank keys' arithmetic per
    chain, the rank network per group."""
    C_ = G_ * Np_
    nbytes = 4 + C_ * 4 + 2 * G_ * (d + 1) * 4
    ops = C_ * (PHILOX_OPS + K2_F32_OPS) + 4 * G_ * (G_.bit_length() - 1) ** 2
    return nbytes, ops


def phase_timing(dev, launches, errs):
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import fused_step, migration as mig
    tdm, model, de, spec, cfg = _k1_setup(dev, burnin=1000)
    s = tdm.init_state(model, de, spec, 5, device=dev)
    theta, w, fire = s.theta, s.weight, s.fire
    out = (torch.empty((C, D), device=dev), torch.empty(C, device=dev),
           torch.empty(C, dtype=torch.bool, device=dev))
    it = 2000                                 # past burn-in, as most are
    n_words = cfg.rows.n_words

    def k1():
        fused_step.de_step(cfg, model, spec, theta, w, fire, it, out=out)

    def k1_burnin():                          # the softmax base-select too
        fused_step.de_step(cfg, model, spec, theta, w, fire, 500, out=out)

    def k1_burnin_plain():
        words = rng.words(0, 500, n_words, C, device=dev)
        fused_step.de_step_plain(cfg, model, spec, theta, w, fire, 500, words,
                                 out=out)

    def k1_plain():
        words = rng.words(0, it, n_words, C, device=dev)
        fused_step.de_step_plain(cfg, model, spec, theta, w, fire, it, words,
                                 out=out)

    fired = torch.ones(1, dtype=torch.int32, device=dev)
    unfired = torch.zeros(1, dtype=torch.int32, device=dev)

    def k2():
        mig.migrate(theta, w, fired, G, NP, it=it)

    def k2_unfired():
        mig.migrate(theta, w, unfired, G, NP, it=it)

    def k2_plain():
        words = rng.words(0, it, mig.N_ROWS, C, device=dev)
        mig.migrate_plain(theta, w, fired, words, G, NP)

    # plain, kernel, kernel, plain: each reported time is the mean of two
    t = {}
    for name, fn, n in (("k1_plain", k1_plain, 2), ("k1", k1, 200),
                        ("k1", k1, 200), ("k1_plain", k1_plain, 2),
                        ("k1_burnin_plain", k1_burnin_plain, 2),
                        ("k1_burnin", k1_burnin, 200),
                        ("k1_burnin", k1_burnin, 200),
                        ("k1_burnin_plain", k1_burnin_plain, 2),
                        ("k2_plain", k2_plain, 2), ("k2", k2, 200),
                        ("k2_unfired", k2_unfired, 200), ("k2", k2, 200),
                        ("k2_plain", k2_plain, 2)):
        t.setdefault(name, []).append(device_ms(fn, n))
    ms = {k: float(np.mean([x for x, _, _ in v])) for k, v in t.items()}
    for k, v in t.items():
        log("timing", f"{k}: {ms[k]:.6f} ms per call on the device ("
            + ", ".join(f"{x:.6f}{'' if q else ' host-gapped'}"
                        for x, q, _ in v)
            + "); host issues a call in "
            + ", ".join(f"{h:.6f}" for _, _, h in v) + " ms")

    # least time for the same work: bytes (each input read once, each
    # output written once) over HBM bandwidth, operations over the
    # float32 peak.  K1's new θ and w are one output: the kernel writes
    # them twice (state and trajectory row), the bound counts them once.
    # Philox words count as whole 4-word blocks: a chain's own rows
    # (partners .. accept) and chain 0's gate row.
    r = cfg.rows
    own = {row >> 2 for row in range(r.partners, r.accept + 1)}
    k1_blocks = C * len(own) + (r.fire >> 2 not in own)
    k1_bytes = (C * (D + 1) * 4            # θ, w read
                + C * (D + 1) * 4 + C      # new θ, w and accept written
                + 4)                       # next migration gate
    k1_ops = k1_blocks * PHILOX_OPS + C * K1_F32_OPS
    k2_bytes, k2_ops = _exchange_work(G, NP, D)
    # in burn-in K1 also selects the γ₂ base: two segmented scans, an exp
    # and Np compares per chain and the base term; an unfired K2 reads the
    # gate and returns
    k1b_ops = k1_ops + C * (2 * (NP.bit_length() - 1) + NP + 3 * D + 10)
    rows = []
    for name, src, repl, key, nbytes, nops, err, plain in (
            ("de_step", "demcmc_tpu_torch/csrc/de_step.cu",
             "demcmc_tpu/ops/fused_step.py:1858", "k1", k1_bytes, k1_ops,
             errs["k1"], "k1_plain"),
            ("migrate", "demcmc_tpu_torch/csrc/migration.cu",
             "demcmc_tpu/ops/fused_step.py:946", "k2", k2_bytes, k2_ops,
             errs["k2"], "k2_plain"),
            ("de_step/burn-in", "demcmc_tpu_torch/csrc/de_step.cu",
             "demcmc_tpu/ops/fused_step.py:2287", "k1_burnin", k1_bytes,
             k1b_ops, errs["k1"], "k1_burnin_plain"),
            ("migrate/unfired", "demcmc_tpu_torch/csrc/migration.cu",
             "demcmc_tpu/ops/fused_step.py:2066", "k2_unfired", 4, 0,
             errs["k2"], "k2_plain")):
        tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_OPS * 1e3
        # the sampler launches K2 only where a gate is open: an unfired K2
        # is never launched on the main path
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl,
                     "launches": (0 if name.endswith("unfired") else
                                  launches[name.split("/")[0]]),
                     "max_abs_err": err, "ms": ms[key],
                     "plain_ms": ms[plain],
                     "bound_ms": max(tb, to),
                     "bound_by": "bytes" if tb >= to else "operations",
                     "library_ms": None})
        log("timing", f"{name}: {nbytes} bytes, {nops} operations")
    log("timing", f"migrate unfired: {ms['k2_unfired']:.5f} ms per launch")
    return rows


# ------------------------------------------ second slice: snooker, sequential
# sweep, DE-MCz resample (K3)

G65, N65 = 4096, 16                   # the 65,536-chain snooker Gaussian
NSEQ = 4                              # its groups cut to 4: sequential sweep
MVN_ITER, MVN_BURNIN = 50_000, 2_000  # the 30-dim MVN DE-MCz flagship
# float32 operations per chain and iteration, a·d + b, for the bounds of the
# second slice's kernels; each chain counts one of the three proposals, the
# one this run's words give it (_step_work)
F32_OPS_PER_DIM, F32_OPS = 2, 12          # every chain: bounds, MH
DE_F32_OPS_PER_DIM, DE_F32_OPS = 13, 18   # DE proposal, ε, κ; γ draws
SN_F32_OPS_PER_DIM, SN_F32_OPS = 24, 20   # snooker projection, correction,
                                          # ε, κ
BM_F32_OPS_PER_DIM = 13                   # Box–Muller normal + mutation
MVN_F32_OPS_PER_DIM, MVN_F32_OPS = 6, 20  # the MVN density
GAUSS_F32_OPS = 16                        # the Gaussian density
N_INITIAL = {"mvn": 124, "C512": 50,      # history seed rows of K3's cases
             "C2048": 50}
# the 30-dim MVN at populations where K3's lanes over the dimensions fall
# below 32 (C = 32: 16 lanes a chain; C = 64: 8), synchronous (C = 16, 32
# lanes), and at the flagship's population without snooker: (n_groups, Np,
# sweep, θs; None: the caller's)
MVN_LANE_CASES = {"mvn-l16": (8, 4, "auto", None),
                  "mvn-l8": (16, 4, "auto", None),
                  "mvn-sync": (2, 8, "sync", None),
                  "mvn-nosn": (1, 3, "auto", 0.0)}
N_INITIAL.update({k: N_INITIAL["mvn"] for k in MVN_LANE_CASES})


def _gauss_data():
    return np.random.default_rng(0).standard_normal(50).astype(np.float32)


def _degenerate(cfg, words):
    """Chains whose snooker gate is on and whose z is the chain itself (in
    their own sub-sweep block), read from the words."""
    from demcmc_tpu_torch import rng
    r = cfg.rows
    C_ = cfg.G * cfg.Np
    words = words.to(torch.int64)       # (no uint32 gather on CUDA)
    cols = torch.arange(C_, device=words.device)
    slot = cols % cfg.Np
    off = slot * r.stride if r.n_members > 1 else 0
    az = rng.randint(words[r.triple + off, cols], cfg.Np)
    on = rng.to_uni(words[r.snooker + 1 + off, cols]) <= np.float32(
        cfg.theta_snooker)
    return int(((az == slot) & on).sum())


def phase_k1_variants(dev):
    """K1 with snooker (θs = 0.5, synchronous, 4,096 × 16) and with the
    sequential sweep (θs = 0.5, 4,096 × 4) against the plain version: 8
    bits-in iterations crossing burn-in 4 with the gate set at the start,
    then one Philox iteration; then a bits-in window of 16 past burn-in
    (its inner gates shut) against its single launches and the plain
    window, bit for bit.  Returns the largest difference."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import rng as trng
    from demcmc_tpu_torch.models import gaussian
    from demcmc_tpu_torch.ops import fused_step
    worst = 0.0
    rng = np.random.default_rng(6)
    for sweep, Np_ in (("sync", 16), ("sequential", 4)):
        model, de = gaussian.make(data=_gauss_data(), Np=Np_, n_groups=G65,
                                  burnin=4, theta_snooker=0.5, sweep=sweep)
        spec = tdm.make_spec(model, de)
        cfg = fused_step.StepConfig.make(model, de, spec)
        s = tdm.init_state(model, de, spec, 7, device=dev)
        state = [s.theta, s.weight, torch.ones(1, dtype=torch.int32,
                                               device=dev)]
        degen = 0
        for it in range(1, 10):
            words = (random_words(rng, cfg.rows.n_words, G65 * Np_, dev)
                     if it < 9 else None)
            degen += _degenerate(cfg, words if words is not None else
                                 trng.words(78, it, cfg.rows.n_words,
                                            G65 * Np_, device=dev))
            state, err, ties, n_acc = _compare_iteration(
                cfg, model, spec, state, it, words=words, seed=78)
            worst = max(worst, err)
            log("K1-" + sweep, f"{'bits-in' if it < 9 else 'Philox'} it={it}"
                f" ({'burn-in' if it <= 4 else 'sampling'}): {n_acc} "
                f"accepted, max |diff| {err:.3g}, {ties} near-ties excluded")
        if degen == 0:
            raise AssertionError(f"K1 {sweep}: no degenerate snooker draw")
        K = 16
        bits = _closed_inner_gates(random_words(
            rng, K * cfg.rows.n_words, G65 * Np_, dev), cfg, K)
        _, acc, err = _window_check("K1-" + sweep, cfg, model, spec, state,
                                    10, K, (0, 1), "post", bits)
        worst = max(worst, err)
        log("K1-" + sweep, f"G={G65} Np={Np_} θs=0.5 n_members="
            f"{cfg.rows.n_members}: {degen} degenerate snooker draws (z = "
            f"θ) over 9 iterations, all equal to the plain version; a "
            f"window of {K} = its single launches = plain window, bit for "
            f"bit ({acc} stored accepts)")
    return worst


def _resample_case(dev, which, burnin, theta_sn, key=3, extra_rows=10):
    """(model, spec, cfg, state) of a K3 configuration: the MVN flagship
    (C = 3, d = 30, n_initial = 124), the MVN at a population of
    :data:`MVN_LANE_CASES`, the C = 512 Gaussian DE-MCz of
    bench.py:216-219 (G = 128, Np = 4, synchronous, n_initial = 50) or its
    twin at C = 2,048 (G = 512, a K3 window over a cluster of CTAs), with
    ``extra_rows`` history rows to write."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian, mvnormal
    from demcmc_tpu_torch.ops import fused_step
    if which == "mvn":
        model, de = mvnormal.make(d=30, n_obs=100, key=1, burnin=burnin,
                                  theta_snooker=theta_sn)
    elif which in MVN_LANE_CASES:
        G_, Np_, sweep, sn = MVN_LANE_CASES[which]
        model, de = mvnormal.make(d=30, n_obs=100, key=1, burnin=burnin,
                                  theta_snooker=theta_sn if sn is None
                                  else sn, n_groups=G_, Np=Np_, sweep=sweep)
    else:
        model, de = gaussian.make(data=_gauss_data(),
                                  n_groups=512 if which == "C2048" else 128,
                                  Np=4, alpha=0.0, sample="resample",
                                  n_initial=N_INITIAL[which], burnin=burnin,
                                  theta_snooker=theta_sn, sweep="sync")
    assert de.n_initial == N_INITIAL[which]
    spec = tdm.make_spec(model, de)
    cfg = fused_step.StepConfig.make(model, de, spec)
    s = tdm.sampler._grow_history(
        tdm.init_state(model, de, spec, key, device=dev), extra_rows)
    return model, spec, cfg, s


def _compare_resample(cfg, model, spec, state, it, words=None, idx=None,
                      seed=0, exact=False):
    """One iteration (K2 where the configuration migrates, gated on the
    state's flag, then K3) by the kernels and by the plain versions from
    the same state (θ, w, fire, history); returns the plain result, the
    largest θ/w/history-row difference, the near-ties excluded and the
    accepts.  ``exact``: θ, w, the trajectory row, the history row and
    every accept flag equal bit for bit (no near-tie excluded)."""
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import migration as mig
    from demcmc_tpu_torch.ops import resample_step as tres
    dev = state[0].device
    C_ = cfg.G * cfg.Np
    migrates = cfg.rows.mig >= 0
    k = [x.clone() for x in state]
    p = [x.clone() for x in state]
    ok = (torch.empty((C_, cfg.d), device=dev), torch.empty(C_, device=dev),
          torch.empty(C_, dtype=torch.bool, device=dev))
    op = tuple(torch.empty_like(x) for x in ok)
    if words is None:
        if migrates:
            mig.migrate(k[0], k[1], k[2], cfg.G, cfg.Np, seed=seed, it=it)
        tres.resample_step(cfg, model, spec, *k, it, seed=seed, out=ok)
        words = rng.words(seed, it, cfg.rows.n_words, C_, device=dev)
        idx = tres.indices(cfg, seed, it, device=dev)
    else:
        if migrates:
            mig.migrate(k[0], k[1], k[2], cfg.G, cfg.Np, bits=words)
        tres.resample_step(cfg, model, spec, *k, it, out=ok, bits=words,
                           idx=idx)
    if migrates:
        mig.migrate_plain(p[0], p[1], p[2], words, cfg.G, cfg.Np)
    margin = tres.resample_step_plain(cfg, model, spec, *p, it, words, idx,
                                      out=op)
    torch.cuda.synchronize()
    if exact:
        pairs = ((k[0], p[0], "theta"), (k[1], p[1], "w"),
                 (ok[0], op[0], "trajectory theta"),
                 (ok[1], op[1], "trajectory w"),
                 (k[3], p[3], "history"), (k[2], p[2], "gate"),
                 (ok[2], op[2], "accept flags"))
        for a, b, what in pairs:
            if not torch.equal(a.view(torch.uint8) if a.dtype == torch.bool
                               else ints(a), b.view(torch.uint8)
                               if b.dtype == torch.bool else ints(b)):
                raise AssertionError(f"K3 {what} differ from the plain "
                                     f"version at it={it}")
        return p, 0.0, 0, int(op[2].sum())
    clear = margin.abs() > NEAR_TIE
    if not torch.equal(ok[2][clear], op[2][clear]):
        raise AssertionError(f"K3 accept flags differ at it={it}")
    if int(k[2][0]) != int(p[2][0]):
        raise AssertionError(f"K3 gate differs at it={it}")
    worst = _check_close(((k[0], p[0]), (k[1], p[1]), (ok[0], op[0]),
                          (ok[1], op[1]), (k[3][it - 1], p[3][it - 1])),
                         clear, "K3", it)
    if not torch.equal(ints(k[3][:it - 1]), ints(p[3][:it - 1])):
        raise AssertionError(f"K3 changed history rows before it-1={it - 1}")
    return p, worst, int((~clear).sum()), int(op[2].sum())


def phase_k3(dev):
    """K3 against its plain version at the MVN shapes, at the MVN's lane
    cases (:data:`MVN_LANE_CASES`) and at C = 512 and 2,048, θs = 0.5 (the
    cases
    without snooker: 0): 8 iterations
    with random indices and words (indices-in + bits-in) crossing
    burn-in, then one on Philox words and indices; on the MVN bit for
    bit."""
    from demcmc_tpu_torch.ops import resample_step as tres
    worst = 0.0
    rng = np.random.default_rng(8)
    for which in ("mvn", *MVN_LANE_CASES, "C512", "C2048"):
        it0 = N_INITIAL[which] + 1
        model, spec, cfg, s = _resample_case(dev, which, burnin=it0 + 3,
                                             theta_sn=0.5)
        state = [s.theta, s.weight, s.fire, s.history]
        C_ = cfg.G * cfg.Np
        for k in range(9):
            it = it0 + k
            words = idx = None
            if k < 8:
                words = random_words(rng, cfg.rows.n_words, C_, dev)
                idx = tres.indices_from_words(cfg, random_words(
                    rng, tres.index_rows(cfg), C_, dev), it)
            state, err, ties, n_acc = _compare_resample(
                cfg, model, spec, state, it, words=words, idx=idx, seed=91,
                exact=which not in ("C512", "C2048"))
            worst = max(worst, err)
            log("K3-" + which, f"{'indices-in + bits-in' if k < 8 else 'Philox'}"
                f" it={it} ({'burn-in' if it <= it0 + 3 else 'sampling'}): "
                f"{n_acc} accepted, max |diff| {err:.3g}, {ties} near-ties "
                f"excluded")
        log("K3-" + which, f"C={C_} d={cfg.d} n_members={cfg.rows.n_members}"
            f" history {tuple(s.history.shape)}: equal to the plain "
            f"version{'' if which in ('C512', 'C2048') else ' bit for bit'}")
    return worst


def _reset_counts():
    """Every kernel's launch count to 0."""
    from demcmc_tpu_torch.ops import fused_step, kde, migration, resample_step
    fused_step.de_step.launches = 0
    migration.migrate.launches = 0
    resample_step.resample_step.launches = 0
    kde.kde_logpdf.launches = 0
    fused_step.philox_fill.launches = 0
    fused_step.de_step_rep.launches = 0
    migration.migrate_segments.launches = 0


def _counts(**want):
    """Every kernel's launch count; with ``want``, raise unless the counts
    are ``want`` (kernels not named there: 0).  ``philox_fill`` draws a
    stochastic model's noise panels (the initial weights' once, and each
    evaluation's in the unfused step) and a custom slot's key words."""
    from demcmc_tpu_torch.ops import fused_step, kde, migration, resample_step
    got = {"de_step": fused_step.de_step.launches,
           "migrate": migration.migrate.launches,
           "resample_step": resample_step.resample_step.launches,
           "kde_logpdf": kde.kde_logpdf.launches,
           "philox_fill": fused_step.philox_fill.launches,
           "de_step_rep": fused_step.de_step_rep.launches,
           "migrate_segments": migration.migrate_segments.launches}
    if want and got != {k: want.get(k, 0) for k in got}:
        raise AssertionError(f"launches {got}, expected {want}")
    return got


def _posterior_gate(tag, chains, data, n_draws, C_, tol=0.01):
    from demcmc_tpu_torch.models import gaussian
    truth = gaussian.posterior_grid(data)
    for name in ("mu", "sigma"):
        m, s = chains.mean(name), chains.std(name)
        tm, ts = truth[name]["mean"], truth[name]["std"]
        log(tag, f"{name}: mean {m:.5f} (oracle {tm:.5f}), sd {s:.5f} "
            f"(oracle {ts:.5f})")
        if abs(m - tm) >= tol or abs(s - ts) >= tol:
            raise AssertionError(f"{tag}: {name} posterior off the oracle")
    rhat = float(np.max(chains.rhat()))
    if chains.data.shape != (n_draws, 2, C_) or not np.isfinite(
            chains.data).all():
        raise AssertionError(f"{tag}: bad draws {chains.data.shape}")
    acc = float(chains.acceptance.mean())
    log(tag, f"max R-hat {rhat:.5f}, acceptance {acc:.4f}, draws "
        f"{chains.data.shape}")
    if not rhat < 1.01:
        raise AssertionError(f"{tag}: max R-hat >= 1.01")
    return rhat, acc


def phase_main_65k(dev):
    """Path A: ``sample()`` on the 65,536-chain snooker Gaussian
    (bench.py:186-188: G = 4,096, Np = 16, α = 0.1, θs = 0.1), burn-in
    1,000, 3,000 iterations, thin 10."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian
    data = _gauss_data()
    model, de = gaussian.make(data=data, Np=N65, n_groups=G65, burnin=1000,
                              alpha=0.1, theta_snooker=0.1)
    n_iter, thin = 3000, 10
    _reset_counts()
    chains = tdm.sample(model, de, n_iter, key=0, thin=thin)
    torch.cuda.synchronize()
    launches = _counts()
    want = plan_counts(model, de, n_iter, key=0)
    log("main-65k", f"launches: {launches} (the gates' plan: {want})")
    _counts(**want)
    rhat, acc = _posterior_gate("main-65k", chains, data,
                                (n_iter - 1000) // thin, G65 * N65)
    return launches, {"65k_rhat_max": rhat, "65k_acceptance": acc}


def phase_main_mvn(dev):
    """Path B: ``sample()`` on the 30-dim MVN DE-MCz flagship (bench.py:205:
    Np = 3, one group, θs = 0.1, resample, n_initial = 124, sequential
    sweep), burn-in 2,000, 50,000 iterations, with the reference's four
    assertions (multivariate_normal_tests.jl:65-69)."""
    from demcmc_tpu_torch.models import mvnormal
    model, de = mvnormal.make(d=30, n_obs=100, key=1, burnin=MVN_BURNIN)
    if not (de.sequential_sweep and de.uses_resample and de.n_initial == 124):
        raise AssertionError("not the flagship configuration")
    m, chains = _windows_vs_loop("main-mvn", model, de, MVN_ITER, key=3)
    launches = m.pop("launches")
    mu = chains.group("mu")                        # [Ns, 30, 3]
    if mu.shape != (MVN_ITER - MVN_BURNIN, 30, 3) or not np.isfinite(
            chains.data).all():
        raise AssertionError(f"bad draws {chains.data.shape}")
    means = mu.mean(axis=(0, 2))
    sds = mu.std(axis=(0, 2), ddof=1)
    sd_means = means.std(ddof=1)
    r = np.corrcoef(means, np.asarray(model.data, np.float64).mean(0))[0, 1]
    checks = {"all |sd - 0.1| < 0.01": bool(np.all(np.abs(sds - 0.1) < 0.01)),
              "all |mean| < 0.3": bool(np.all(np.abs(means) < 0.3)),
              "|std(means) - 0.1| < 0.01": bool(abs(sd_means - 0.1) < 0.01),
              "cor(data means, post means) > 0.98": bool(r > 0.98)}
    log("main-mvn", f"max |sd - 0.1| {np.abs(sds - 0.1).max():.5f}, max "
        f"|mean| {np.abs(means).max():.5f}, std(means) {sd_means:.5f}, cor "
        f"{r:.5f}, acceptance {float(chains.acceptance.mean()):.4f}: "
        f"{checks}")
    if not all(checks.values()):
        raise AssertionError("the MVN flagship misses a reference assertion")
    m = {"mvn_" + k: v for k, v in m.items()}
    m.update({"mvn_iterations_per_s": 1e6 / m["mvn_windows_us_per_iteration"],
              "mvn_max_sd_dev": float(np.abs(sds - 0.1).max()),
              "mvn_cor": float(r)})
    return launches, m


def phase_main_wide(dev):
    """The C = 512 DE-MCz Gaussian of bench.py:216-219 (G = 128, Np = 4,
    α = 0, θs = 0.1, resample, n_initial = 50, synchronous sweep) through
    ``sample()``: burn-in 1,000, 3,000 iterations, K3 3,000 times,
    posterior within 0.01 of the oracle, max R̂ < 1.01."""
    from demcmc_tpu_torch.models import gaussian
    data = _gauss_data()
    model, de = gaussian.make(data=data, n_groups=128, Np=4, alpha=0.0,
                              sample="resample", n_initial=50, burnin=1000,
                              theta_snooker=0.1, sweep="sync")
    n_iter = 3000
    m, chains = _windows_vs_loop("main-wide", model, de, n_iter, key=0)
    launches = m.pop("launches")
    _posterior_gate("main-wide", chains, data, n_iter - 1000, 512)
    return launches, {"wide_" + k: v for k, v in m.items()}


def phase_main_seq(dev):
    """Path A's configuration with groups of Np = 4 (G = 4,096, 16,384
    chains, α = 0.1, θs = 0.1), where the default sweep is the sequential
    one (demcmc_tpu/config.py:86): ``sample()`` with burn-in 1,000, 3,000
    iterations, thin 10; K1 (sequential) and K2 launched 3,000 times each,
    posterior within 0.01 of the oracle, max R̂ < 1.01."""
    from demcmc_tpu_torch.models import gaussian
    data = _gauss_data()
    model, de = gaussian.make(data=data, Np=NSEQ, n_groups=G65, burnin=1000,
                              alpha=0.1, theta_snooker=0.1)
    if not de.sequential_sweep:
        raise AssertionError("Np = 4 should sweep sequentially")
    n_iter, thin = 3000, 10
    m, chains = _windows_vs_loop("main-seq", model, de, n_iter, key=0,
                                thin=thin)
    launches = m.pop("launches")
    _posterior_gate("main-seq", chains, data, (n_iter - 1000) // thin,
                    G65 * NSEQ)
    return launches, {"seq_" + k: v for k, v in m.items()}


def phase_trace_slice2(dev):
    """The 65,536-chain snooker Gaussian (1,500 iterations, burn-in 1,000,
    thin 10) and the MVN flagship (5,000 iterations, burn-in 2,000) under
    ``torch.profiler``: every launch in the device trace, and the device's
    idle share over each loop."""
    from demcmc_tpu_torch.models import gaussian, mvnormal
    model, de = gaussian.make(data=_gauss_data(), Np=N65, n_groups=G65,
                              burnin=1000, alpha=0.1, theta_snooker=0.1)
    out = {"trace_65k_" + k: v for k, v in _trace_sample(
        "trace-65k", model, de, 1500, {"de_step": K1_NAME,
                                       "migrate": k2_kernels(de)},
        "trace_65k.json", thin=10).items()}
    model, de = mvnormal.make(d=30, n_obs=100, key=1, burnin=MVN_BURNIN)
    names = {"resample_step": K3_NAME}
    out.update({"trace_mvn_" + k: v for k, v in _trace_sample(
        "trace-mvn", model, de, 5000, names, "trace_mvn.json").items()})
    out.update({"trace_mvn_loop_" + k: v for k, v in _trace_sample(
        "trace-mvn-loop", model, de, 5000, names, "trace_mvn_loop.json",
        loop=True).items()})
    return out


def _step_work(cfg, words, dens_ops, evaluated=None):
    """(bytes, operations) that one K1 or K3 iteration needs for this run's
    words.  Each chain makes one of three proposals in each block sweep,
    and only its words, history rows and arithmetic count: the DE pair
    (kind 0), the snooker triple where the chain's snooker gate fired (1),
    or the mutation where its group's β gate fired (2, which replaces the
    other two and ε, κ).  Philox words count as whole 4-word blocks, each
    chain's in its own sub-sweep block, plus the group leader's β gate and
    chain 0's gate of the next iteration; K3's history indices come from
    RESAMPLE_NS blocks.  ``evaluated`` (bool ``[C]``, one synchronous
    sweep of one block): the chains whose density K1 evaluates, the
    others' noise panel and ``dens_ops`` not counted (K1 evaluates a noise
    density only in bounds, :func:`_proposals`); default every chain.
    Bytes: θ and w read once, the new θ, w, accept flags and gate written
    once; for K3 also the history rows read and the row written."""
    from demcmc_tpu_torch import rng
    r, d = cfg.rows, cfg.d
    G_, Np_ = cfg.G, cfg.Np
    C_ = G_ * Np_
    w64 = words.to(torch.int64)         # (no uint32 gather on CUDA)
    cols = torch.arange(C_, device=words.device)
    member = cols % Np_ if r.n_members > 1 else torch.zeros_like(cols)
    lead = (cols % Np_ == 0).to(torch.int64)
    if evaluated is None:
        evaluated = torch.ones(C_, dtype=torch.bool, device=words.device)
    elif r.n_blocks != 1 or r.n_members != 1:
        raise ValueError("evaluated: one synchronous sweep of one block")
    ev = evaluated.to(torch.int64)

    def span(start, n):
        return list(range(start, start + n)) if start >= 0 else []

    sn_gate = span(r.snooker + 1, 1) if r.snooker >= 0 else []
    ek = span(r.eps, d) + span(r.kappa, d)
    noise = span(r.noise, r.n_noise)        # an evaluated chain's panel
    rows = {0: span(r.partners, 2) + span(r.gamma, 3) + sn_gate + ek,
            1: span(r.triple, 3) + span(r.snooker, 2) + ek,
            2: span(r.normal, 2 * d)}
    slots = {0: [0, 1], 1: [2, 3, 4], 2: []} if cfg.resample else {}
    f32 = {0: DE_F32_OPS_PER_DIM * d + DE_F32_OPS,
           1: SN_F32_OPS_PER_DIM * d + SN_F32_OPS,
           2: BM_F32_OPS_PER_DIM * d}
    blocks = n_hist = ops = 0
    for b in range(r.n_blocks):
        bo = b * r.blk_stride
        kind = torch.zeros_like(cols)
        if r.snooker >= 0:
            u = rng.to_uni(w64[bo + r.snooker + 1 + member * r.stride, cols])
            kind[u <= np.float32(cfg.theta_snooker)] = 1
        if r.gate >= 0:
            u = rng.to_uni(w64[bo + r.gate].view(G_, Np_)[:, 0])
            kind[(u <= np.float32(cfg.beta)).repeat_interleave(Np_)] = 2

        def own(m, k, ld, e):
            blk = {(x + bo + m * r.stride) >> 2
                   for x in rows[k] + noise * e + span(r.accept, 1)}
            if ld and r.gate >= 0:
                blk.add((bo + r.gate) >> 2)     # the group's β gate
            return blk

        n = torch.bincount(((member * 3 + kind) * 2 + lead) * 2 + ev,
                           minlength=r.n_members * 12).tolist()
        for m in range(r.n_members):
            for k in range(3):
                for ld in (0, 1):
                    for e in (0, 1):
                        sset = b * r.n_members + m
                        idx = {(sset * cfg.n_slots + x) >> 2
                               for x in slots.get(k, [])}
                        cnt = n[((m * 3 + k) * 2 + ld) * 2 + e]
                        blocks += cnt * (len(own(m, k, ld, e)) + len(idx))
                        n_hist += cnt * len(slots.get(k, []))
                        ops += cnt * f32[k]
        ops += (C_ * (F32_OPS_PER_DIM * d + F32_OPS)
                + int(evaluated.sum()) * dens_ops)
    # chain 0 also reads the next iteration's migration gate
    blocks += int(r.fire >> 2 not in own(0, int(kind[0]), 1, int(ev[0])))
    ops += blocks * PHILOX_OPS
    nbytes = (_state_bytes(C_, d)           # θ, w in; θ, w, acc, gate out
              + (n_hist + C_ * cfg.resample) * d * 4)  # history in, row out
    return nbytes, ops


class _Seen:
    """A model that records the points its density is asked for (the
    plain step asks once per sub-sweep, ``[d, G, Np]`` columns)."""

    def __init__(self, model):
        self._model, self.points = model, []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def log_posterior_cols(self, spec, cols, noise=None):
        self.points.append(cols)
        return self._model.log_posterior_cols(spec, cols, noise)


def _proposals(cfg, model, spec, state, it, words, migrate=False):
    """``[C, d]`` proposals of one synchronous one-block K1 iteration from
    ``state`` (θ, w, gate) on ``words``, by the plain version, after the
    migration K2 makes where the gate is open (``migrate``); the state is
    left as it was."""
    from demcmc_tpu_torch.ops import fused_step, migration
    seen = _Seen(model)
    p = [x.clone() for x in state]
    if migrate and cfg.rows.mig >= 0:
        migration.migrate_plain(*p, words, cfg.G, cfg.Np)
    fused_step.de_step_plain(cfg, seen, spec, *p, it, words)
    if len(seen.points) != 1:
        raise ValueError("_proposals: one synchronous sweep of one block")
    return torch.movedim(seen.points[0], 0, -1).reshape(-1, cfg.d)


def _state_bytes(C_, d):
    """θ and w read once, the new θ, w, accept flags and gate written once
    (one iteration: its trajectory row is the new state)."""
    return C_ * (d + 1) * 4 * 2 + C_ + 4


def _window_work(cfg, seed, it0, K, n_emit, dens_ops, dev):
    """(bytes, operations) of one window of ``K`` iterations from ``it0``
    storing ``n_emit`` trajectory rows, for this run's words: the
    operations of its K iterations (:func:`_step_work`), and the bytes of
    the state read and written once (it stays in registers), θ, w and the
    accept flag of each stored row, the gate, and each iteration's
    history rows read and written (K3)."""
    from demcmc_tpu_torch import rng
    C_, d = cfg.G * cfg.Np, cfg.d
    hist = ops = 0
    for k in range(K):
        b, o = _step_work(cfg, rng.words(seed, it0 + k, cfg.rows.n_words, C_,
                                         device=dev), dens_ops)
        hist, ops = hist + b - _state_bytes(C_, d), ops + o
    nbytes = C_ * (d + 1) * 4 * 2 + 4 + n_emit * C_ * (d * 4 + 4 + 1) + hist
    return nbytes, ops


def phase_timing_slice2(dev, launches, errs):
    """Device time per launch of K1 with snooker at 4,096 × 16 and
    sequential at 4,096 × 4, K2 fired and unfired at G = 4,096, K3 at the
    MVN shape and at C = 512, each beside its plain version (plain,
    kernel, kernel, plain) and its bound."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.models import gaussian
    from demcmc_tpu_torch.ops import fused_step, migration as mig
    from demcmc_tpu_torch.ops import resample_step as tres
    model, de = gaussian.make(data=_gauss_data(), Np=N65, n_groups=G65,
                              burnin=1000, alpha=0.1, theta_snooker=0.1)
    spec = tdm.make_spec(model, de)
    cfg = fused_step.StepConfig.make(model, de, spec)
    s = tdm.init_state(model, de, spec, 5, device=dev)
    C_ = G65 * N65
    theta, w, fire = s.theta, s.weight, s.fire
    out = (torch.empty((C_, 2), device=dev), torch.empty(C_, device=dev),
           torch.empty(C_, dtype=torch.bool, device=dev))
    it = 2000
    fired = torch.ones(1, dtype=torch.int32, device=dev)
    unfired = torch.zeros(1, dtype=torch.int32, device=dev)

    def k1():
        fused_step.de_step(cfg, model, spec, theta, w, fire, it, out=out)

    def k1_plain():
        words = rng.words(0, it, cfg.rows.n_words, C_, device=dev)
        fused_step.de_step_plain(cfg, model, spec, theta, w, fire, it, words,
                                 out=out)

    def k2():
        mig.migrate(theta, w, fired, G65, N65, it=it)

    def k2_unfired():
        mig.migrate(theta, w, unfired, G65, N65, it=it)

    def k2_plain():
        words = rng.words(0, it, mig.N_ROWS, C_, device=dev)
        mig.migrate_plain(theta, w, fired, words, G65, N65)

    # K1 sequential at phase main-seq's shape
    model_q, de_q = gaussian.make(data=_gauss_data(), Np=NSEQ, n_groups=G65,
                                  burnin=1000, alpha=0.1, theta_snooker=0.1)
    spec_q = tdm.make_spec(model_q, de_q)
    cfg_q = fused_step.StepConfig.make(model_q, de_q, spec_q)
    s_q = tdm.init_state(model_q, de_q, spec_q, 5, device=dev)
    Cq = G65 * NSEQ
    out_q = (torch.empty((Cq, 2), device=dev), torch.empty(Cq, device=dev),
             torch.empty(Cq, dtype=torch.bool, device=dev))

    def k1q():
        fused_step.de_step(cfg_q, model_q, spec_q, s_q.theta, s_q.weight,
                           s_q.fire, it, out=out_q)

    def k1q_plain():
        words = rng.words(0, it, cfg_q.rows.n_words, Cq, device=dev)
        fused_step.de_step_plain(cfg_q, model_q, spec_q, s_q.theta,
                                 s_q.weight, s_q.fire, it, words, out=out_q)

    cases = {}
    for which, it3 in (("mvn", 2500), ("C512", 1500)):
        m3, spec3, cfg3, s3 = _resample_case(dev, which, burnin=(
            MVN_BURNIN if which == "mvn" else 1000), theta_sn=0.1, key=4,
            extra_rows=3000)
        C3 = cfg3.G * cfg3.Np
        st3 = (s3.theta, s3.weight, s3.fire, s3.history)
        o3 = (torch.empty((C3, cfg3.d), device=dev),
              torch.empty(C3, device=dev),
              torch.empty(C3, dtype=torch.bool, device=dev))

        def k3(a=(cfg3, m3, spec3, st3, it3, o3)):
            c3, mm, sp, st, i3, o = a
            tres.resample_step(c3, mm, sp, *st, i3, out=o)

        def k3_plain(a=(cfg3, m3, spec3, st3, it3, o3)):
            c3, mm, sp, st, i3, o = a
            C3_ = c3.G * c3.Np
            words = rng.words(0, i3, c3.rows.n_words, C3_, device=dev)
            idx = tres.indices(c3, 0, i3, device=dev)
            tres.resample_step_plain(c3, mm, sp, *st, i3, words, idx, out=o)

        cases[which] = (cfg3, it3, k3, k3_plain)

    t = {}
    seq = [("k1sn_plain", k1_plain, 2), ("k1sn", k1, 200), ("k1sn", k1, 200),
           ("k1sn_plain", k1_plain, 2),
           ("k1seq_plain", k1q_plain, 2), ("k1seq", k1q, 200),
           ("k1seq", k1q, 200), ("k1seq_plain", k1q_plain, 2),
           ("k2g_plain", k2_plain, 2), ("k2g", k2, 100),
           ("k2g_unfired", k2_unfired, 200), ("k2g", k2, 100),
           ("k2g_plain", k2_plain, 2)]
    for which, (_, _, k3, k3_plain) in cases.items():
        seq += [(f"k3{which}_plain", k3_plain, 2), (f"k3{which}", k3, 200),
                (f"k3{which}", k3, 200), (f"k3{which}_plain", k3_plain, 2)]
    for name, fn, n in seq:
        t.setdefault(name, []).append(device_ms(fn, n))
    ms = {k: float(np.mean([x for x, _, _ in v])) for k, v in t.items()}
    for k, v in t.items():
        log("timing2", f"{k}: {ms[k]:.6f} ms per call on the device ("
            + ", ".join(f"{x:.6f}{'' if q else ' host-gapped'}"
                        for x, q, _ in v)
            + "); host issues a call in "
            + ", ".join(f"{h:.6f}" for _, _, h in v) + " ms")

    # bounds: bytes (each input read once, each output written once) over
    # HBM bandwidth and operations over the float32 peak, for the work this
    # run's words need (_step_work)
    def bound(nbytes, nops):
        tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_OPS * 1e3
        return max(tb, to), "bytes" if tb >= to else "operations"

    d = 2
    k1_bytes, k1_ops = _step_work(
        cfg, rng.words(0, it, cfg.rows.n_words, C_, device=dev),
        GAUSS_F32_OPS)
    k1q_bytes, k1q_ops = _step_work(
        cfg_q, rng.words(0, it, cfg_q.rows.n_words, Cq, device=dev),
        GAUSS_F32_OPS)
    k2_bytes, k2_ops = _exchange_work(G65, N65, d)
    rows = []
    specs = [("de_step/snooker-65536", "demcmc_tpu_torch/csrc/de_step.cu",
              "demcmc_tpu/ops/fused_step.py:2322", "k1sn", k1_bytes, k1_ops,
              errs["k1_variants"], launches["65k"]["de_step"]),
             ("de_step/sequential-16384", "demcmc_tpu_torch/csrc/de_step.cu",
              "demcmc_tpu/ops/fused_step.py:2453", "k1seq", k1q_bytes,
              k1q_ops, errs["k1_variants"], launches["seq"]["de_step"]),
             ("migrate/G4096", "demcmc_tpu_torch/csrc/migration.cu",
              "demcmc_tpu/ops/fused_step.py:946", "k2g", k2_bytes, k2_ops,
              errs["k2"], launches["65k"]["migrate"])]
    for which, (cfg3, it3, _, _) in cases.items():
        C3, d3 = cfg3.G * cfg3.Np, cfg3.d
        dens = (MVN_F32_OPS_PER_DIM * d3 + MVN_F32_OPS if which == "mvn"
                else GAUSS_F32_OPS)
        nbytes, nops = _step_work(
            cfg3, rng.words(0, it3, cfg3.rows.n_words, C3, device=dev), dens)
        key = "mvn" if which == "mvn" else "wide"
        specs.append((f"resample_step/{'mvn30-C3' if which == 'mvn' else 'gauss-C512'}",
                      "demcmc_tpu_torch/csrc/de_step_resample.cu",
                      "demcmc_tpu/ops/fused_step.py:2224", f"k3{which}",
                      nbytes, nops, errs["k3"],
                      launches[key]["resample_step"]))
    for name, src, repl, key, nbytes, nops, err, n in specs:
        b, by = bound(nbytes, nops)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": n, "max_abs_err": err,
                     "ms": ms[key], "plain_ms": ms[key + "_plain"],
                     "bound_ms": b, "bound_by": by, "library_ms": None})
        log("timing2", f"{name}: {nbytes} bytes, {nops} operations, bound "
            f"{b:.3g} ms ({by})")
    rows.append({"name": "migrate/G4096-unfired", "route": "cuda",
                 "source": "demcmc_tpu_torch/csrc/migration.cu",
                 "replaces": "demcmc_tpu/ops/fused_step.py:2066",
                 "launches": 0,     # the sampler launches K2 only fired
                 "max_abs_err": errs["k2"], "ms": ms["k2g_unfired"],
                 "plain_ms": ms["k2g_plain"],
                 "bound_ms": 4 / PEAK_BYTES * 1e3, "bound_by": "bytes",
                 "library_ms": None})
    return rows


# ------------------------------------------ third slice: LBA, the
# pseudo-marginal ABC binomial and the discrete binomial on K1

# float32 operations of the densities, for the bounds (_step_work): LBA per
# trial and accumulator (two Φ/φ pairs of ~20, the pdf or cdf, clip, log)
# and per trial (t, the guard, 1/ts, the sum), plus the prior; the ABC
# binomial for θ in [0, 1] per simulation (the bit map's shift, or and
# subtract, the two compares, the and, the add) and per CDF entry it sums
# (j ≤ k), plus the log; the discrete binomial per lgamma32 (~40) and the
# rest
LBA_OPS_PER_ACC, LBA_OPS_PER_TRIAL, LBA_OPS = 58, 6, 40
ABC_OPS_PER_SIM, ABC_OPS_PER_N, ABC_OPS = 7, 12, 20
LGAMMA_OPS, DISC_OPS = 40, 20


def _lba_case(burnin, n_trials=100, Np=None, n_groups=None):
    """(model, de) of the LBA cell: 100 trials simulated with numpy seed 0
    at ν = (3, 2), A = 0.8, k = 0.2, τ = 0.3, G = 256 × Np = 16 (or the
    trials and groups given)."""
    from demcmc_tpu_torch.models import lba
    c = pc.LBA_CELL
    return lba.make(key=0, n_trials=n_trials, Np=Np or c["Np"],
                    n_groups=n_groups or c["n_groups"], burnin=burnin)


def _lba_lane_cases(dev, burnin):
    """(name, model, de) of LBA's lane checks, on 100 trials and on 37 (a
    count no L divides): the cell's Np = 16 (32 lanes a chain), Np = 64
    (16) and G = 2 groups of the density's ``block_chains`` limit (one
    lane a chain; the limit logged)."""
    from demcmc_tpu_torch.ops import fused_step
    model, _ = _lba_case(burnin)
    most = fused_step.block_chains(False, model.cuda_density, False, False,
                                   1, dev)
    log("K1-lba", f"fused_step.block_chains for the LBA density "
        f"(synchronous, no snooker, no blocks): {most}")
    out = [("lba-37", *_lba_case(burnin, 37))]
    for G_, Np_ in ((4, 64), (2, most)):
        for n in (100, 37):
            out.append((f"lba-{G_}x{Np_}" + ("-37" if n == 37 else ""),
                        *_lba_case(burnin, n, Np_, G_)))
    return out


def _abc_case(burnin):
    from demcmc_tpu_torch.models import binomial
    c = pc.ABC_CELL
    return binomial.make(N=10, k=6, abc=True, fresh_noise=True,
                         n_sim=pc.N_SIM, Np=c["Np"], n_groups=c["n_groups"],
                         burnin=burnin)


def _disc_case(burnin):
    from demcmc_tpu_torch.models import discrete_binomial
    c = pc.DISC_CELL
    return discrete_binomial.make(key=0, n_obs=50, dtype=np.float32,
                                  Np=c["Np"], n_groups=c["n_groups"],
                                  burnin=burnin)


ZOO = {"lba": (_lba_case, pc.LBA_CELL), "abc": (_abc_case, pc.ABC_CELL),
       "discrete": (_disc_case, pc.DISC_CELL)}
# unique counts of the discrete binomial's wider lane check: three rounds
# of 8 lanes, the last partial
DISC_WIDE_UNIQUE = 20


def _disc_lane_cases(dev, burnin):
    """(name, model, de) of the discrete binomial's lane checks besides the
    cell (256 × 12: 8 lanes a chain): G = 2 × Np = 256 (4 lanes), 2 × 512
    (2 lanes), G = 2 groups of the density's ``block_chains`` limit (one
    lane a chain; the limit logged), and the cell's shape on 50
    observations with DISC_WIDE_UNIQUE unique counts (0 .. 19, each at
    least once: three rounds of 8 lanes, the last partial)."""
    from demcmc_tpu_torch.models import discrete_binomial
    from demcmc_tpu_torch.ops import fused_step
    model, _ = _disc_case(burnin)
    most = fused_step.block_chains(False, model.cuda_density, False, False,
                                   1, dev)
    log("K1-discrete", f"fused_step.block_chains for the discrete density "
        f"(synchronous, no snooker, no blocks): {most}")

    def case(G_, Np_, data=None):
        return discrete_binomial.make(key=0, n_obs=50, data=data,
                                      dtype=np.float32, Np=Np_, n_groups=G_,
                                      burnin=burnin)
    g = np.random.default_rng(DISC_WIDE_UNIQUE)
    data = np.concatenate([np.arange(DISC_WIDE_UNIQUE), g.integers(
        0, DISC_WIDE_UNIQUE, 50 - DISC_WIDE_UNIQUE)])
    c = pc.DISC_CELL
    return [("discrete-2x256", *case(2, 256)),
            ("discrete-2x512", *case(2, 512)),
            (f"discrete-2x{most}", *case(2, most)),
            (f"discrete-{DISC_WIDE_UNIQUE}u",
             *case(c["n_groups"], c["Np"], data))]
ABC_WIDE_BOUNDS = ((-0.5, 1.5),)    # θ outside [0, 1] in bounds: the count


def _abc_lane_cases(dev, burnin):
    """(name, model, de) of the ABC binomial's lane checks (n_sim =
    10,000): G = 4 × Np = 64, where a chain gets 16 lanes, and G = 2 × Np
    = 64 with the sequential sweep (a warp holds chains that propose and
    chains that do not), G = 2 groups at the density's ``block_chains``
    limit (one lane a chain), and the cell's 512 × 8 with bounds (−0.5,
    1.5), where proposals outside [0, 1] take the density's count (the
    CDF recomputed a simulation); logs that limit."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import binomial
    from demcmc_tpu_torch.ops import fused_step
    dens = binomial.density(10, 6, pc.N_SIM)
    most = fused_step.block_chains(False, dens, False, False, 1, dev)
    log("K1-abc", f"fused_step.block_chains for the ABC density "
        f"(synchronous, no snooker, no blocks): {most}")

    def case(G_, Np_, **kw):
        return binomial.make(N=10, k=6, abc=True, fresh_noise=True,
                             n_sim=pc.N_SIM, Np=Np_, n_groups=G_,
                             burnin=burnin, **kw)
    c = pc.ABC_CELL
    wide = (binomial.make_model(10, 6, abc=True, fresh_noise=True,
                                n_sim=pc.N_SIM),
            tdm.DE(bounds=ABC_WIDE_BOUNDS, burnin=burnin, Np=c["Np"],
                   n_groups=c["n_groups"]))
    return [("abc-4x64", *case(4, 64)),
            ("abc-2x64-seq", *case(2, 64, sweep="sequential")),
            (f"abc-2x{most}", *case(2, most)),
            ("abc-wide", *wide)]


def phase_k1_zoo(dev):
    """K1 against its plain version on the LBA (256 × 16, 100 trials), ABC
    binomial (512 × 8, n_sim = 10,000) and discrete binomial (256 × 12)
    densities, and on the ABC binomial's and LBA's lane checks
    (:func:`_abc_lane_cases`, :func:`_lba_lane_cases`): 8 bits-in
    iterations crossing burn-in 4 with the migration gate set at the
    start, then one on Philox words; θ, w and the accept flags equal bit
    for bit, every discrete N integral, proposals in the wide-bounds
    case's count branch (in bounds, outside [0, 1]) in every iteration,
    and in each LBA case proposals with τ at or past the fastest trial's
    rt (trials at rt ≤ τ, their −inf in the fold).  Returns the largest
    |kernel − plain| of θ and w measured (0 when bitwise)."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import rng as trng
    from demcmc_tpu_torch.ops import accept, fused_step
    rng = np.random.default_rng(12)
    worst = 0.0
    cases = [(name, *case(burnin=4)) for name, (case, _) in ZOO.items()]
    for name, model, de in (cases + _abc_lane_cases(dev, burnin=4)
                            + _lba_lane_cases(dev, burnin=4)
                            + _disc_lane_cases(dev, burnin=4)):
        spec = tdm.make_spec(model, de)
        cfg = fused_step.StepConfig.make(model, de, spec)
        s = tdm.init_state(model, de, spec, 11, device=dev)
        state = [s.theta, s.weight, torch.ones(1, dtype=torch.int32,
                                               device=dev)]
        C_ = de.n_chains
        err, n_late, n_moved = 0.0, 0, 0
        for it in range(1, 10):
            words = (random_words(rng, cfg.rows.n_words, C_, dev)
                     if it < 9 else None)
            counted = ""
            if name.startswith("lba"):
                x = _proposals(cfg, model, spec, state, it, words
                               if it < 9 else trng.words(
                                   79, it, cfg.rows.n_words, C_, device=dev),
                               migrate=True)
                late = int((x[:, 4] >= float(model.data[1].min())).sum())
                n_late += late
                counted = f", {late} proposals with trials at rt ≤ τ"
            if name == "abc-wide":
                x = _proposals(cfg, model, spec, state, it, words
                               if it < 9 else trng.words(
                                   79, it, cfg.rows.n_words, C_, device=dev),
                               migrate=True)
                n_count = int((accept.in_bounds(spec, x)
                               & ((x[:, 0] < 0) | (x[:, 0] > 1))).sum())
                if not n_count:
                    raise AssertionError(f"K1 {name}: no proposal took the "
                                         f"count branch at it={it}")
                counted = f", {n_count} proposals by the count"
            before = state[0][:, list(cfg.int_dims)].clone()
            state, e, _, n_acc = _compare_iteration(
                cfg, model, spec, state, it, words=words, seed=79,
                exact=True)
            err = max(err, e)
            if cfg.int_dims:
                th = state[0][:, list(cfg.int_dims)]
                if not torch.equal(th, torch.round(th)):
                    raise AssertionError(f"K1 {name}: an integer dimension "
                                         f"is not integral at it={it}")
                moved = int((th != before).any(1).sum())
                n_moved += moved
                counted = f", N moved (snapped) in {moved} chains"
            log("K1-" + name, f"{'bits-in' if it < 9 else 'Philox'} it={it}"
                f" ({'burn-in' if it <= 4 else 'sampling'}): {n_acc} "
                f"accepted{counted}, equal bit for bit")
        trials = ""
        if name.startswith("lba"):
            if not n_late:
                raise AssertionError(f"K1 {name}: no proposal put a trial "
                                     f"at rt ≤ τ")
            trials = f", {len(model.data[1])} trials"
        if cfg.int_dims:
            if not n_moved:
                raise AssertionError(f"K1 {name}: no chain moved its "
                                     f"integer dimension")
            trials = (f", {len(model.cuda_density.data)} unique counts, "
                      f"{n_moved} integral moves of N")
        log("K1-" + name, f"G={de.n_groups} Np={de.Np} d={cfg.d} words per "
            f"chain {cfg.rows.n_words}{trials}: max |diff| {err:.3g} over 9 "
            f"iterations")
        worst = max(worst, err)
    return worst


def _zoo_sample(tag, name, key=0):
    """``sample()`` on a third-slice cell through planned windows,
    against the one-launch-per-iteration loop (:func:`_windows_vs_loop`).
    Returns the model, the windowed run's chains, its launches (the plan's) and
    the timings."""
    case, cell = ZOO[name]
    n_iter = cell["n_iter"]
    model, de = case(burnin=cell["burnin"])
    m, chains = _windows_vs_loop(tag, model, de, n_iter, key)
    launches = m.pop("launches")
    d = chains.data.shape[1]
    if chains.data.shape != (n_iter - cell["burnin"], d, de.n_chains) or \
            not np.isfinite(chains.data).all():
        raise AssertionError(f"{tag}: bad draws {chains.data.shape}")
    C_ = de.n_chains
    log(tag, f"acceptance {float(chains.acceptance.mean()):.4f}")
    m = {f"{name}_" + k: v for k, v in m.items()}
    m.update({f"{name}_chain_steps_per_s":
              C_ / m[f"{name}_windows_us_per_iteration"] * 1e6,
              f"{name}_acceptance": float(chains.acceptance.mean())})
    return model, chains, launches, m


RHAT_SECONDS = {}     # host seconds of each cell's Chains.rhat(), by tag
_RHAT_JOBS = []       # the R̂ gates under way (see _rhat_gate)


def _forked(fn, *args):
    """Run ``fn(*args)`` (numpy only, no CUDA) in a forked process while
    the card runs the next work; returns a function that waits for its
    result (raising if the process died)."""
    import multiprocessing as mp
    ctx = mp.get_context("fork")
    recv, send = ctx.Pipe(duplex=False)

    def child():
        send.send(fn(*args))

    proc = ctx.Process(target=child, daemon=True)
    proc.start()
    send.close()

    def wait():
        try:
            out = recv.recv()
        except EOFError:
            raise AssertionError(f"{fn.__name__}: its process died (exit "
                                 f"code {proc.exitcode})") from None
        proc.join()
        return out
    return wait


def _rhat_gate(tag, chains, key):
    """Start the cell's gate, max R̂ < RHAT_MAX of ``Chains.rhat()``, in a
    forked process (:func:`_forked`) on a core of its own while the next
    phases drive the card.  :func:`_rhat_results` waits for it, writes the
    value under ``key`` and applies the gate."""
    _RHAT_JOBS.append((tag, key, _forked(_rhat_child, chains),
                       chains.data.shape))


def _rhat_child(chains):
    t0 = time.perf_counter()
    rhat = float(np.max(chains.rhat()))
    return rhat, time.perf_counter() - t0


def _rhat_results(metrics):
    """Wait for every R̂ gate started by :func:`_rhat_gate`: log each value
    and its host seconds, write it into ``metrics``; raise if one fails or
    its process died."""
    jobs, failed = list(_RHAT_JOBS), []
    _RHAT_JOBS.clear()
    for tag, key, wait, shape in jobs:
        try:
            rhat, secs = wait()
        except AssertionError as e:
            raise AssertionError(f"{tag}: {e}") from None
        RHAT_SECONDS[tag] = secs
        metrics[key] = rhat
        log(tag, f"max R-hat {rhat:.5f} (Chains.rhat() of {shape} draws: "
            f"{secs:.2f} s on the host, in a process of its own)")
        if not rhat < pc.RHAT_MAX:
            failed.append(tag)
    if failed:
        raise AssertionError(f"{', '.join(failed)}: max R-hat >= "
                             f"{pc.RHAT_MAX}")


def phase_main_lba(dev):
    """``sample()`` on the LBA cell (port_cells.LBA_CELL): posterior means
    within 0.1 oracle sd and sds within 10% of the importance-sampling
    oracle (ESS ≥ 10,000; in a forked process beside the sampling), max R̂
    < 1.01."""
    case, cell = ZOO["lba"]
    oracle = _forked(pc.lba_oracle, *case(burnin=cell["burnin"])[0].data)
    model, chains, launches, m = _zoo_sample("main-lba", "lba")
    t0 = time.perf_counter()
    oracle = oracle()
    mean, sd, ess = oracle
    log("main-lba", f"oracle: ESS {ess:.0f} of 200,000 draws, ready "
        f"{time.perf_counter() - t0:.1f} s after the sampling; mean "
        f"{np.round(mean, 5)}, sd {np.round(sd, 5)}")
    if ess < pc.LBA_MIN_ESS:
        raise AssertionError(f"main-lba: the oracle's ESS is under "
                             f"{pc.LBA_MIN_ESS}")
    ok, (pm, ps, dm, ds) = pc.lba_gate(chains.data, oracle)
    for i, name in enumerate(chains.names):
        log("main-lba", f"{name}: mean {pm[i]:.5f} (oracle {mean[i]:.5f}, "
            f"{dm[i]:.4f} oracle sd off), sd {ps[i]:.5f} (oracle "
            f"{sd[i]:.5f}, {100 * ds[i]:.2f}% off)")
    if not ok:
        raise AssertionError("main-lba: posterior off the oracle")
    _rhat_gate("main-lba", chains, "lba_rhat_max")
    m.update({"lba_max_mean_dev_sd": float(dm.max()),
              "lba_max_sd_dev": float(ds.max())})
    return launches, m


def phase_main_abc(dev):
    """``sample()`` on the ABC binomial cell: posterior mean and sd of θ
    within 0.01 of Beta(7, 5), max R̂ < 1.01."""
    from demcmc_tpu_torch.models import binomial
    _, chains, launches, m = _zoo_sample("main-abc", "abc")
    truth = binomial.conjugate_posterior(10, 6)
    mean, sd = chains.mean("theta"), chains.std("theta")
    log("main-abc", f"theta: mean {mean:.5f} (Beta(7, 5) "
        f"{truth['mean']:.5f}), sd {sd:.5f} ({truth['std']:.5f})")
    if abs(mean - truth["mean"]) >= 0.01 or abs(sd - truth["std"]) >= 0.01:
        raise AssertionError("main-abc: posterior off the conjugate")
    _rhat_gate("main-abc", chains, "abc_rhat_max")
    m.update({"abc_mean": mean, "abc_sd": sd})
    return launches, m


def phase_main_discrete(dev):
    """``sample()`` on the discrete binomial cell (port_cells.DISC_CELL):
    every stored N integral; posterior means of N and p within
    DISC_MEAN_SD oracle sd of the exact oracle and their sds within
    DISC_SD_REL; max R̂ < 1.01."""
    model, chains, launches, m = _zoo_sample("main-discrete", "discrete")
    N = chains.group("N")
    if not np.array_equal(N, np.round(N)):
        raise AssertionError("main-discrete: a stored N is not integral")
    log("main-discrete", "every stored N integral")
    truth = pc.discrete_oracle(model.data)
    ok, rows = pc.discrete_gate(N, chains.group("p"), truth)
    for name, (mean, sd, dm, ds) in rows.items():
        log("main-discrete", f"{name}: mean {mean:.5f} (oracle "
            f"{truth[name][0]:.5f}, {dm:.4f} oracle sd off), sd {sd:.5f} "
            f"(oracle {truth[name][1]:.5f}, {100 * ds:.2f}% off)")
    if not ok:
        raise AssertionError("main-discrete: posterior off the oracle")
    _rhat_gate("main-discrete", chains, "discrete_rhat_max")
    m.update({"discrete_max_mean_dev_sd": max(r[2] for r in rows.values()),
              "discrete_max_sd_dev": max(r[3] for r in rows.values())})
    return launches, m


def phase_trace3(dev):
    """The three cells (1,000 iterations each, burn-in 500) under
    ``torch.profiler``: every launch in the device trace and the device's
    idle share over each loop."""
    out = {}
    for name, (case, _) in ZOO.items():
        model, de = case(burnin=500)
        out.update({f"trace_{name}_" + k: v for k, v in _trace_sample(
            "trace-" + name, model, de, 1000,
            {"de_step": K1_NAME, "migrate": k2_kernels(de)},
            f"trace_{name}.json").items()})
    return out


def _zoo_dens_ops(name, cfg, model):
    """float32 operations of one evaluation of the cell's density."""
    dens = model.cuda_density
    if name == "lba":
        return int(dens.params[11]) * (2 * LBA_OPS_PER_ACC
                                       + LBA_OPS_PER_TRIAL) + LBA_OPS
    if name == "abc":       # the cell's bounds are [0, 1]: two thresholds
        n_sim, N, k = cfg.rows.n_noise, int(dens.params[0]), int(
            dens.params[1])
        return (n_sim * ABC_OPS_PER_SIM + ABC_OPS_PER_N * min(N, k + 1)
                + ABC_OPS)
    return (int(dens.params[4]) + 1) * LGAMMA_OPS + DISC_OPS


def phase_timing3(dev, launches, err):
    """Device ms per launch of K1 on each new density at its path's shape
    (spin-queued; plain, kernel, kernel, plain), its bound (_step_work:
    the proposal each chain's words pick, the noise panel's Philox blocks
    and the density's operations of the chains whose density K1 evaluates
    (a noise density's: the proposals in bounds), its data buffer read
    once) and its launches over the path."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import accept, fused_step
    it = 2000
    cases, seq = {}, []
    for name, (case, cell) in ZOO.items():
        model, de = case(burnin=cell["burnin"])
        spec = tdm.make_spec(model, de)
        cfg = fused_step.StepConfig.make(model, de, spec)
        s = tdm.init_state(model, de, spec, 5, device=dev)
        C_ = de.n_chains
        out = (torch.empty((C_, cfg.d), device=dev),
               torch.empty(C_, device=dev),
               torch.empty(C_, dtype=torch.bool, device=dev))
        st = (s.theta, s.weight, s.fire)

        def k1(a=(cfg, model, spec, st, out)):
            c, mm, sp, x, o = a
            fused_step.de_step(c, mm, sp, *x, it, out=o)

        def k1_plain(a=(cfg, model, spec, st, out)):
            c, mm, sp, x, o = a
            words = rng.words(0, it, c.rows.n_words, c.G * c.Np, device=dev)
            fused_step.de_step_plain(c, mm, sp, *x, it, words, out=o)

        n = 20 if name == "abc" else 200
        cases[name] = (cfg, model, spec, st)
        seq += [(f"{name}_plain", k1_plain, 2), (name, k1, n), (name, k1, n),
                (f"{name}_plain", k1_plain, 2)]
    t = {}
    for key, fn, n in seq:
        t.setdefault(key, []).append(device_ms(fn, n))
    ms = {k: float(np.mean([x for x, _, _ in v])) for k, v in t.items()}
    for k, v in t.items():
        log("timing3", f"{k}: {ms[k]:.6f} ms per call on the device ("
            + ", ".join(f"{x:.6f}{'' if q else ' host-gapped'}"
                        for x, q, _ in v)
            + "); host issues a call in "
            + ", ".join(f"{h:.6f}" for _, _, h in v) + " ms")
    rows = []
    repl = {"lba": "demcmc_tpu/ops/fused_step.py:1539",
            "abc": "demcmc_tpu/ops/fused_step.py:2422",
            "discrete": "demcmc_tpu/ops/fused_step.py:2402"}
    for name, (cfg, model, spec, st) in cases.items():
        C_ = cfg.G * cfg.Np
        words = rng.words(0, it, cfg.rows.n_words, C_, device=dev)
        evaluated = None
        if cfg.rows.noise >= 0:     # K1 evaluates a noise density in bounds
            evaluated = accept.in_bounds(spec, _proposals(
                cfg, model, spec, st, it, words))
            log("timing3", f"de_step/{name}-{C_}: {int(evaluated.sum())} "
                f"of {C_} proposals in bounds, their density evaluated")
        nbytes, nops = _step_work(cfg, words, _zoo_dens_ops(name, cfg, model),
                                  evaluated)
        data = model.cuda_density.data
        nbytes += 0 if data is None else data.nbytes
        tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_OPS * 1e3
        rows.append({"name": f"de_step/{name}-{C_}", "route": "cuda",
                     "source": "demcmc_tpu_torch/csrc/densities/"
                               + {"lba": "lba.cuh", "abc": "binomial_abc.cuh",
                                  "discrete": "discrete_binomial.cuh"}[name],
                     "replaces": repl[name],
                     "launches": launches[name]["de_step"],
                     "max_abs_err": err, "ms": ms[name],
                     "plain_ms": ms[name + "_plain"],
                     "bound_ms": max(tb, to),
                     "bound_by": "bytes" if tb >= to else "operations",
                     "library_ms": None})
        log("timing3", f"de_step/{name}-{C_}: {nbytes} bytes, {nops} "
            f"operations, bound {max(tb, to):.3g} ms")
    return rows

# ------------------------------------------- fourth slice: the unfused step
# and the KDE kernel K4

KDE_OPS_PER_TERM = 7      # K4, per (chain, point, simulation): subtract,
                          # divide, |u|, compare, square, subtract, add
K4_NAME = "kde_kernel"    # K4 in the device trace
FILL_NAME = "philox_fill_kernel"   # the noise panel fill in the trace


def _kde_case(burnin):
    """(model, de) of the abc_kde cell: the model's widths at G = 512
    (port_cells.KDE_CELL), data and panel from port_cells.kde_inputs."""
    from demcmc_tpu_torch.models import abc_kde
    data, noise = pc.kde_inputs()
    c = pc.KDE_CELL
    return abc_kde.make(data=data, noise=noise, Np=c["Np"],
                        n_groups=c["n_groups"], burnin=burnin)


def _kde_args(C_, E, S, dev, seed):
    """K4's inputs as the cell's density makes them: μ + σ·panel for
    (μ, σ) near the posterior, Silverman's bandwidth per chain."""
    from demcmc_tpu_torch.utils import kde as kde_utils
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal(E).astype(np.float32), device=dev)
    mu = torch.tensor(rng.normal(0.14, 0.13, C_).astype(np.float32),
                      device=dev)
    sg = torch.tensor(rng.uniform(0.7, 1.3, C_).astype(np.float32),
                      device=dev)
    panel = torch.tensor(rng.standard_normal(S).astype(np.float32),
                         device=dev)
    sims = mu[:, None] + sg[:, None] * panel
    return x, sims, kde_utils.silverman_bandwidth(sims)


# K4's bandwidths outside the normal range, set on the first chains of
# the stress shapes: a subnormal h and a huge one (the true division) and
# the fast quotient's edges 2^-59.5 and 2^59; on the two tiny ones every
# hundredth simulation is set to x[0], so their sums are not all zero
K4_EDGE_H = (1e-39, 1e30, 2.0 ** -59.5, 2.0 ** 59)


def _kde_stress_args(C_, E, S, dev, seed):
    """:func:`_kde_args` with the bandwidths of K4_EDGE_H on the first
    chains."""
    x, sims, h = _kde_args(C_, E, S, dev, seed)
    for c, hc in enumerate(K4_EDGE_H):
        h[c] = hc
        if c in (0, 2):
            sims[c, ::100] = x[0]
    return x, sims, h


def phase_k4(dev):
    """K4 against its plain version on the card, at the cell's shape
    (3,072 chains × 50 points × 10,000 simulations), at an unaligned one
    (5 × 37 × 1,537) and at shapes that stress its (chain, point) mapping
    and its quotient: E = 1, E = 33 with n_sim not a multiple of the tile
    nor of 4, E = 300, each with the bandwidths of K4_EDGE_H on its first
    chains (the true division forced on two): |K4 − plain| ≤ 2e-5·(1 +
    |plain|) (the plain version takes the mean, then divides by h, and
    sums in torch's order), every output finite.  Returns the largest
    |K4 − plain|."""
    from demcmc_tpu_torch.ops import kde
    C_ = pc.KDE_CELL["n_groups"] * pc.KDE_CELL["Np"]
    worst = 0.0
    for shape, args in (((C_, pc.KDE_N_OBS, pc.KDE_N_SIM), _kde_args),
                        ((5, 37, 1537), _kde_args),
                        ((64, 1, 10_000), _kde_stress_args),
                        ((40, 33, 4173), _kde_stress_args),
                        ((8, 300, 2500), _kde_stress_args)):
        x, sims, h = args(*shape, dev, seed=shape[2])
        out = kde.kde_logpdf(x, sims, h, pc.KDE_FLOOR)
        torch.cuda.synchronize()
        ref = kde.kde_logpdf_plain(x, sims, h, pc.KDE_FLOOR)
        diff = (out - ref).abs()
        err, rel = float(diff.max()), float((diff / (1 + ref.abs())).max())
        log("k4", f"(C, E, S) = {shape}: max |K4 - plain| {err:.3g}, max "
            f"|K4 - plain| / (1 + |plain|) {rel:.3g}; output "
            f"{float(out.min()):.4f} .. {float(out.max()):.4f}")
        if not rel <= 2e-5 or not torch.isfinite(out).all():
            raise AssertionError(f"K4 disagrees with its plain version at "
                                 f"{shape}")
        worst = max(worst, err)
    return worst


def _unfused_sample(tag, model, de, n_iter, want, key=0):
    """``sample()`` of a cell through the unfused step (the first call,
    kernels already built), under ``torch.inference_mode()``: the step is
    a few thousand small torch operations an iteration, and the mode skips
    autograd's dispatch on each (the draws are the same bits either way);
    the launch counts must be ``want`` (0 for a kernel not named).
    Returns the chains, the counts and the wall time."""
    import demcmc_tpu_torch as tdm
    _reset_counts()
    with _made_steps() as made:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            chains = tdm.sample(model, de, n_iter, key=key,
                                allow_fused=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = _counts()
    log(tag, f"launches: {launches}; {_graph_state(made[-1])}")
    _counts(**want)
    d = chains.data.shape[1]
    if chains.data.shape != (n_iter - de.burnin, d, de.n_chains) or \
            not np.isfinite(chains.data).all():
        raise AssertionError(f"{tag}: bad draws {chains.data.shape}")
    C_ = de.n_chains
    log(tag, f"sample(): {n_iter} iterations in {dt:.4f} s = "
        f"{dt / n_iter * 1e6:.2f} us/iteration, {C_ * n_iter / dt:.4g} "
        f"chain-steps/s; acceptance {float(chains.acceptance.mean()):.4f}")
    return chains, launches, dt


@contextlib.contextmanager
def _made_steps():
    """The list of the unfused steps built inside the block."""
    from demcmc_tpu_torch import sampler
    made, init = [], sampler.UnfusedStep.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        made.append(self)
    sampler.UnfusedStep.__init__ = record
    try:
        yield made
    finally:
        sampler.UnfusedStep.__init__ = init


def _graph_state(step):
    """How an unfused step ran its sweeps: as CUDA graphs (how many), or
    eagerly and why."""
    if step._graphs is not None:
        return f"sweeps as CUDA graphs ({len(step._graphs)} keys)"
    return f"sweeps eager ({step.eager_reason or 'not eligible'})"


def _graph_vs_eager(tag, model, de, n_iter):
    """``sample()`` through the unfused step with its sweeps as CUDA graphs
    (the default) and with every iteration eager (``sampler.GRAPHS =
    False``), ``n_iter`` iterations each: the graphed step keeps its
    graphs, and the two runs' draws and accept flags are equal bit for
    bit.  Returns µs per iteration (graphed, eager)."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import sampler
    runs = {}
    try:
        for graphs in (True, False):
            sampler.GRAPHS = graphs
            with _made_steps() as made:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.inference_mode():
                    ch = tdm.sample(model, de, n_iter, key=5,
                                    allow_fused=False)
                torch.cuda.synchronize()
            runs[graphs] = (ch, (time.perf_counter() - t0) / n_iter * 1e6,
                            made[-1]._graphs is not None)
    finally:
        sampler.GRAPHS = True
    (a, us_g, kept), (b, us_e, _) = runs[True], runs[False]
    if not kept:
        raise AssertionError(f"{tag}: the unfused step left its CUDA graphs")
    if a.data.tobytes() != b.data.tobytes() or \
            a.acceptance.tobytes() != b.acceptance.tobytes():
        raise AssertionError(f"{tag}: the graphed run differs from the "
                             f"eager run")
    log(tag, f"sweeps as CUDA graphs against eager, {n_iter} iterations: "
        f"{us_g:.2f} against {us_e:.2f} us/iteration, draws and accepts "
        f"equal bit for bit")
    return us_g, us_e


def phase_main_kde(dev):
    """``sample()`` on the 3,072-chain abc_kde cell through the unfused
    step: K4 launched once per iteration and once for the initial
    weights, K1, K2 and K3 never; (μ, σ) within KDE_TOL of the float64
    grid quadrature of the fixed-panel posterior, max R̂ < 1.01."""
    c = pc.KDE_CELL
    model, de = _kde_case(c["burnin"])
    n_iter = c["n_iter"]
    chains, launches, dt = _unfused_sample(
        "main-kde", model, de, n_iter,
        {"kde_logpdf": n_iter + 1})
    t0 = time.perf_counter()
    oracle = pc.kde_oracle(*pc.kde_inputs())
    log("main-kde", f"oracle (grid quadrature, "
        f"{time.perf_counter() - t0:.1f} s): {oracle}")
    ok, rows = pc.kde_gate(chains["mu"], chains["sigma"], oracle)
    for name, (mean, sd) in rows.items():
        log("main-kde", f"{name}: mean {mean:.5f} (oracle "
            f"{oracle[name][0]:.5f}), sd {sd:.5f} (oracle "
            f"{oracle[name][1]:.5f})")
    if not ok:
        raise AssertionError("main-kde: posterior off the oracle")
    _rhat_gate("main-kde", chains, "kde_rhat_max")
    C_ = de.n_chains
    return launches, {"kde_us_per_iteration": dt / n_iter * 1e6,
                      "kde_chain_steps_per_s": C_ * n_iter / dt,
                      "kde_acceptance": float(chains.acceptance.mean())}


def phase_main_unfused_gauss(dev):
    """The 4,096-chain Gaussian of phase 5 with ``allow_fused=False``:
    no kernel of the port launched, posterior within 0.01 of the
    quadrature oracle, max R̂ < 1.01; then 300 iterations with the
    sweeps as CUDA graphs against eager, bit for bit
    (:func:`_graph_vs_eager`)."""
    from demcmc_tpu_torch.models import gaussian
    c = pc.GAUSS_UNFUSED_CELL
    data = _gauss_data()
    model, de = gaussian.make(data=data, Np=c["Np"], n_groups=c["n_groups"],
                              burnin=c["burnin"])
    n_iter = c["n_iter"]
    chains, launches, dt = _unfused_sample(
        "main-unfused-gauss", model, de, n_iter, {})
    rhat, acc = _posterior_gate("main-unfused-gauss", chains, data,
                                n_iter - c["burnin"], de.n_chains)
    model, de = gaussian.make(data=data, Np=c["Np"], n_groups=c["n_groups"],
                              burnin=150)
    us_g, us_e = _graph_vs_eager("main-unfused-gauss", model, de, 300)
    C_ = de.n_chains
    return launches, {"unfused_gauss_graph_us_per_iteration": us_g,
                      "unfused_gauss_eager_us_per_iteration": us_e,
                      "unfused_gauss_rhat_max": rhat,
                      "unfused_gauss_us_per_iteration": dt / n_iter * 1e6,
                      "unfused_gauss_chain_steps_per_s": C_ * n_iter / dt,
                      "unfused_gauss_acceptance": acc}


def phase_main_lnr(dev):
    """``sample()`` on the 3,072-chain LNR cell (per-cell density through
    ``torch.func.vmap``): no kernel of the port launched; each posterior
    mean and sd within 5% of the float64 importance-sampling oracle (ESS
    ≥ 10,000; in a forked process beside the sampling), max R̂ < 1.01."""
    from demcmc_tpu_torch.models import lnr
    c = pc.LNR_CELL
    model, de = lnr.make(Np=c["Np"], n_groups=c["n_groups"],
                         burnin=c["burnin"])
    n_iter = c["n_iter"]
    oracle = _forked(pc.lnr_oracle, *model.data)
    chains, launches, dt = _unfused_sample(
        "main-lnr", model, de, n_iter, {})
    t0 = time.perf_counter()
    oracle = oracle()
    mean, sd, ess = oracle
    log("main-lnr", f"oracle: ESS {ess:.0f} of 200,000 draws, ready "
        f"{time.perf_counter() - t0:.1f} s after the sampling")
    if ess < pc.LNR_MIN_ESS:
        raise AssertionError("main-lnr: the oracle's ESS is under "
                             f"{pc.LNR_MIN_ESS}")
    ok, (pm, ps, dm, ds) = pc.lnr_gate(chains.data, oracle)
    for i, name in enumerate(chains.names):
        log("main-lnr", f"{name}: mean {pm[i]:.5f} (oracle {mean[i]:.5f}, "
            f"{100 * dm[i]:.2f}% off), sd {ps[i]:.5f} (oracle {sd[i]:.5f}, "
            f"{100 * ds[i]:.2f}% off)")
    if not ok:
        raise AssertionError("main-lnr: posterior off the oracle")
    _rhat_gate("main-lnr", chains, "lnr_rhat_max")
    C_ = de.n_chains
    return launches, {"lnr_us_per_iteration": dt / n_iter * 1e6,
                      "lnr_chain_steps_per_s": C_ * n_iter / dt,
                      "lnr_max_mean_dev": float(dm.max()),
                      "lnr_max_sd_dev": float(ds.max())}


def _trace_unfused(tag, model, de, n_iter, fname, k4, fills=0):
    """``sample(..., allow_fused=False)`` under ``torch.profiler``: kernel
    launches per iteration (every kernel in the device trace from the
    first to the last, over ``n_iter``), K4's count where ``k4`` (once per
    iteration and once for the initial weights), the noise panel fill's
    (``fills`` launches), K4's and the fill's device µs per iteration, the
    kernels that take the most device time, and the device's busy time
    and idle share over that span."""
    import demcmc_tpu_torch as tdm
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tdm.sample(model, de, n_iter, key=2, allow_fused=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    OUT.mkdir(exist_ok=True)
    path = OUT / fname
    prof.export_chrome_trace(str(path))
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") in
          ("kernel", "gpu_memcpy", "gpu_memset")]
    path.unlink()       # hundreds of launches per iteration: too large to keep
    kern = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
             e["name"]) for e in ev if e["cat"] == "kernel"]
    if not kern:
        raise AssertionError(f"{tag}: no kernel in the device trace")
    n_k4 = sum(K4_NAME in name for _, _, name in kern)
    if n_k4 != (n_iter + 1 if k4 else 0):
        raise AssertionError(f"{tag}: {n_k4} K4 launches in the trace")
    n_fill = sum(FILL_NAME in name for _, _, name in kern)
    if n_fill != fills:
        raise AssertionError(f"{tag}: {n_fill} noise panel fills in the "
                             f"trace, expected {fills}")
    lo = min(a for a, _, _ in kern)
    hi = max(b for _, b, _ in kern)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
             for e in ev]
    busy = _busy(spans, lo, hi)
    out = {"traced_us_per_iteration": wall / n_iter * 1e6,
           "launches_per_iteration": len(kern) / n_iter,
           "loop_us_per_iteration": (hi - lo) / n_iter,
           "loop_busy_us_per_iteration": busy / n_iter,
           "loop_idle_share": 1.0 - busy / (hi - lo),
           "k4_device_us_per_iteration": sum(
               b - a for a, b, name in kern if K4_NAME in name) / n_iter,
           "fill_device_us_per_iteration": sum(
               b - a for a, b, name in kern if FILL_NAME in name) / n_iter}
    by_name = {}
    for a, b, name in kern:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / n_iter
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(tag, "device us per iteration by kernel: " + "; ".join(
        f"{v:.1f} {k[:70]}" for k, v in top))
    log(tag, f"sample() traced: {out['traced_us_per_iteration']:.2f} "
        f"us/iteration on the host clock; {len(kern)} kernel launches, "
        f"{out['launches_per_iteration']:.2f} per iteration ({n_k4} of "
        f"K4); first to last kernel {out['loop_us_per_iteration']:.2f} "
        f"us/iteration on the device clock, busy "
        f"{out['loop_busy_us_per_iteration']:.3f}, idle share "
        f"{out['loop_idle_share']:.4f}")
    return out


def phase_trace4(dev):
    """The abc_kde cell and the unfused Gaussian (200 iterations each,
    burn-in 100, so a run's trace stays a few MB) under
    ``torch.profiler``."""
    from demcmc_tpu_torch.models import gaussian
    model, de = _kde_case(100)
    out = {"kde_" + k: v for k, v in _trace_unfused(
        "trace-kde", model, de, 200, "trace_kde.json", True).items()}
    c = pc.GAUSS_UNFUSED_CELL
    model, de = gaussian.make(data=_gauss_data(), Np=c["Np"],
                              n_groups=c["n_groups"], burnin=100)
    out.update({"unfused_gauss_" + k: v for k, v in _trace_unfused(
        "trace-unfused-gauss", model, de, 200, "trace_unfused_gauss.json",
        False).items()})
    return out


def _k4_row(tag, name, x, sims, h, launches, err):
    """K4's row of the kernels line on its inputs ``x [E]``, ``sims [C,
    S]``, ``h [C]``: device ms per launch (spin-queued; plain, kernel,
    kernel, plain) beside its plain version's and its bound: bytes, the
    simulations, points and bandwidths read once and the output written
    once; operations, KDE_OPS_PER_TERM per (chain, point, simulation),
    every one of which this kernel evaluates."""
    from demcmc_tpu_torch.ops import kde
    (C_, S), E = sims.shape, x.shape[0]

    def k4():
        kde.kde_logpdf(x, sims, h, pc.KDE_FLOOR)

    def k4_plain():
        kde.kde_logpdf_plain(x, sims, h, pc.KDE_FLOOR)

    t = {}
    for which, fn, n in (("plain", k4_plain, 2), ("k4", k4, 20),
                         ("k4", k4, 20), ("plain", k4_plain, 2)):
        t.setdefault(which, []).append(device_ms(fn, n))
    ms = {k: float(np.mean([x_ for x_, _, _ in v])) for k, v in t.items()}
    for k, v in t.items():
        log(tag, f"{k}: {ms[k]:.6f} ms per call on the device ("
            + ", ".join(f"{x_:.6f}{'' if q else ' host-gapped'}"
                        for x_, q, _ in v)
            + "); host issues a call in "
            + ", ".join(f"{h_:.6f}" for _, _, h_ in v) + " ms")
    nbytes = 4 * (C_ * S + E + C_ + C_ * E)
    nops = KDE_OPS_PER_TERM * C_ * E * S
    tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_OPS * 1e3
    log(tag, f"kde_logpdf: {nbytes} bytes, {nops} operations, bound "
        f"{max(tb, to):.4g} ms ({'bytes' if tb >= to else 'operations'}); "
        f"K4 at {max(tb, to) / ms['k4']:.3f} of its bound")
    return {"name": name, "route": "cuda",
            "source": "demcmc_tpu_torch/csrc/kde.cu",
            "replaces": "demcmc_tpu/ops/pallas_kde.py:35",
            "launches": launches, "max_abs_err": err,
            "ms": ms["k4"], "plain_ms": ms["plain"],
            "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "library_ms": None}


def phase_timing4(dev, launches, err):
    """K4's row at the fixed-panel cell's shape and inputs
    (:func:`_k4_row`), with its launches in the cell."""
    C_ = pc.KDE_CELL["n_groups"] * pc.KDE_CELL["Np"]
    E, S = pc.KDE_N_OBS, pc.KDE_N_SIM
    x, sims, h = _kde_args(C_, E, S, dev, seed=S)
    return [_k4_row("timing4", f"kde_logpdf/abc_kde-{C_}", x, sims, h,
                    launches["kde_logpdf"], err)]


# ------------------------------------------- fifth slice: K-iteration
# windows (supersteps), device-side thinning, the post-burn-in variant

K_SWEEP = (4, 16, 64, 256)     # iterations per launch at most, swept
KSWEEP_MVN_ITER = 10_000       # the MVN flagship's run in the K sweep


def _rules(K):
    """The emission rules a window is checked with: every iteration, the
    last (``emit='last'``), every fourth (``('stride', 4)``) and a thin
    offset carried in from an earlier window."""
    return {"all": (0, 1), "last": (K - 1, 1), "stride4": (3, 4),
            "offset": (2, 5)}


def _window_check(tag, cfg, model, spec, state, it0, K, emit, phase,
                  bits=None, idx=None, seed=0):
    """One K1 (K3) window of ``K`` iterations from ``it0``, the same
    iterations as K one-iteration launches (phase 'all'), and the plain
    window version, each from a copy of ``state`` (θ, w, fire and for K3
    the history): the final θ, w, gate and history, and the stored rows'
    θ, w and accept flags equal bit for bit.  Returns the window's result
    state, its accepted count and the largest |window − singles| and
    |window − plain| of the float tensors measured (equal infinities
    count 0)."""
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import fused_step
    from demcmc_tpu_torch.ops import resample_step as tres
    dev = state[0].device
    C_, d, n = cfg.G * cfg.Np, cfg.d, cfg.rows.n_words
    m = tres.index_rows(cfg) if cfg.resample else 0
    first, stride = emit
    T = fused_step.n_emitted(K, emit)

    def window(st, out):
        if cfg.resample:
            tres.resample_step(cfg, model, spec, *st, it0, seed=seed,
                               out=out, bits=bits, idx=idx, K=K, emit=emit,
                               phase=phase)
        else:
            fused_step.de_step(cfg, model, spec, *st, it0, seed=seed,
                               out=out, bits=bits, K=K, emit=emit,
                               phase=phase)

    def singles(st, out):
        t = 0
        for k in range(K):
            keep = k >= first and (k - first) % stride == 0
            o = tuple(x[t] for x in out) if keep else None
            t += keep
            b = None if bits is None else bits[k * n:(k + 1) * n]
            if cfg.resample:
                ix = None if idx is None else idx[k * m:(k + 1) * m]
                tres.resample_step(cfg, model, spec, *st, it0 + k,
                                   seed=seed, out=o, bits=b, idx=ix)
            else:
                fused_step.de_step(cfg, model, spec, *st, it0 + k,
                                   seed=seed, out=o, bits=b)

    def plain(st, out):
        if cfg.resample:
            w_ = bits if bits is not None else rng.words_block(
                seed, it0, K, n, C_, device=dev).view(-1, C_)
            ix = idx if idx is not None else torch.cat(
                [tres.indices(cfg, seed, it0 + k, device=dev)
                 for k in range(K)])
            tres.resample_step_plain(cfg, model, spec, *st, it0, w_, ix, out,
                                     K, emit, phase)
        else:
            fused_step.de_step_plain(cfg, model, spec, *st, it0, bits, out,
                                     K, emit, phase, seed)

    res = {}
    for which, fn in (("window", window), ("singles", singles),
                      ("plain", plain)):
        st = [x.clone() for x in state]
        out = (torch.empty((T, C_, d), device=dev),
               torch.empty((T, C_), device=dev),
               torch.empty((T, C_), dtype=torch.bool, device=dev))
        fn(st, out)
        res[which] = st + list(out)
    torch.cuda.synchronize()
    names = ["theta", "w", "fire", "history"][:len(state)] + [
        "stored theta", "stored w", "stored accept flags"]
    err = 0.0
    for which in ("singles", "plain"):
        for a, b, what in zip(res["window"], res[which], names):
            if a.is_floating_point():
                diff = torch.where(a == b, 0.0, (a - b).abs())
                err = max(err, float(diff.max()) if diff.numel() else 0.0)
            a = a.view(torch.uint8) if a.dtype == torch.bool else ints(a)
            b = b.view(torch.uint8) if b.dtype == torch.bool else ints(b)
            if not torch.equal(a, b):
                raise AssertionError(f"{tag}: the window's {what} differ "
                                     f"from {which} (it0={it0}, K={K}, "
                                     f"emit={emit}, phase={phase})")
    return res["window"][:len(state)], int(res["window"][-1].sum()), err


def _closed_inner_gates(bits, cfg, K):
    """Random window words whose gates before the last iteration are
    closed (the windows the sampler launches): the fire row's word of
    chain 0 set to all ones (uniform 1 − 2⁻²³ > α)."""
    n = cfg.rows.n_words
    for k in range(K - 1):
        bits[k * n + cfg.rows.fire, 0] = 0xFFFFFFFF
    return bits


def _k1_super_cases():
    """(name, model, de, bits-in) of the K1 window checks: the main path's
    4,096-chain Gaussian (G = 256 × Np = 16), snooker at G = 4,096 × 16,
    the sequential sweep at 4,096 × 4, LBA, the ABC noise panel (Philox
    only: its words per chain are 10,000 per iteration) and the discrete
    binomial, each with burn-in 1,000."""
    from demcmc_tpu_torch.models import gaussian
    data = _gauss_data()
    yield ("sync-4096",) + gaussian.make(data=data, Np=NP, n_groups=G,
                                         burnin=1000) + (True,)
    yield ("snooker-65536",) + gaussian.make(
        data=data, Np=N65, n_groups=G65, burnin=1000,
        theta_snooker=0.5) + (True,)
    yield ("sequential-16384",) + gaussian.make(
        data=data, Np=NSEQ, n_groups=G65, burnin=1000,
        theta_snooker=0.5) + (True,)
    yield ("lba",) + _lba_case(1000) + (True,)
    yield ("abc",) + _abc_case(1000) + (False,)
    yield ("discrete",) + _disc_case(1000) + (True,)


def phase_k1_super(dev):
    """K1 windows against their one-iteration launches and the plain window
    version, bit for bit: bits-in windows of 16 across the burn-in
    boundary with every emission rule, then windows of K = super_k() on
    Philox words past burn-in with the post variant (every iteration
    stored, and every fourth), at a start whose inner gates are closed."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.ops import fused_step
    K = fused_step.super_k()
    Kb = min(K, 16)     # bits-in windows: K·n_words random words per chain
    rng_np = np.random.default_rng(14)
    worst = 0.0
    for name, model, de, bits_in in _k1_super_cases():
        tag = "k1-super-" + name
        spec = tdm.make_spec(model, de)
        cfg = fused_step.StepConfig.make(model, de, spec)
        s = tdm.init_state(model, de, spec, 13, device=dev)
        state = [s.theta, s.weight, s.fire]
        done = []
        if bits_in:
            bits = _closed_inner_gates(random_words(
                rng_np, Kb * cfg.rows.n_words, de.n_chains, dev), cfg, Kb)
            for rule, emit in _rules(Kb).items():
                _, acc, err = _window_check(tag, cfg, model, spec, state,
                                            de.burnin - 5, Kb, emit, "all",
                                            bits)
                worst = max(worst, err)
                done.append(f"bits-in K={Kb} {rule} across burn-in ({acc} "
                            f"stored accepts)")
        seed, it0 = quiet_start(21, cfg, de.burnin + 1, 1 << 16, K)
        for rule in ("all", "stride4"):
            _, acc, err = _window_check(tag, cfg, model, spec, state, it0, K,
                                        _rules(K)[rule], "post", seed=seed)
            worst = max(worst, err)
            done.append(f"Philox K={K} post {rule} from {it0}, key {seed} "
                        f"({acc} stored accepts)")
        log(tag, f"C={de.n_chains}: window = its single launches = plain "
            f"window, bit for bit: " + "; ".join(done))
    log("k1-super", f"max |window - singles|, |window - plain| of θ and w: "
        f"{worst:.3g}")
    return worst


def _k3_edge_cases(burnin):
    """(name, model, de) of K3's one-CTA rule at its edge: the Gaussian
    DE-MCz with snooker (θs = 0.5, synchronous, Np = 4) at 1,024 chains
    and the 30-dim MVN (sequential, Np = 4) at 512."""
    from demcmc_tpu_torch.models import gaussian, mvnormal
    yield ("gauss-snooker-1024",) + gaussian.make(
        data=_gauss_data(), n_groups=256, Np=4, alpha=0.0, sample="resample",
        n_initial=N_INITIAL["C512"], burnin=burnin, theta_snooker=0.5,
        sweep="sync")
    yield ("mvn30-512",) + mvnormal.make(d=30, n_obs=100, key=1, Np=4,
                                         n_groups=128, burnin=burnin,
                                         theta_snooker=0.5)


def phase_k3_super(dev):
    """K3 windows of K = resample_super_k() iterations (one CTA; on the
    Gaussian one cluster of CTAs) at the MVN flagship's shapes (C = 3, d =
    30, sequential), at the MVN's C = 64 and on the Gaussian at C = 512
    and at C = 2,048 (above one CTA's 1,024), θs = 0.5,
    against K one-iteration launches and the plain window version, bit for
    bit, history included: indices-in + bits-in across burn-in, then two
    windows on Philox words past burn-in through the post variant
    (every fourth iteration stored; then a window of 16, the last).  Then
    the window rule at its edge (:func:`_k3_edge_cases`): the chains a
    window of the configuration's kernel holds (``window_chains``), a window
    of 16 at the largest population of whole groups it holds against its
    single launches and plain window, and ``sample()`` at the full
    population (K = 1 where it is above the rule) against the loop, bit for
    bit, launches the plan's.  Returns the largest |window − singles| and
    |window − plain| measured."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.ops import fused_step
    from demcmc_tpu_torch.ops import resample_step as tres
    rng_np = np.random.default_rng(15)
    worst = 0.0
    for which in ("mvn", "mvn-l8", "C512", "C2048"):
        tag = "k3-super-" + which
        it0 = N_INITIAL[which] + 1
        model, spec, cfg, s = _resample_case(dev, which, burnin=it0 + 5,
                                             theta_sn=0.5, key=5,
                                             extra_rows=3 * 256)
        K = tres.resample_super_k(cfg, dev)
        C_ = cfg.G * cfg.Np
        if K != tres.RESAMPLE_SUPER_K:
            raise AssertionError(f"{tag}: K = {K} at C = {C_}")
        state = [s.theta, s.weight, s.fire, s.history]
        bits = random_words(rng_np, K * cfg.rows.n_words, C_, dev)
        idx = torch.cat([tres.indices_from_words(cfg, random_words(
            rng_np, tres.index_rows(cfg), C_, dev), it0 + k)
            for k in range(K)])
        state, a1, e1 = _window_check(tag, cfg, model, spec, state, it0, K,
                                      (0, 1), "all", bits, idx)
        state, a2, e2 = _window_check(tag, cfg, model, spec, state, it0 + K,
                                      K, _rules(K)["stride4"], "post",
                                      seed=22)
        a3, e3 = "not run", 0.0
        if which != "mvn-l8":   # its plain windows take seconds each
            state, a3, e3 = _window_check(tag, cfg, model, spec, state,
                                          it0 + 2 * K, 16, _rules(16)["last"],
                                          "post", seed=22)
        worst = max(worst, e1, e2, e3)
        log(tag, f"C={C_} d={cfg.d} K={K} (window_chains "
            f"{tres.window_chains(cfg, dev)}): window = its "
            f"single launches = plain window, bit for bit, history "
            f"included: indices-in + bits-in across burn-in ({a1} accepts),"
            f" Philox post stride 4 ({a2}), Philox post last of 16 ({a3})")
    for name, model, de in _k3_edge_cases(burnin=10):
        tag = "k3-edge-" + name
        cfg = fused_step.StepConfig.make(model, de, tdm.make_spec(model, de))
        most = tres.window_chains(cfg, dev)
        K = tres.resample_super_k(cfg, dev)
        if K != (tres.RESAMPLE_SUPER_K if de.n_chains <= most else 1):
            raise AssertionError(f"{tag}: K = {K} at {de.n_chains} chains, "
                                 f"one CTA holds {most}")
        # a window at the largest population of whole groups one CTA holds
        edge = de.replace(n_groups=most // de.Np)
        spec = tdm.make_spec(model, edge)
        cfg_e = fused_step.StepConfig.make(model, edge, spec)
        s = tdm.sampler._grow_history(
            tdm.init_state(model, edge, spec, 6, device=dev), 32)
        _, acc, err = _window_check(
            tag, cfg_e, model, spec, [s.theta, s.weight, s.fire, s.history],
            edge.n_initial + 1, 16, (0, 1), "post", seed=23)
        worst = max(worst, err)
        _windows_vs_loop(tag, model, de, 40, key=7)
        log(tag, f"d={cfg.d} sequential={de.sequential_sweep}: a window holds "
            f"{most} chains (one CTA, or on the Gaussian one cluster of CTAs:"
            f" the kernel's registers and shared memory); a "
            f"window of 16 at {edge.n_chains} chains = its single launches "
            f"= plain window ({acc} accepts); sample() at {de.n_chains} "
            f"chains with K = {K} = the loop, bit for bit")
    log("k3-super", f"max |window - singles|, |window - plain| of θ, w and "
        f"the history: {worst:.3g}")
    return worst


def phase_main_super(dev):
    """``sample()`` through planned windows against the
    one-launch-per-iteration loop on the 4,096-chain Gaussian (3,000
    iterations, thin 1) and the 65,536-chain snooker Gaussian (3,000,
    thin 10): equal bit for bit, the windows' launches the plan's; µs and
    launches per iteration of both in turns (windows, loop, loop,
    windows)."""
    from demcmc_tpu_torch.models import gaussian
    data = _gauss_data()
    out = {}
    for prefix, tag, kw, thin in (
            ("", "main-super-4096", dict(Np=NP, n_groups=G), 1),
            ("65k_", "main-super-65536", dict(Np=N65, n_groups=G65,
                                              theta_snooker=0.1), 10)):
        model, de = gaussian.make(data=data, burnin=BURNIN, **kw)
        m, _ = _windows_vs_loop(tag, model, de, N_ITER, key=1, thin=thin,
                               turns=("windows", "loop", "loop", "windows"))
        m.pop("launches")
        m["chain_steps_per_s"] = de.n_chains / m["windows_us_per_iteration"] \
            * 1e6
        out.update({prefix + k: v for k, v in m.items()})
    return out


def phase_k_sweep(dev):
    """``sample()`` with at most K ∈ K_SWEEP iterations per launch, on the
    4,096-chain Gaussian (α = 0.1, 3,000 iterations) and the MVN flagship
    (α = 0, 10,000 iterations): µs per iteration on the host clock, one
    synchronised call each, K rising then falling; the launches the plan's
    at that K.  The chosen K is the module constant it reads."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian, mvnormal
    from demcmc_tpu_torch.ops import fused_step, resample_step
    cells = {"gauss4096": (gaussian.make(data=_gauss_data(), Np=NP,
                                         n_groups=G, burnin=BURNIN),
                           N_ITER, fused_step, "SUPER_K"),
             "mvn": (mvnormal.make(d=30, n_obs=100, key=1,
                                   burnin=MVN_BURNIN),
                     KSWEEP_MVN_ITER, resample_step, "RESAMPLE_SUPER_K")}
    out = {}
    for name, ((model, de), n_iter, mod, attr) in cells.items():
        chosen = getattr(mod, attr)
        t = {}
        try:
            for K in K_SWEEP + K_SWEEP[::-1]:
                setattr(mod, attr, K)
                _reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tdm.sample(model, de, n_iter, key=1)
                torch.cuda.synchronize()
                t.setdefault(K, []).append(time.perf_counter() - t0)
                want = plan_counts(model, de, n_iter, 1)
                _counts(**want)
                t[K].append(sum(want.values()) / n_iter)
        finally:
            setattr(mod, attr, chosen)
        for K in K_SWEEP:
            us = [x / n_iter * 1e6 for x in (t[K][0], t[K][2])]
            out[f"ksweep_{name}_K{K}_us_per_iteration"] = float(np.mean(us))
            log("k-sweep", f"{name} K={K}: " + ", ".join(
                f"{u:.2f}" for u in us) + f" us/iteration, "
                f"{t[K][1]:.4f} launches/iteration"
                + (" (chosen)" if K == chosen else ""))
    return out


def phase_timing5(dev, paths, errs):
    """Device ms per window launch at the chosen K (spin-queued; plain,
    kernel, kernel, plain) beside the plain window version and the bound
    (_window_work: K iterations' operations for this window's words, the
    state moved once and the stored rows): K1 on the 4,096-chain Gaussian
    past burn-in (the post variant, all K rows stored) and in burn-in, K3
    at the MVN flagship and at C = 512 past burn-in (post)."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import fused_step
    from demcmc_tpu_torch.ops import resample_step as tres
    _, model, de, spec, cfg = _k1_setup(dev, burnin=BURNIN)
    K = fused_step.super_k()
    s = tdm.init_state(model, de, spec, 5, device=dev)
    cases = {}

    def k1_case(seed, it0, phase):
        st = (s.theta, s.weight, s.fire)
        out = (torch.empty((K, C, D), device=dev),
               torch.empty((K, C), device=dev),
               torch.empty((K, C), dtype=torch.bool, device=dev))

        def kern():
            fused_step.de_step(cfg, model, spec, *st, it0, seed=seed,
                               out=out, K=K, phase=phase)

        def plain():
            fused_step.de_step_plain(cfg, model, spec, *st, it0, None, out,
                                     K, (0, 1), phase, seed)
        return cfg, seed, it0, K, kern, plain, GAUSS_F32_OPS

    # windows the sampler launches: no gate open before the last iteration
    cases["k1post"] = k1_case(*quiet_start(0, cfg, 2000, 1 << 16, K),
                              "post")
    cases["k1burnin"] = k1_case(*quiet_start(0, cfg, 200, BURNIN - K, K),
                                "all")
    for which in ("mvn", "C512"):
        m3, spec3, cfg3, s3 = _resample_case(dev, which, burnin=(
            MVN_BURNIN if which == "mvn" else 1000), theta_sn=0.1, key=4,
            extra_rows=3000)
        K3 = tres.resample_super_k(cfg3, dev)
        it3 = 2500 if which == "mvn" else 1500
        C3 = cfg3.G * cfg3.Np
        st3 = (s3.theta, s3.weight, s3.fire, s3.history)
        o3 = (torch.empty((K3, C3, cfg3.d), device=dev),
              torch.empty((K3, C3), device=dev),
              torch.empty((K3, C3), dtype=torch.bool, device=dev))

        def k3(a=(cfg3, m3, spec3, st3, it3, o3, K3)):
            c3, mm, sp, st, i3, o, k3_ = a
            tres.resample_step(c3, mm, sp, *st, i3, out=o, K=k3_,
                               phase="post")

        def k3_plain(a=(cfg3, m3, spec3, st3, it3, o3, K3)):
            c3, mm, sp, st, i3, o, k3_ = a
            C3_ = c3.G * c3.Np
            words = rng.words_block(0, i3, k3_, c3.rows.n_words, C3_,
                                    device=dev).view(-1, C3_)
            idx = torch.cat([tres.indices(c3, 0, i3 + k, device=dev)
                             for k in range(k3_)])
            tres.resample_step_plain(c3, mm, sp, *st, i3, words, idx, o,
                                     k3_, (0, 1), "post")

        dens = (MVN_F32_OPS_PER_DIM * cfg3.d + MVN_F32_OPS
                if which == "mvn" else GAUSS_F32_OPS)
        cases["k3" + which] = (cfg3, 0, it3, K3, k3, k3_plain, dens)

    t = {}
    for key, (_, _, _, _, kern, plain, _) in cases.items():
        # the plain window reads the gate after each iteration (and copies
        # from the host): host-gapped, timed one call at a time
        for name, fn, n in ((key + "_plain", plain, 0), (key, kern, 50),
                            (key, kern, 50), (key + "_plain", plain, 0)):
            t.setdefault(name, []).append(device_ms(fn, n) if n
                                          else gapped_ms(fn))
    ms = {k: float(np.mean([x for x, _, _ in v])) for k, v in t.items()}
    for k, v in t.items():
        log("timing5", f"{k}: {ms[k]:.6f} ms per window launch on the "
            f"device (" + ", ".join(f"{x:.6f}{'' if q else ' host-gapped'}"
                                   for x, q, _ in v)
            + "); host enqueues a call in "
            + ", ".join(f"{h:.6f}" for _, _, h in v) + " ms")
    meta = {"k1post": ("de_step/window-K{K}-post-4096",
                       "demcmc_tpu_torch/csrc/de_step.cu",
                       "demcmc_tpu/ops/fused_step.py:2250",
                       paths["main"]["de_step"], errs["k1_super"]),
            "k1burnin": ("de_step/window-K{K}-burnin-4096",
                         "demcmc_tpu_torch/csrc/de_step.cu",
                         "demcmc_tpu/ops/fused_step.py:2560",
                         paths["main"]["de_step"], errs["k1_super"]),
            "k3mvn": ("resample_step/window-K{K}-post-mvn30-C3",
                      "demcmc_tpu_torch/csrc/de_step_resample.cu",
                      "demcmc_tpu/ops/fused_step.py:2560",
                      paths["mvn"]["resample_step"], errs["k3_super"]),
            "k3C512": ("resample_step/window-K{K}-post-gauss-C512",
                       "demcmc_tpu_torch/csrc/de_step_resample.cu",
                       "demcmc_tpu/ops/fused_step.py:2560",
                       paths["wide"]["resample_step"], errs["k3_super"])}
    rows = []
    for key, (c, seed, it0, Kc, _, _, dens) in cases.items():
        nbytes, nops = _window_work(c, seed, it0, Kc, Kc, dens, dev)
        tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_OPS * 1e3
        name, src, repl, n_launch, err = meta[key]
        rows.append({"name": name.format(K=Kc), "route": "cuda",
                     "source": src, "replaces": repl, "launches": n_launch,
                     "max_abs_err": err, "ms": ms[key],
                     "plain_ms": ms[key + "_plain"],
                     "bound_ms": max(tb, to),
                     "bound_by": "bytes" if tb >= to else "operations",
                     "library_ms": None})
        log("timing5", f"{name.format(K=Kc)}: {nbytes} bytes, {nops} "
            f"operations over {Kc} iterations ({Kc} rows stored), bound "
            f"{max(tb, to):.3g} ms ({'bytes' if tb >= to else 'operations'}); "
            f"{ms[key] / Kc * 1e3:.3f} us per iteration in the window")
    return rows


# ------------------------------------------ sixth slice: DE-MCz with
# migration (K3's gate, K2 between K3 windows) and constant blocks in K1 and
# K3; the hierarchical model through the unfused step

BLOCKS = ((True, False), (False, True))   # the Gaussian's blocks (μ), (σ)


def _mcz_mig_case(dev, which, burnin, theta_sn, key=3, extra_rows=10):
    """(model, spec, cfg, state) of a DE-MCz configuration with migration
    (α = 0.1): the C = 512 Gaussian of the mcz-mig cell (G = 128 × Np = 4,
    synchronous, n_initial = 50) or the 30-dim MVN at G = 4 × Np = 3
    (sequential, n_initial = 124)."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian, mvnormal
    from demcmc_tpu_torch.ops import fused_step
    if which == "C512":
        cell = pc.MCZ_MIG_CELL
        model, de = gaussian.make(
            data=_gauss_data(), n_groups=cell["n_groups"], Np=cell["Np"],
            alpha=cell["alpha"], sample="resample",
            n_initial=cell["n_initial"], burnin=burnin,
            theta_snooker=theta_sn, sweep="sync")
    else:
        model, de = mvnormal.make(d=30, n_obs=100, key=1, n_groups=4, Np=3,
                                  alpha=0.1, burnin=burnin,
                                  theta_snooker=theta_sn)
    spec = tdm.make_spec(model, de)
    cfg = fused_step.StepConfig.make(model, de, spec)
    s = tdm.sampler._grow_history(
        tdm.init_state(model, de, spec, key, device=dev), extra_rows)
    return model, de, spec, cfg, s


def phase_k3_mig(dev):
    """K3 with its migration gate and K2 between K3 iterations against the
    plain versions, bit for bit, at C = 512 (G = 128 × Np = 4, synchronous,
    θs = 0.5) and at G = 4 × Np = 3, d = 30 (sequential): 8 bits-in
    iterations crossing burn-in with the gate open at the start and forced
    open by the words at two more, then one on Philox words; θ, w, the
    trajectory row, the history row, the accept flags and the gate each
    iteration writes.  Then a window of 16 (its inner gates shut, its last
    open) against its single launches and the plain window."""
    from demcmc_tpu_torch.ops import resample_step as tres
    rng = np.random.default_rng(31)
    worst = 0.0
    for which, it0 in (("C512", pc.MCZ_MIG_CELL["n_initial"] + 1),
                       ("mvn-G4", 125)):
        tag = "k3-mig-" + which
        model, de, spec, cfg, s = _mcz_mig_case(dev, which, burnin=it0 + 3,
                                                theta_sn=0.5, extra_rows=40)
        C_ = de.n_chains
        assert cfg.rows.mig == 0 and cfg.alpha > 0.0
        state = [s.theta, s.weight, torch.ones(1, dtype=torch.int32,
                                               device=dev), s.history]
        opened = 0
        for k in range(9):
            it = it0 + k
            words = idx = None
            if k < 8:
                words = random_words(rng, cfg.rows.n_words, C_, dev)
                if k in (2, 5):            # open the next iteration's gate
                    words[cfg.rows.fire, 0] = 0
                idx = tres.indices_from_words(cfg, random_words(
                    rng, tres.index_rows(cfg), C_, dev), it)
            gate_in = int(state[2][0])
            opened += gate_in
            state, _, _, n_acc = _compare_resample(
                cfg, model, spec, state, it, words=words, idx=idx, seed=92,
                exact=True)
            log(tag, f"{'indices-in + bits-in' if k < 8 else 'Philox'} "
                f"it={it} ({'burn-in' if it <= it0 + 3 else 'sampling'}, "
                f"gate in {gate_in}): {n_acc} accepted; gate written "
                f"{int(state[2][0])}")
        if opened < 3:
            raise AssertionError(f"{tag}: only {opened} gates opened")
        K = 16
        bits = _closed_inner_gates(random_words(
            rng, K * cfg.rows.n_words, C_, dev), cfg, K)
        bits[(K - 1) * cfg.rows.n_words + cfg.rows.fire, 0] = 0
        idx = torch.cat([tres.indices_from_words(cfg, random_words(
            rng, tres.index_rows(cfg), C_, dev), it0 + 9 + k)
            for k in range(K)])
        state, acc, err = _window_check(tag, cfg, model, spec, state,
                                        it0 + 9, K, (0, 1), "all", bits,
                                        idx)
        if int(state[2][0]) != 1:
            raise AssertionError(f"{tag}: the window's last gate is shut")
        worst = max(worst, err)
        log(tag, f"C={C_} d={cfg.d} G={de.n_groups} n_members="
            f"{cfg.rows.n_members}: K2 + K3 = plain, bit for bit, over 9 "
            f"iterations ({opened} exchanges); a window of {K} = its single "
            f"launches = plain window ({acc} stored accepts), gate written "
            f"1")
    return worst


def _blocked_cases(burnin):
    """(name, model, de) of the blocked checks: the 4,096-chain Gaussian
    (synchronous), its sequential twin at 4,096 × 4 and the C = 512 DE-MCz
    Gaussian (α = 0), each with the blocks (μ), (σ) swept every
    iteration."""
    from demcmc_tpu_torch.models import gaussian
    data = _gauss_data()
    kw = dict(blocks=BLOCKS, blocking_on=True, burnin=burnin)
    yield ("sync-4096",) + gaussian.make(data=data, Np=NP, n_groups=G, **kw)
    yield ("sequential-16384",) + gaussian.make(
        data=data, Np=NSEQ, n_groups=G65, theta_snooker=0.5, **kw)
    cell = pc.MCZ_MIG_CELL
    yield ("mcz-C512",) + gaussian.make(
        data=data, n_groups=cell["n_groups"], Np=cell["Np"], alpha=0.0,
        sample="resample", n_initial=cell["n_initial"], theta_snooker=0.5,
        sweep="sync", **kw)


def phase_k_blocks(dev):
    """K1 and K3 with two blocks against their plain versions, bit for bit
    (:func:`_blocked_cases`): 8 bits-in iterations crossing burn-in with
    the gate set at the start, then one on Philox words; then windows of
    16 (bits-in, across burn-in) and of the configuration's K (Philox,
    post) against their single launches and the plain window; then
    ``sample()`` of the DE-MCz case (300 iterations) against its loop.
    Returns the largest |window − singles|, |window − plain| and the
    launches of that ``sample()``."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.ops import fused_step
    from demcmc_tpu_torch.ops import resample_step as tres
    rng = np.random.default_rng(33)
    worst, launches = 0.0, {}
    for name, model, de in _blocked_cases(burnin=0):
        tag = "k-blocks-" + name
        it0 = de.n_initial + 1
        de = de.replace(burnin=it0 + 3)
        spec = tdm.make_spec(model, de)
        cfg = fused_step.StepConfig.make(model, de, spec)
        if cfg.rows.n_blocks != 2 or cfg.blocks != BLOCKS:
            raise AssertionError(f"{tag}: not a two-block configuration")
        s = tdm.sampler._grow_history(
            tdm.init_state(model, de, spec, 5, device=dev), 200)
        C_ = de.n_chains
        state = [s.theta, s.weight, torch.ones(1, dtype=torch.int32,
                                               device=dev)]
        if cfg.resample:
            state.append(s.history)
        for k in range(9):
            it = it0 + k
            words = idx = None
            if k < 8:
                words = random_words(rng, cfg.rows.n_words, C_, dev)
                if cfg.resample:
                    idx = tres.indices_from_words(cfg, random_words(
                        rng, tres.index_rows(cfg), C_, dev), it)
            if cfg.resample:
                state, _, _, n_acc = _compare_resample(
                    cfg, model, spec, state, it, words=words, idx=idx,
                    seed=93, exact=True)
            else:
                state, _, _, n_acc = _compare_iteration(
                    cfg, model, spec, state, it, words=words, seed=93,
                    exact=True)
            log(tag, f"{'bits-in' if k < 8 else 'Philox'} it={it} "
                f"({'burn-in' if it <= it0 + 3 else 'sampling'}): {n_acc} "
                f"accepted (last block), bit for bit")
        Kb = 16
        bits = _closed_inner_gates(random_words(
            rng, Kb * cfg.rows.n_words, C_, dev), cfg, Kb)
        idx = None
        if cfg.resample:
            idx = torch.cat([tres.indices_from_words(cfg, random_words(
                rng, tres.index_rows(cfg), C_, dev), it0 + 9 + k)
                for k in range(Kb)])
        state, a1, e1 = _window_check(tag, cfg, model, spec, state, it0 + 9,
                                      Kb, _rules(Kb)["offset"], "all", bits,
                                      idx)
        K = (tres.resample_super_k(cfg, dev) if cfg.resample
             else fused_step.super_k())
        if cfg.resample:
            it1, seed = it0 + 9 + Kb, 24
        else:
            seed, it1 = quiet_start(24, cfg, de.burnin + 1, 1 << 16, K)
        state, a2, e2 = _window_check(tag, cfg, model, spec, state, it1, K,
                                      _rules(K)["stride4"], "post",
                                      seed=seed)
        worst = max(worst, e1, e2)
        log(tag, f"C={C_}: windows = their single launches = plain "
            f"windows, bit for bit: bits-in K={Kb} across burn-in ({a1} "
            f"stored accepts), Philox K={K} post ({a2})")
        if cfg.resample:
            m, _ = _windows_vs_loop(tag, model, de.replace(burnin=100), 300,
                                    key=8)
            launches = m["launches"]
    return worst, launches


def phase_main_mcz_mig(dev):
    """The mcz-mig cell (port_cells.MCZ_MIG_CELL: the C = 512 DE-MCz
    Gaussian with α = 0.1) through ``sample()`` and its loop twin: one K3
    per window and one K2 per open gate as the gates' plan says, bit for
    bit equal, posterior within 0.01 of the oracle, max R̂ < 1.01."""
    from demcmc_tpu_torch.models import gaussian
    cell = pc.MCZ_MIG_CELL
    data = _gauss_data()
    model, de = gaussian.make(
        data=data, n_groups=cell["n_groups"], Np=cell["Np"],
        alpha=cell["alpha"], sample="resample", n_initial=cell["n_initial"],
        burnin=cell["burnin"], theta_snooker=cell["theta_snooker"],
        sweep="sync")
    n_iter = cell["n_iter"]
    m, chains = _windows_vs_loop("main-mcz-mig", model, de, n_iter, key=0)
    launches = m.pop("launches")
    if not launches["migrate"]:
        raise AssertionError("main-mcz-mig: no migration")
    rhat, acc = _posterior_gate("main-mcz-mig", chains, data,
                                n_iter - cell["burnin"], de.n_chains)
    m = {"mcz_mig_" + k: v for k, v in m.items()}
    m.update({"mcz_mig_rhat_max": rhat, "mcz_mig_acceptance": acc})
    return launches, m


def phase_main_blocked(dev):
    """The blocked cell (port_cells.BLOCKED_CELL: the 4,096-chain Gaussian
    with the blocks (μ), (σ) every iteration, blocking_on=True) through
    ``sample()`` and its loop twin: launches as planned, bit for bit
    equal, posterior within 0.01 of the oracle, max R̂ < 1.01."""
    from demcmc_tpu_torch.models import gaussian
    cell = pc.BLOCKED_CELL
    data = _gauss_data()
    model, de = gaussian.make(data=data, Np=cell["Np"],
                              n_groups=cell["n_groups"],
                              burnin=cell["burnin"], blocks=cell["blocks"],
                              blocking_on=True)
    n_iter = cell["n_iter"]
    m, chains = _windows_vs_loop("main-blocked", model, de, n_iter, key=0)
    launches = m.pop("launches")
    rhat, acc = _posterior_gate("main-blocked", chains, data,
                                n_iter - cell["burnin"], de.n_chains)
    m = {"blocked_" + k: v for k, v in m.items()}
    m.update({"blocked_rhat_max": rhat, "blocked_acceptance": acc})
    return launches, m


def phase_main_hier(dev):
    """The hierarchical cell (port_cells.HIER_CELL: 20 subjects × 50
    observations, d = 23, 6 chains, DE-MCz with snooker, α = 0.1, two
    blocks) through ``sample()`` on the card: the unfused step (the model
    names no CUDA density), its sweeps as CUDA graphs, no kernel of the
    port launched; the posterior means of μβ0, σβ0 and σ and of every β0ᵢ
    against the float64 quadrature (port_cells.hier_oracle); max R̂
    written down; then 400 iterations across a burn-in of 200 graphed
    against eager, bit for bit (:func:`_graph_vs_eager`)."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import hierarchical
    cell = pc.HIER_CELL
    model, de = hierarchical.make(n_subj=cell["n_subj"],
                                  n_data=cell["n_data"], key=cell["key"],
                                  burnin=cell["burnin"])
    spec = tdm.make_spec(model, de)
    if not isinstance(tdm.build_step(model, de, spec, dev), tdm.UnfusedStep):
        raise AssertionError("main-hier: not the unfused step")
    oracle = pc.hier_oracle(model.data)
    if oracle["mass_at_edge"]:
        raise AssertionError("main-hier: the quadrature box cuts mass")
    n_iter = cell["n_iter"]
    chains, launches, dt = _unfused_sample("main-hier", model, de, n_iter,
                                           {})
    x = chains.data
    means = {"mu_b0": float(x[:, 0].mean()),
             "sigma_b0": float(x[:, 1].mean()),
             "sigma": float(x[:, -1].mean())}
    ok, rows = pc.hier_gate(means, x[:, 2:-1].mean(axis=(0, 2)), oracle)
    rhat = float(np.max(chains.rhat()))
    log("main-hier", "posterior means against the quadrature: " + "; ".join(
        f"{k} {v[0]:.5f} (oracle {v[1]:.5f}, |diff| {v[2]:.5f} <= "
        f"{v[3]:.5f})" for k, v in rows.items() if k != "b0")
        + f"; max |b0 - oracle| {rows['b0'][0]:.5f} <= {rows['b0'][1]}; "
        f"max R-hat {rhat:.5f}; acceptance "
        f"{float(chains.acceptance.mean()):.4f}")
    if not ok:
        raise AssertionError("main-hier: posterior off the oracle")
    model, de = hierarchical.make(n_subj=cell["n_subj"],
                                  n_data=cell["n_data"], key=cell["key"],
                                  burnin=200)
    us_g, us_e = _graph_vs_eager("main-hier", model, de, 400)
    return launches, {"hier_us_per_iteration": dt / n_iter * 1e6,
                      "hier_graph_us_per_iteration": us_g,
                      "hier_eager_us_per_iteration": us_e,
                      "hier_rhat_max": rhat}


def phase_trace5(dev):
    """The mcz-mig cell (2,000 iterations, burn-in 1,000) and the blocked
    cell under ``torch.profiler``: every planned launch of K3, K1 and K2
    in the device trace, the device's idle share."""
    from demcmc_tpu_torch.models import gaussian
    cell = pc.MCZ_MIG_CELL
    model, de = gaussian.make(
        data=_gauss_data(), n_groups=cell["n_groups"], Np=cell["Np"],
        alpha=cell["alpha"], sample="resample", n_initial=cell["n_initial"],
        burnin=cell["burnin"], theta_snooker=cell["theta_snooker"],
        sweep="sync")
    out = {"trace_mcz_mig_" + k: v for k, v in _trace_sample(
        "trace-mcz-mig", model, de, 2000, {"resample_step": K3_NAME,
                                           "migrate": k2_kernels(de)},
        "trace_mcz_mig.json").items()}
    cell = pc.BLOCKED_CELL
    model, de = gaussian.make(data=_gauss_data(), Np=cell["Np"],
                              n_groups=cell["n_groups"],
                              burnin=cell["burnin"], blocks=cell["blocks"],
                              blocking_on=True)
    out.update({"trace_blocked_" + k: v for k, v in _trace_sample(
        "trace-blocked", model, de, cell["n_iter"],
        {"de_step": K1_NAME, "migrate": k2_kernels(de)},
        "trace_blocked.json").items()})
    return out


def phase_timing6(dev, paths, errs):
    """Device ms per launch (spin-queued; plain, kernel, kernel, plain) of
    K1 with two blocks on the 4,096-chain Gaussian, K3 with two blocks and
    K3 with the migration gate at C = 512, one iteration past burn-in each
    and a window of the configuration's K (post), and K2 fired at G = 128,
    beside the plain versions and the bounds (_step_work / _window_work:
    n_blk sweeps)."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import fused_step, migration as mig
    from demcmc_tpu_torch.ops import resample_step as tres
    cases = {}
    for name, model, de in _blocked_cases(burnin=1000):
        if name == "sequential-16384":
            continue
        cases["blocks-" + name] = (model, de)
    m, de, _, _, _ = _mcz_mig_case(dev, "C512", burnin=1000, theta_sn=0.1)
    cases["gate-C512"] = (m, de)
    calls, meta = {}, {}
    for key, (model, de) in cases.items():
        spec = tdm.make_spec(model, de)
        cfg = fused_step.StepConfig.make(model, de, spec)
        s = tdm.sampler._grow_history(
            tdm.init_state(model, de, spec, 5, device=dev), 3000)
        C_ = de.n_chains
        st = [s.theta, s.weight, s.fire] + ([s.history] if cfg.resample
                                            else [])
        it = 2000
        K = (tres.resample_super_k(cfg, dev) if cfg.resample
             else fused_step.super_k())
        # a window the sampler launches (no gate open before its last
        # iteration) inside the history
        seed, itw = quiet_start(0, cfg, 1500, 2900 - K, K)
        o1 = (torch.empty((C_, cfg.d), device=dev),
              torch.empty(C_, device=dev),
              torch.empty(C_, dtype=torch.bool, device=dev))
        oK = tuple(torch.empty((K,) + tuple(x.shape), dtype=x.dtype,
                               device=dev) for x in o1)

        def kern(a=(cfg, model, spec, st, o1, oK, it, itw, seed, K),
                 window=False):
            c, mm, sp, st_, o1_, oK_, i1, iw, sd, k_ = a
            f = tres.resample_step if c.resample else fused_step.de_step
            if window:
                f(c, mm, sp, *st_, iw, seed=sd, out=oK_, K=k_,
                  phase="post")
            else:
                f(c, mm, sp, *st_, i1, out=o1_)

        def plain(a=(cfg, model, spec, st, o1, oK, it, itw, seed, K),
                  window=False):
            c, mm, sp, st_, o1_, oK_, i1, iw, sd, k_ = a
            C__ = c.G * c.Np
            i0, n, o = (iw, k_, oK_) if window else (i1, 1, o1_)
            sd = sd if window else 0
            words = rng.words_block(sd, i0, n, c.rows.n_words, C__,
                                    device=dev).view(-1, C__)
            if c.resample:
                idx = torch.cat([tres.indices(c, sd, i0 + k, device=dev)
                                 for k in range(n)])
                tres.resample_step_plain(c, mm, sp, *st_, i0, words, idx,
                                         o, n, (0, 1),
                                         "post" if window else "all")
            else:
                fused_step.de_step_plain(c, mm, sp, *st_, i0, words, o, n,
                                         (0, 1), "post" if window
                                         else "all")

        calls[key] = (kern, plain)
        calls[key + "-window"] = (functools.partial(kern, window=True),
                                  functools.partial(plain, window=True))
        dens = GAUSS_F32_OPS
        nb1, no1 = _step_work(cfg, rng.words(0, it, cfg.rows.n_words, C_,
                                             device=dev), dens)
        meta[key] = (cfg, nb1, no1, 1)
        nbK, noK = _window_work(cfg, seed, itw, K, K, dens, dev)
        meta[key + "-window"] = (cfg, nbK, noK, K)
    Gm = pc.MCZ_MIG_CELL["n_groups"]
    s = _mcz_mig_case(dev, "C512", burnin=1000, theta_sn=0.1)[4]
    fired = torch.ones(1, dtype=torch.int32, device=dev)
    C_ = s.theta.shape[0]
    Npm = C_ // Gm
    calls["k2-G128"] = (
        lambda: mig.migrate(s.theta, s.weight, fired, Gm, Npm, it=2000),
        lambda: mig.migrate_plain(s.theta, s.weight, fired, rng.words(
            0, 2000, mig.N_ROWS, C_, device=dev), Gm, Npm))
    k2_bytes, k2_ops = _exchange_work(Gm, Npm, D)
    meta["k2-G128"] = (None, k2_bytes, k2_ops, 1)
    t = {}
    for key, (kern, plain) in calls.items():
        for name, fn, n in ((key + "_plain", plain, 0), (key, kern, 100),
                            (key, kern, 100), (key + "_plain", plain, 0)):
            t.setdefault(name, []).append(device_ms(fn, n) if n
                                          else gapped_ms(fn))
    ms = {k: float(np.mean([x for x, _, _ in v])) for k, v in t.items()}
    for k, v in t.items():
        log("timing6", f"{k}: {ms[k]:.6f} ms per launch on the device ("
            + ", ".join(f"{x:.6f}{'' if q else ' host-gapped'}"
                        for x, q, _ in v)
            + "); host issues a call in "
            + ", ".join(f"{h:.6f}" for _, _, h in v) + " ms")
    src = {"de_step": "demcmc_tpu_torch/csrc/de_step.cu",
           "resample_step": "demcmc_tpu_torch/csrc/de_step_resample.cu",
           "migrate": "demcmc_tpu_torch/csrc/migration.cu"}
    info = {"blocks-sync-4096": ("de_step", "demcmc_tpu/ops/fused_step.py:"
                                 "2479", paths["blocked"], errs["k_blocks"]),
            "blocks-mcz-C512": ("resample_step", "demcmc_tpu/ops/"
                                   "fused_step.py:2479",
                                   paths["k_blocks"], errs["k_blocks"]),
            "gate-C512": ("resample_step", "demcmc_tpu/ops/fused_step.py:"
                          "2061", paths["mcz_mig"], errs["k3_mig"]),
            "k2-G128": ("migrate", "demcmc_tpu/ops/fused_step.py:946",
                        paths["mcz_mig"], errs["k3_mig"])}
    rows = []
    for key, (cfg, nbytes, nops, Kc) in meta.items():
        kern_name, repl, launched, err = info[key.replace("-window", "")]
        tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_OPS * 1e3
        name = f"{kern_name}/{key}" + (f"-K{Kc}-post" if Kc > 1 else "")
        rows.append({"name": name, "route": "cuda",
                     "source": src[kern_name], "replaces": repl,
                     "launches": launched[kern_name],
                     "max_abs_err": err, "ms": ms[key],
                     "plain_ms": ms[key + "_plain"],
                     "bound_ms": max(tb, to),
                     "bound_by": "bytes" if tb >= to else "operations",
                     "library_ms": None})
        log("timing6", f"{name}: {nbytes} bytes, {nops} operations over "
            f"{Kc} iteration(s), bound {max(tb, to):.3g} ms "
            f"({'bytes' if tb >= to else 'operations'}); "
            f"{ms[key] / Kc * 1e3:.3f} us per iteration")
    return rows


# ------------------------------------------- seventh slice: optimization
# (K1 with the greedy max/min accept; the unfused step in float64)

RASTRIGIN_F32_OPS = 2 * (4 + 1) + 2     # per chain: x², 2πx, A·cos, −, +
                                        # per dimension (cos counted as
                                        # one), + A·n
GAUSS_LIKE_F32_OPS = 11                 # the Gaussian's loglike alone
OPT_PEAK_BYTES = 16 << 20               # device memory an optimize() may
                                        # hold at its peak: no trajectory


def _greedy_cases(burnin):
    """(name, model, de) of K1's greedy checks: max mode on the bench
    Gaussian's objective and min mode on the 2-d Rastrigin, each at 4,096
    × 16 (synchronous, θs = 0.5), 4,096 × 4 (sequential, θs = 0.5) and
    4,096 × 16 with the two constant blocks."""
    from demcmc_tpu_torch.models import gaussian, rastrigin
    data = _gauss_data()
    for mode in ("max", "min"):
        for sweep, Np_, kw in (("sync", NP, dict(theta_snooker=0.5)),
                               ("sequential", NSEQ,
                                dict(theta_snooker=0.5)),
                               ("blocks", NP, dict(blocking_on=True))):
            G_ = C // Np_
            if mode == "max":
                if sweep == "blocks":
                    kw = dict(kw, blocks=BLOCKS)
                model, de = gaussian.make(
                    data=data, Np=Np_, n_groups=G_, burnin=burnin,
                    update_particle="maximize", evaluate_fitness="fun",
                    **kw)
            else:
                if sweep == "blocks":
                    kw = dict(kw, blocks=(([True, False],),
                                          ([False, True],)))
                model, de = rastrigin.make(n_dim=2, Np=Np_, n_groups=G_,
                                           dtype=np.float32, burnin=burnin,
                                           **kw)
            yield f"{mode}-{sweep}-{C}", model, de


def _greedy_start(model, de, spec, dev, key):
    """An initial state with ∓inf weights: the first four chains of group
    3 out of bounds (the Rastrigin's x₀ at 5.5, the Gaussian's σ at −1),
    so in min mode a group holds +inf weights in burn-in."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.ops import accept
    s = tdm.init_state(model, de, spec, key, device=dev)
    lo = 3 * de.Np
    if de.is_minimize:
        s.theta[lo:lo + 4, 0] = 5.5
    else:
        s.theta[lo:lo + 4, 1] = -1.0
    s.weight.copy_(accept.evaluate_fun(model, spec, de, s.theta))
    return s


def phase_k1_greedy(dev):
    """K1 with the greedy accept (max: the Gaussian's objective, min: the
    Rastrigin) against its plain version, bit for bit (_greedy_cases): 8
    bits-in iterations crossing burn-in 4 with the gate set at the start,
    then one on Philox words, from a state with ∓inf weights (min mode: a
    group holding +inf weights in burn-in, which the kernel clamps);
    out-of-bounds proposals scoring ∓inf must occur; then windows of 16
    (bits-in, across burn-in, every iteration stored and none, as
    optimize() runs them) and of K (Philox, post) against their single
    launches and the plain window.  Returns the largest difference
    measured (0 where bit for bit)."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.ops import fused_step, migration as mig
    rng_np = np.random.default_rng(41)
    worst = 0.0
    for name, model, de in _greedy_cases(burnin=0):
        tag = "k1-greedy-" + name
        de = de.replace(burnin=4)
        spec = tdm.make_spec(model, de)
        cfg = fused_step.StepConfig.make(model, de, spec)
        if cfg.mode != name[:3]:
            raise AssertionError(f"{tag}: accept mode {cfg.mode}")
        s = _greedy_start(model, de, spec, dev, key=6)
        state = [s.theta, s.weight, torch.ones(1, dtype=torch.int32,
                                               device=dev)]
        n_inf = 0
        for k in range(9):
            it = 1 + k
            words = (random_words(rng_np, cfg.rows.n_words, C, dev) if k < 8
                     else None)
            if words is not None:     # the plain margins: ∓inf proposals
                probe = [x.clone() for x in state]
                if cfg.rows.mig >= 0:
                    mig.migrate_plain(*probe, words, cfg.G, cfg.Np)
                margin = fused_step.de_step_plain(cfg, model, spec, *probe,
                                                  it, words)
                n_inf += int(torch.isinf(margin).sum())
            state, err, _, n_acc = _compare_iteration(
                cfg, model, spec, state, it, words=words, seed=94,
                exact=True)
            worst = max(worst, err)
            log(tag, f"{'bits-in' if k < 8 else 'Philox'} it={it} "
                f"({'burn-in' if it <= 4 else 'past burn-in'}): {n_acc} "
                f"accepted, bit for bit")
        if n_inf == 0:
            raise AssertionError(f"{tag}: no out-of-bounds proposal scored "
                                 f"inf")
        Kb = 16
        bits = _closed_inner_gates(random_words(
            rng_np, Kb * cfg.rows.n_words, C, dev), cfg, Kb)
        done = []
        for rule, emit in (("all", (0, 1)), ("none", (Kb, 1))):
            _, acc, err = _window_check(tag, cfg, model, spec, state, 3, Kb,
                                        emit, "all", bits)
            worst = max(worst, err)
            done.append(f"bits-in K={Kb} {rule} across burn-in ({acc} "
                        f"stored accepts)")
        K = fused_step.super_k()
        seed, it0 = quiet_start(25, cfg, 5, 1 << 16, K)
        _, acc, err = _window_check(tag, cfg, model, spec, state, it0, K,
                                    _rules(K)["stride4"], "post", seed=seed)
        worst = max(worst, err)
        done.append(f"Philox K={K} post from {it0} ({acc} stored accepts)")
        log(tag, f"{n_inf} proposals scored {'+' if cfg.mode == 'min' else '-'}"
            f"inf over the bits-in iterations; windows = single launches = "
            f"plain windows, bit for bit: " + "; ".join(done))
    return worst


def _opt_model(which):
    """(model, de, cell) of a float32 optimization cell on the card."""
    from demcmc_tpu_torch.models import gaussian, rastrigin
    if which == "rastrigin":
        cell = pc.OPT_RASTRIGIN_CELL
        model, de = rastrigin.make(n_dim=cell["n_dim"], Np=cell["Np"],
                                   n_groups=cell["n_groups"],
                                   burnin=cell["burnin"], dtype=np.float32)
    else:
        cell = pc.OPT_MLE_CELL
        model, de = gaussian.make_mle(data=pc.opt_mle_data(cell),
                                      Np=cell["Np"],
                                      n_groups=cell["n_groups"],
                                      burnin=cell["burnin"])
    return model, de, cell


def _main_opt(dev, which):
    """``optimize()`` on a float32 optimization cell (port_cells.OPT_*)
    through K1's greedy accept, in turns with its one-launch-per-iteration
    twin (``run_loop(..., collect=False)``; windows, loop, loop,
    windows): one K1 per planned window and one K2 per open gate
    (plan_counts), no trajectory (device memory at its peak under
    OPT_PEAK_BYTES); every run's final population equal bit for bit; the
    optimum against the cell's gate, fixed on the CPU beforehand."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import sampler
    tag = "main-opt-" + which
    model, de, cell = _opt_model(which)
    n_iter, key = cell["n_iter"], cell["key"]
    spec = tdm.make_spec(model, de)
    step = tdm.build_step(model, de, spec, dev)
    if type(step) is not sampler.Step or step.cfg.mode == "mh":
        raise AssertionError(f"{tag}: not K1's greedy accept")
    want = {"windows": plan_counts(model, de, n_iter, key),
            "loop": {"de_step": n_iter,
                     "migrate": n_iter if de.alpha > 0 else 0}}
    secs, results, peaks = {}, [], []
    for turn in ("windows", "loop", "loop", "windows"):
        _reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        if turn == "windows":
            pop = tdm.optimize(model, de, n_iter, key=key)
            res = (pop.theta, pop.weight)
        else:
            state = sampler._grow_history(tdm.init_state(
                model, de, spec, key, start_iteration=1), n_iter)
            end, _ = sampler.run_loop(step, state, n_iter, collect=False)
            res = (end.theta.cpu().numpy(), end.weight.cpu().numpy())
        torch.cuda.synchronize()
        secs.setdefault(turn, []).append(time.perf_counter() - t0)
        got = _counts()
        if got != {k: want[turn].get(k, 0) for k in got}:
            raise AssertionError(f"{tag} {turn}: launches {got}, expected "
                                 f"{want[turn]}")
        if turn == "windows":
            peaks.append(torch.cuda.max_memory_allocated(dev) - base)
            if peaks[-1] > OPT_PEAK_BYTES:
                raise AssertionError(f"{tag}: {peaks[-1]} bytes at the "
                                     f"peak: a trajectory was stored")
        results.append(res)
    for res in results[1:]:
        for a, b, what in zip(res, results[0], ("theta", "weight")):
            if a.tobytes() != b.tobytes():
                raise AssertionError(f"{tag}: final {what} differs between "
                                     f"the windows and the loop")
    theta, best = tdm.get_optimal(de, model, pop)
    if which == "rastrigin":
        ok, rows = pc.rastrigin_gate(best, theta["x"], pc.OPT_BEST_F32,
                                     pc.OPT_ARGMIN_F32)
    else:
        ok, rows = pc.mle_gate(theta["mu"], theta["sigma"],
                               pc.opt_mle_data(cell), pc.OPT_MLE_F32)
    m = {"launches": want["windows"]}
    for turn in ("windows", "loop"):
        us = float(np.mean(secs[turn])) / n_iter * 1e6
        per = sum(want[turn].values()) / n_iter
        m[f"opt_{which}_{turn}_us_per_iteration"] = us
        m[f"opt_{which}_{turn}_launches_per_iteration"] = per
        log(tag, f"{turn}: {n_iter} iterations in "
            + ", ".join(f"{x:.4f}" for x in secs[turn])
            + f" s = {us:.2f} us/iteration, {de.n_chains / us * 1e6:.4g} "
            f"chain-steps/s; {per:.4f} launches/iteration")
    log(tag, f"launches {want['windows']} as planned, peak device memory "
        f"{max(peaks)} bytes (no trajectory); every run's final population "
        f"bit for bit the same; optimum {rows}: "
        f"{'passes' if ok else 'FAILS'} the gate")
    if not ok:
        raise AssertionError(f"{tag}: the optimum misses its gate")
    return m


def phase_main_opt_rastrigin(dev):
    """The opt-rastrigin cell (:func:`_main_opt`)."""
    return _main_opt(dev, "rastrigin")


def phase_main_opt_mle(dev):
    """The opt-mle cell (:func:`_main_opt`)."""
    return _main_opt(dev, "mle")


def _mle64_model(data):
    """The reference test's Gaussian MLE model
    (``tests/test_optimization.py::test_gaussian_mle``) in the port: a
    per-cell float64 loglike in ``jax.scipy.stats.norm.logpdf``'s order,
    U(−5, 5) × U(0.1, 5) initial draws, bounds σ ≥ 1e-6."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.model import DeviceArrays
    arrays = DeviceArrays(np.asarray(data, np.float64))

    def loglike(data, mu, sigma):
        x = arrays.on(mu.device)[0]
        s2 = sigma * sigma
        return torch.sum((torch.log(2.0 * np.pi * s2)
                          + (x - mu) * (x - mu) / s2) / -2.0)

    def sample_prior(uniform, n):
        u = uniform(2)
        return [-5.0 + 10.0 * u[0], 0.1 + 4.9 * u[1]]

    model = tdm.DEModel(loglike=loglike, sample_prior=sample_prior,
                        names=("mu", "sigma"), data=data)
    return model


def phase_main_opt_f64(dev):
    """The reference's two float64 optimizations through the unfused step
    on the card, no port kernel launched: ``examples/optimize.py`` (the
    2-d Rastrigin, Np = 10 × 4, 10,000 iterations, key 0: best within
    1e-8 of 0, argmin within 1e-5) and ``tests/test_optimization.py::
    test_gaussian_mle`` (100 draws of N(2, 1.5) from numpy seed 3, Np =
    12 × 4, 8,000 iterations, key 1: μ̂, σ̂ within 1e-4); µs per
    iteration."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import rastrigin
    out = {}
    for which in ("rastrigin", "mle"):
        tag = "main-opt-f64-" + which
        if which == "rastrigin":
            cell = pc.OPT_F64_RASTRIGIN_CELL
            model, de = rastrigin.make(n_dim=cell["n_dim"], Np=cell["Np"],
                                       n_groups=cell["n_groups"])
        else:
            cell = pc.OPT_F64_MLE_CELL
            model = _mle64_model(pc.opt_mle_data(cell))
            de = tdm.DE(bounds=((-np.inf, np.inf), (1e-6, np.inf)),
                        Np=cell["Np"], n_groups=cell["n_groups"],
                        update_particle="maximize", evaluate_fitness="fun",
                        dtype=np.float64)
        spec = tdm.make_spec(model, de)
        if not isinstance(tdm.build_step(model, de, spec, dev),
                          tdm.UnfusedStep):
            raise AssertionError(f"{tag}: not the unfused step")
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pop = tdm.optimize(model, de, tdm.MCMCThreads(), cell["n_iter"],
                           key=cell["key"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if any(_counts().values()):
            raise AssertionError(f"{tag}: a port kernel was launched")
        theta, best = tdm.get_optimal(de, model, pop)
        if pop.theta.dtype != np.float64:
            raise AssertionError(f"{tag}: not float64")
        if which == "rastrigin":
            ok, rows = pc.rastrigin_gate(best, theta["x"], pc.OPT_BEST_F64,
                                         pc.OPT_ARGMIN_F64)
        else:
            ok, rows = pc.mle_gate(theta["mu"], theta["sigma"],
                                   pc.opt_mle_data(cell), pc.OPT_MLE_F64)
        us = dt / cell["n_iter"] * 1e6
        out[f"opt_f64_{which}_us_per_iteration"] = us
        log(tag, f"{de.n_chains} chains, {cell['n_iter']} iterations in "
            f"{dt:.3f} s = {us:.2f} us/iteration, no port kernel launched; "
            f"optimum {rows}: {'passes' if ok else 'FAILS'} the gate")
        if not ok:
            raise AssertionError(f"{tag}: the optimum misses its gate")
    return out


def phase_timing7(dev, paths, errs):
    """Device ms per launch (spin-queued; plain, kernel, kernel, plain) of
    K1 max (the Gaussian's objective) and K1 min (the Rastrigin) at 4,096
    chains, one iteration past burn-in and a window of K (post) storing no
    row, as optimize() launches it, beside the plain versions and the
    bounds (_step_work / _window_work with the objective's operations,
    the Rastrigin's cosf counted as one)."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import fused_step
    calls, meta = {}, {}
    for which, dens in (("max-gaussian", GAUSS_LIKE_F32_OPS),
                        ("min-rastrigin", RASTRIGIN_F32_OPS)):
        model, de, _ = _opt_model("mle" if which == "max-gaussian"
                                  else "rastrigin")
        spec = tdm.make_spec(model, de)
        cfg = fused_step.StepConfig.make(model, de, spec)
        s = tdm.init_state(model, de, spec, 5, device=dev)
        st = [s.theta, s.weight, s.fire]
        it, K = 2000, fused_step.super_k()
        seed, itw = quiet_start(0, cfg, 1500, 2900 - K, K)
        o1 = (torch.empty((C, cfg.d), device=dev), torch.empty(C, device=dev),
              torch.empty(C, dtype=torch.bool, device=dev))

        def kern(a=(cfg, model, spec, st, o1, it, itw, seed, K),
                 window=False):
            c, mm, sp, st_, o1_, i1, iw, sd, k_ = a
            if window:
                fused_step.de_step(c, mm, sp, *st_, iw, seed=sd, K=k_,
                                   emit=(k_, 1), phase="post")
            else:
                fused_step.de_step(c, mm, sp, *st_, i1, out=o1_)

        def plain(a=(cfg, model, spec, st, o1, it, itw, seed, K),
                  window=False):
            c, mm, sp, st_, o1_, i1, iw, sd, k_ = a
            i0, n = (iw, k_) if window else (i1, 1)
            words = rng.words_block(sd if window else 0, i0, n,
                                    c.rows.n_words, C,
                                    device=dev).view(-1, C)
            fused_step.de_step_plain(c, mm, sp, *st_, i0, words,
                                     None if window else o1_, n,
                                     (n, 1) if window else (0, 1),
                                     "post" if window else "all")

        calls[which] = (kern, plain)
        calls[which + "-window"] = (functools.partial(kern, window=True),
                                    functools.partial(plain, window=True))
        nb1, no1 = _step_work(cfg, rng.words(0, it, cfg.rows.n_words, C,
                                             device=dev), dens)
        meta[which] = (cfg, nb1, no1, 1)
        nbK, noK = _window_work(cfg, seed, itw, K, 0, dens, dev)
        meta[which + "-window"] = (cfg, nbK, noK, K)
    t = {}
    for key, (kern, plain) in calls.items():
        for name, fn, n in ((key + "_plain", plain, 0), (key, kern, 100),
                            (key, kern, 100), (key + "_plain", plain, 0)):
            t.setdefault(name, []).append(device_ms(fn, n) if n
                                          else gapped_ms(fn))
    ms = {k: float(np.mean([x for x, _, _ in v])) for k, v in t.items()}
    for k, v in t.items():
        log("timing7", f"{k}: {ms[k]:.6f} ms per launch on the device ("
            + ", ".join(f"{x:.6f}{'' if q else ' host-gapped'}"
                        for x, q, _ in v)
            + "); host issues a call in "
            + ", ".join(f"{h:.6f}" for _, _, h in v) + " ms")
    info = {"max-gaussian": ("opt_mle", "k1_greedy"),
            "min-rastrigin": ("opt_rastrigin", "k1_greedy")}
    rows = []
    for key, (cfg, nbytes, nops, Kc) in meta.items():
        path, err = info[key.replace("-window", "")]
        tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_OPS * 1e3
        name = f"de_step/{key}" + (f"-K{Kc}-post" if Kc > 1 else "")
        rows.append({"name": name, "route": "cuda",
                     "source": "demcmc_tpu_torch/csrc/de_step.cu",
                     "replaces": "demcmc_tpu/ops/fused_step.py:2442",
                     "launches": paths[path]["de_step"],
                     "max_abs_err": errs[err], "ms": ms[key],
                     "plain_ms": ms[key + "_plain"],
                     "bound_ms": max(tb, to),
                     "bound_by": "bytes" if tb >= to else "operations",
                     "library_ms": None})
        log("timing7", f"{name}: {nbytes} bytes, {nops} operations over "
            f"{Kc} iteration(s), bound {max(tb, to):.3g} ms "
            f"({'bytes' if tb >= to else 'operations'}); "
            f"{ms[key] / Kc * 1e3:.3f} us per iteration")
    return rows


# ------------------------------------------ eighth slice: the chain mesh

MESH_SHARDS = (2, 4)      # shards on one card for the timed cells
MESH_SHORT = 128          # iterations of the LBA and ABC cells on 2 shards
MESH_KDE_ITER = 32        # of the abc_kde cell on 2 shards
MESH_UNFUSED_ITER = 400   # of the unfused Gaussian's timed runs


def _on_card(D, dev, cards=None):
    """A chain mesh of ``D`` shards on the one card or, given ``cards``,
    on the first ``D`` of them (None for D = 1)."""
    import demcmc_tpu_torch as tdm
    return None if D == 1 else tdm.chain_mesh(
        devices=[dev] * D if cards is None else cards[:D])


def _sync_cards():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def phase_k1_shard(dev):
    """K1 with ``chain0`` on each of 4 shards of the 4,096-chain Gaussian
    (θs = 0.25, so the snooker's member reads run too; α = 0.5, so the
    gate each shard writes takes both values), against its plain
    version on the same shard and against the shard's slice of a launch
    on the whole population, bit for bit (θ, w, trajectory row, accept
    flags, the gate): 8 bits-in iterations (every shard reads its columns
    of the population's ``[n_words, 4,096]`` buffer) crossing burn-in 4
    with the gate set at the start, then one on Philox words.  Returns
    the largest |difference| of θ, w and the gate, here and in the
    trajectory."""
    from demcmc_tpu_torch.ops import fused_step
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian
    data = np.random.default_rng(0).standard_normal(50).astype(np.float32)
    model, de = gaussian.make(data=data, Np=NP, n_groups=G, burnin=4,
                              theta_snooker=0.25, alpha=0.5)
    spec = tdm.make_spec(model, de)
    cfg = fused_step.StepConfig.make(model, de, spec)
    s = tdm.init_state(model, de, spec, 3, device=dev)
    full = [s.theta, s.weight, torch.ones(1, dtype=torch.int32, device=dev)]

    def slot(n):
        return (torch.empty((n, D), device=dev), torch.empty(n, device=dev),
                torch.empty(n, dtype=torch.bool, device=dev))
    shards = []
    for g0, n in fused_step.shard_groups(G, 4):
        a, b = g0 * NP, (g0 + n) * NP
        k = [full[0][a:b].clone(), full[1][a:b].clone(), full[2].clone()]
        shards.append((fused_step.local_config(cfg, n), a, b, k,
                       [x.clone() for x in k]))
    gen = np.random.default_rng(8)
    fires, worst = set(), 0.0
    for it in range(1, 10):
        words = (random_words(gen, cfg.rows.n_words, C, dev) if it < 9
                 else None)
        of = slot(C)
        fused_step.de_step(cfg, model, spec, *full, it, seed=77, bits=words,
                           out=of)
        for scfg, a, b, k, p in shards:
            ok, op = slot(b - a), slot(b - a)
            fused_step.de_step(scfg, model, spec, *k, it, seed=77,
                               bits=words, out=ok, chain0=a)
            fused_step.de_step_plain(scfg, model, spec, *p, it, words,
                                     out=op, seed=77, chain0=a)
            torch.cuda.synchronize()
            for x, y, z, what in (
                    (k[0], p[0], full[0][a:b], "theta"),
                    (k[1], p[1], full[1][a:b], "w"),
                    (k[2], p[2], full[2], "gate"),
                    (ok[0], op[0], of[0][a:b], "trajectory theta"),
                    (ok[1], op[1], of[1][a:b], "trajectory w"),
                    (ok[2].view(torch.uint8), op[2].view(torch.uint8),
                     of[2][a:b].view(torch.uint8), "accept flags")):
                if x.dtype != torch.uint8:
                    worst = max(worst, float((x - y).abs().max()),
                                float((x - z).abs().max()))
                x, y, z = (t if t.dtype == torch.uint8 else ints(t)
                           for t in (x, y, z))
                if not torch.equal(x, y):
                    raise AssertionError(f"k1-shard: {what} of the shard "
                                         f"from chain {a} differs from the "
                                         f"plain version at it={it}")
                if not torch.equal(x, z):
                    raise AssertionError(f"k1-shard: {what} of the shard "
                                         f"from chain {a} differs from the "
                                         f"whole population's at it={it}")
        fires.add(int(full[2][0]))
        log("k1-shard", f"{'bits-in' if it < 9 else 'Philox'} it={it}: 4 "
            f"shards of {C // 4} chains equal their plain versions and the "
            f"whole population's launch bit for bit; gate "
            f"{int(full[2][0])} on every shard")
    if fires != {0, 1}:
        raise AssertionError(f"k1-shard: the gate took only {fires}")
    return worst


def _same_result(tag, a, b, opt=False):
    """Raise unless a sharded run equals the unsharded one bit for bit."""
    if opt:
        for x, y, what in zip(a, b, ("theta", "weight")):
            if x.tobytes() != y.tobytes():
                raise AssertionError(f"{tag}: final {what} differs from "
                                     f"the unsharded run")
        return
    _same_run(tag, a, b, between="the sharded and the unsharded run")


def _mesh_runs(tag, dev, model, de, n_iter, key, shards, thin=1,
               allow_fused=True, opt=False, turns=1, kde=False, cards=None):
    """The unsharded run (D = 1, on ``dev``) and a run on a mesh of D
    shards of the one card (or of the first D of ``cards``) for each D in
    ``shards``, in this call (``turns`` = 2: in
    the order 1, ..., D, D, ..., 1): each sharded run equal to the
    unsharded one bit for bit, its launches K1 once per planned window
    and shard (DE-MCz: K3 once per iteration and shard) and K2 once per
    open gate (the kernels' step), or K4 once
    per iteration and shard and once for the initial weights (the
    unfused step of a model with K4, ``kde``), nothing else.  Returns µs
    and launches per iteration for each D, and the launches of each D."""
    import demcmc_tpu_torch as tdm
    order = (1,) + tuple(shards)
    if turns == 2:
        order = order + order[::-1]
    runs, secs, got = {}, {}, {}
    for D in order:
        mesh = _on_card(D, dev, cards)
        _reset_counts()
        _sync_cards()
        t0 = time.perf_counter()
        if opt:
            pop = tdm.optimize(model, de, n_iter, key=key, mesh=mesh)
            out = (pop.theta, pop.weight)
        else:
            out = tdm.sample(model, de, n_iter, key=key, thin=thin,
                             return_state=True, allow_fused=allow_fused,
                             mesh=mesh)
        _sync_cards()
        secs.setdefault(D, []).append(time.perf_counter() - t0)
        got[D] = _counts()
        if allow_fused:
            # a DE-MCz shard steps one iteration a launch
            plan = plan_counts(model, de, n_iter, key,
                               k_max=1 if de.uses_resample and D > 1
                               else None)
            k = "resample_step" if de.uses_resample else "de_step"
            want = {k: plan[k] * D, "migrate": plan["migrate"],
                    "philox_fill": plan.get("philox_fill", 0)}
        else:
            want = {"kde_logpdf": D * n_iter + 1} if kde else {}
        if got[D] != {k: want.get(k, 0) for k in got[D]}:
            raise AssertionError(f"{tag} on {D} shards: launches {got[D]}, "
                                 f"expected {want}")
        if D in runs:
            _same_result(tag, out, runs[D], opt)
        runs[D] = out
    for D in shards:
        _same_result(f"{tag} on {D} shards", runs[D], runs[1], opt)
    m = {}
    C_, d = de.n_chains, tdm.make_spec(model, de).dim
    for D in (1,) + tuple(shards):
        us = float(np.mean(secs[D])) / n_iter * 1e6
        per = sum(v for k, v in got[D].items()
                  if k != "philox_fill") / n_iter
        m[f"{D}_us_per_iteration"] = us
        m[f"{D}_launches_per_iteration"] = per
        log(tag, f"{D} shard{'s' if D > 1 else ''}: {n_iter} iterations in "
            + ", ".join(f"{x:.4f}" for x in secs[D])
            + f" s = {us:.2f} us/iteration, {C_ / us * 1e6:.4g} "
            f"chain-steps/s; launches {got[D]} = {per:.4f}/iteration")
    log(tag, "every sharded run equals the unsharded run bit for bit"
        + (f"; {got[1]['migrate']} exchanges, each gathering and copying "
           f"back {C_ * (d + 1) * 4} bytes of θ and w" if allow_fused
           else ""))
    return m, got


def phase_main_mesh(dev, cards=None, tag="main-mesh"):
    """``sample()`` and ``optimize()`` under a chain mesh on the one card
    or, given ``cards``, on the first D of them (:func:`_mesh_runs`;
    ``tools/mesh_cards.py``): the 4,096-chain Gaussian on 1, 2 and 4 shards
    and the 65,536-chain snooker Gaussian (thin 10) on 1, 2 and 4, in
    turns; the 4,096-chain Gaussian through the unfused step (400
    iterations) and opt-mle (K1 max) on 1, 2 and 4; LBA and the ABC
    binomial at 4,096 chains (128 iterations, gates open) and the
    3,072-chain abc_kde cell (32 iterations, K4 per shard) on 2.  The
    short runs cross a burn-in of half their length.  Every
    sharded run bit for bit the unsharded one, launches as planned; the
    short runs cross open gates.  Returns each cell's launches by shard
    count, and the metrics."""
    from demcmc_tpu_torch.models import gaussian
    data = _gauss_data()
    out, launches = {}, {}
    cells = [
        ("4096", gaussian.make(data=data, Np=NP, n_groups=G, burnin=BURNIN),
         N_ITER, 0, dict(turns=2)),
        ("65k", gaussian.make(data=data, Np=N65, n_groups=G65,
                              burnin=BURNIN, theta_snooker=0.1),
         N_ITER, 1, dict(thin=10, turns=2)),
        ("unfused", gaussian.make(data=data, Np=NP, n_groups=G,
                                  burnin=MESH_UNFUSED_ITER // 2),
         MESH_UNFUSED_ITER, 0, dict(allow_fused=False, turns=2)),
        ("opt_mle", _opt_model("mle")[:2], pc.OPT_MLE_CELL["n_iter"],
         pc.OPT_MLE_CELL["key"], dict(opt=True, turns=2)),
        ("lba", _lba_case(MESH_SHORT // 2), MESH_SHORT, 0,
         dict(shards=(2,))),
        ("abc", _abc_case(MESH_SHORT // 2), MESH_SHORT, 0,
         dict(shards=(2,))),
        ("kde", _kde_case(MESH_KDE_ITER // 2), MESH_KDE_ITER, 0,
         dict(shards=(2,), allow_fused=False, kde=True)),
    ]
    for name, (model, de), n_iter, key, kw in cells:
        shards = tuple(D for D in kw.pop("shards", MESH_SHARDS)
                       if cards is None or D <= len(cards))
        m, launches[name] = _mesh_runs(f"{tag}-{name}", dev, model, de,
                                       n_iter, key, shards, cards=cards,
                                       **kw)
        if name in ("lba", "abc") and not launches[name][1]["migrate"]:
            raise AssertionError(f"{tag}-{name}: no gate opened")
        out.update({f"mesh_{name}_" + k: v for k, v in m.items()})
    return launches, out


def phase_timing8(dev, launches, errs):
    """Device ms per fired exchange under a 4-shard mesh (TPU kernel row
    1r: the population gathered, K2, each shard's rows copied back) at G
    = 256 (the 4,096-chain Gaussian) and G = 4,096 (the 65,536-chain
    snooker Gaussian), beside the plain exchange (gathered, the plain K2,
    copied back) and K2's bound; and K1 on one of those 4 shards (1,024
    chains, one iteration past burn-in) beside its plain version and its
    bound."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.models import gaussian
    from demcmc_tpu_torch.ops import fused_step, migration as mig
    data = _gauss_data()
    rows, t, work, err = [], {}, {}, 0.0
    it = 2000
    for G_, Np_ in ((G, NP), (G65, N65)):
        model, de = gaussian.make(data=data, Np=Np_, n_groups=G_,
                                  burnin=BURNIN)
        spec = tdm.make_spec(model, de)
        step = tdm.build_step(model, de, spec, mesh=_on_card(4, dev))
        st = step.split(tdm.init_state(model, de, spec, 5, device=dev))
        st.shards[0].fire.fill_(1)
        C_ = G_ * Np_

        def exchange():
            step.migrate(st, it)

        def exchange_plain():
            theta, w = step._gathered(st)
            mig.migrate_plain(theta, w, st.shards[0].fire,
                              rng.words(5, it, mig.N_ROWS, C_, device=dev),
                              G_, Np_)
            step._scatter(st, theta, w)

        # the exchange against its plain version, bit for bit
        ref = step.gather(st)
        exchange()
        got = step.gather(st)
        st = step.split(ref)
        exchange_plain()
        plain = step.gather(st)
        for k in ("theta", "weight"):
            a, b = getattr(got, k), getattr(plain, k)
            if not torch.equal(ints(a), ints(b)):
                raise AssertionError(f"timing8: the mesh exchange's {k} "
                                     f"differs from its plain version at "
                                     f"G={G_}")
            err = max(err, float((a - b).abs().max()))
        # the exchange only issues work: behind a 50 ms spin it returns
        # long before the spin ends (the sampler's host loop never waits)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(50 * cycles_per_ms()))
        t0 = time.perf_counter()
        exchange()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        log("timing8", f"G={G_}: an exchange issued behind a 50 ms spin "
            f"returns in {host:.3f} ms")
        if host > 25.0:
            raise AssertionError(f"timing8: the exchange waited for the "
                                 f"card at G={G_}")
        # 40 exchanges of 11 operations each (2 gathers, K2, 8 copies
        # back) fit the stream's queue behind the spin: 100 filled it, and
        # the host then waited on the queue (a host-gapped reading)
        key = f"exchange_{G_}"
        for name, fn, n in ((key + "_plain", exchange_plain, 2),
                            (key, exchange, 40), (key, exchange, 40),
                            (key + "_plain", exchange_plain, 2)):
            t.setdefault(name, []).append(device_ms(fn, n))
        nbytes, ops = _exchange_work(G_, Np_, 2)
        log("timing8", f"G={G_}: the exchange moves {C_ * 3 * 4} bytes of "
            f"θ and w into the gathered population and back; K2's own "
            f"work {nbytes} bytes, {ops} operations")
        work[key] = (nbytes, ops)

    # K1 on one shard of four, past burn-in
    model, de = gaussian.make(data=data, Np=NP, n_groups=G, burnin=BURNIN)
    spec = tdm.make_spec(model, de)
    cfg = fused_step.StepConfig.make(model, de, spec)
    g0, n = fused_step.shard_groups(G, 4)[1]
    scfg, c0 = fused_step.local_config(cfg, n), g0 * NP
    s = tdm.init_state(model, de, spec, 5, device=dev)
    th, w = s.theta[c0:c0 + n * NP].clone(), s.weight[c0:c0 + n * NP].clone()
    fire = s.fire.clone()
    out = (torch.empty((n * NP, D), device=dev), torch.empty(n * NP,
                                                             device=dev),
           torch.empty(n * NP, dtype=torch.bool, device=dev))

    def k1():
        fused_step.de_step(scfg, model, spec, th, w, fire, it, out=out,
                           chain0=c0)

    def k1_plain():
        fused_step.de_step_plain(scfg, model, spec, th, w, fire, it, None,
                                 out=out, chain0=c0)

    for name, fn, nn in (("k1_shard_plain", k1_plain, 2),
                         ("k1_shard", k1, 200), ("k1_shard", k1, 200),
                         ("k1_shard_plain", k1_plain, 2)):
        t.setdefault(name, []).append(device_ms(fn, nn))
    words = rng.words(0, it, scfg.rows.n_words, n * NP, device=dev,
                      chain0=c0)
    work["k1_shard"] = _step_work(scfg, words, GAUSS_F32_OPS)

    ms = {k: float(np.mean([x for x, _, _ in v])) for k, v in t.items()}
    for k, v in t.items():
        log("timing8", f"{k}: {ms[k]:.6f} ms per call on the device ("
            + ", ".join(f"{x:.6f}{'' if q else ' host-gapped'}"
                        for x, q, _ in v)
            + "); host issues a call in "
            + ", ".join(f"{h:.6f}" for _, _, h in v) + " ms")
    # launches: K2 on the 4-shard runs of the two cells (one per open
    # gate), K1 on the 4-shard run of the 4,096-chain cell (all shards)
    for name, src, repl, key, n_launch, err in (
            ("migrate/mesh", "demcmc_tpu_torch/csrc/migration.cu",
             "demcmc_tpu/ops/fused_step.py:1983", f"exchange_{G}",
             launches["4096"][4]["migrate"], err),
            (f"migrate/mesh, G={G65}", "demcmc_tpu_torch/csrc/migration.cu",
             "demcmc_tpu/ops/fused_step.py:1983", f"exchange_{G65}",
             launches["65k"][4]["migrate"], err),
            ("de_step/shard", "demcmc_tpu_torch/csrc/de_step.cu",
             "demcmc_tpu/ops/fused_step.py:1858", "k1_shard",
             launches["4096"][4]["de_step"], errs["k1_shard"])):
        nbytes, ops = work[key]
        tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS * 1e3
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": n_launch,
                     "max_abs_err": err, "ms": ms[key],
                     "plain_ms": ms[key + "_plain"],
                     "bound_ms": max(tb, to),
                     "bound_by": "bytes" if tb >= to else "operations",
                     "library_ms": None})
        log("timing8", f"{name}: {ms[key]:.6f} ms against a bound of "
            f"{max(tb, to):.3g} ms ({nbytes} bytes, {ops} operations); "
            f"plain {ms[key + '_plain']:.6f} ms")
    return rows


# ------------------------------------------------- the chunked run (A4, A9)


CHUNK_VARIANTS = (("plain", {}), ("progress", {"progress": True}),
                  ("every700", {"checkpoint_every": 700}))
CHUNK_KDE_ITER, CHUNK_KDE_BURNIN = 300, 100   # abc_kde's run in main-chunked
CKPT_UNFUSED_ITER = 300                       # the unfused Gaussian's run
STOP_ITER, STOP_RHAT = 20_000, 1.01           # main-monitor's early stop
PINNED_COLD_BYTES = 3 << 29    # 1.5 GiB: above any trajectory the phases
                               # keep, so its first allocation is cold


def _quiet_sample(model, de, n_iter, key, unfused=False, **kw):
    """``sample()`` on the card with its progress line captured (returned
    beside the result); the unfused step under ``torch.inference_mode()``
    as in ``_unfused_sample``."""
    import io
    import demcmc_tpu_torch as tdm
    buf = io.StringIO()
    ctx = torch.inference_mode() if unfused else contextlib.nullcontext()
    with ctx, contextlib.redirect_stdout(buf):
        out = tdm.sample(model, de, n_iter, key=key, **kw)
    torch.cuda.synchronize()
    return out, buf.getvalue()


def _open_gates(model, de, n_iter, key):
    """Run indices ``i >= 1`` of a run from the start whose migration gate
    is open (the gate iteration it0 + i - 1 writes)."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.ops import fused_step
    cfg = fused_step.StepConfig.make(model, de, tdm.make_spec(model, de))
    g = _gates(key, de.n_initial + 1, n_iter, cfg)
    return set((np.flatnonzero(g[:n_iter - 1]) + 1).tolist())


def _chunked_runs(tag, model, de, n_iter, key, thin=1, mesh=None,
                  unfused=False, k4=False, variants=CHUNK_VARIANTS):
    """``sample()`` as it comes and chunked (``variants``: progress, a
    checkpoint interval the chunks do not divide), each bit for bit the
    others and the one-launch-per-iteration loop's kept rows
    (``_loop_run``, unsharded), final state included; the launches as the
    gates' plan with the chunks' edges says (K1 or K3 once per window and
    shard, K2 once per open gate), or K4 once per iteration and shard and
    once for the initial weights; the progress line's last count the
    run's.  Returns µs per iteration of each variant."""
    runs, secs = {}, {}
    D = 1 if mesh is None else len(mesh.devices)
    for name, opts in variants:
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, text = _quiet_sample(model, de, n_iter, key, unfused, thin=thin,
                                  return_state=True, mesh=mesh,
                                  allow_fused=not unfused, **opts)
        secs[name] = time.perf_counter() - t0
        got = _counts()
        if unfused:
            want = {"kde_logpdf": D * n_iter + 1} if k4 else {}
        else:
            want = plan_counts(model, de, n_iter, key, thin=thin,
                               chunked=opts)
            want = {k: v * D if k not in ("migrate", "philox_fill")
                    else v for k, v in want.items()}
        if got != {k: want.get(k, 0) for k in got}:
            raise AssertionError(f"{tag} {name}: launches {got}, expected "
                                 f"{want}")
        if opts.get("progress") and \
                f"] {n_iter}/{n_iter} iterations" not in text:
            raise AssertionError(f"{tag} {name}: no final progress line")
        runs[name] = out
    ctx = torch.inference_mode() if unfused else contextlib.nullcontext()
    with ctx:
        loop = _loop_run(model, de, n_iter, key, thin)
    for name in runs:
        _same_run(tag, runs[name], loop,
                  between=f"sample({name}) and the loop's kept rows")
    C_ = de.n_chains
    m = {f"{name}_us_per_iteration": secs[name] / n_iter * 1e6
         for name in runs}
    log(tag, f"{n_iter} iterations (thin {thin}, {C_} chains"
        + (f", {D} shards" if D > 1 else "") + "): "
        + ", ".join(f"{k} {v:.2f}" for k, v in m.items())
        + f" us/iteration; {runs['plain'][0].data.shape[0]} kept rows; "
        f"every variant equals the loop's kept rows bit for bit")
    return {f"{tag}_{k}": v for k, v in m.items()}


def phase_main_chunked(dev):
    """``sample()`` plain, with ``progress=True`` (20 chunks) and with
    ``checkpoint_every=700``, bit for bit one another and the loop's kept
    rows: the Gaussian 4,096, the snooker Gaussian 65,536 (thin 10), the
    mcz-mig cell (K3 and K2, a chunk edge on an open gate), LBA 4,096,
    abc_kde 3,072 (300 iterations, K4 through the unfused step) and the
    Gaussian 4,096 on a 2-shard mesh of the card."""
    from demcmc_tpu_torch.models import gaussian
    data, m = _gauss_data(), {}
    model, de = gaussian.make(data=data, Np=NP, n_groups=G, burnin=BURNIN)
    m.update(_chunked_runs("main-chunked-4096", model, de, N_ITER, 0))
    m.update(_chunked_runs("main-chunked-mesh2", model, de, N_ITER, 0,
                           mesh=_on_card(2, dev)))
    model, de = gaussian.make(data=data, Np=N65, n_groups=G65, burnin=1000,
                              alpha=0.1, theta_snooker=0.1)
    m.update(_chunked_runs("main-chunked-65k", model, de, 3000, 0, thin=10))
    cell = pc.MCZ_MIG_CELL
    model, de = gaussian.make(
        data=data, n_groups=cell["n_groups"], Np=cell["Np"],
        alpha=cell["alpha"], sample="resample", n_initial=cell["n_initial"],
        burnin=cell["burnin"], theta_snooker=cell["theta_snooker"],
        sweep="sync")
    n = cell["n_iter"]
    opens = _open_gates(model, de, n, 0)
    edge = min(opens)            # a chunk edge on an open gate
    log("main-chunked-mcz-mig", f"checkpoint_every={edge}: the first open "
        f"gate (run index {edge}) on a chunk's edge")
    m.update(_chunked_runs("main-chunked-mcz-mig", model, de, n, 0,
                           variants=CHUNK_VARIANTS + (
                               ("gate-edge", {"checkpoint_every": edge}),)))
    case, cell = ZOO["lba"]
    model, de = case(burnin=cell["burnin"])
    m.update(_chunked_runs("main-chunked-lba", model, de, cell["n_iter"], 0))
    model, de = _kde_case(CHUNK_KDE_BURNIN)
    m.update(_chunked_runs("main-chunked-kde", model, de, CHUNK_KDE_ITER, 0,
                           unfused=True, k4=True,
                           variants=(("plain", {}),
                                     ("progress", {"progress": True}),
                                     ("every70", {"checkpoint_every": 70}))))
    return m


def _ckpt_interval(model, de, n_iter, key):
    """A checkpoint interval from a fifth to half of the run whose last
    snapshot (the JAX loop's rule on ``chunk_schedule``'s chunks, cut at
    the burn-in switch) falls inside the run on an iteration whose
    migration gate is open, so the saved gate is 1."""
    from demcmc_tpu_torch import sampler
    opens = _open_gates(model, de, n_iter, key)
    switch = de.burnin - de.n_initial
    for every in range(n_iter // 5, n_iter // 2):
        done = last = 0
        for c in sampler.chunk_schedule(n_iter, 1, every,
                                        switch=switch if switch > 0
                                        else None):
            done += c
            if done - last >= every:
                last = done
        if last < n_iter and last in opens:
            return every
    raise AssertionError("no checkpoint interval lands on an open gate")


def phase_main_ckpt(dev):
    """Runs interrupted at a checkpoint, loaded and resumed, each bit for
    bit the uninterrupted run (draws and final state): the Gaussian 4,096
    (K1), the mcz-mig cell (K3 and K2) with the saved gate open across
    the checkpoint, and the unfused Gaussian 4,096 (300 iterations); each
    asynchronous write's milliseconds and whether it overlapped the next
    chunk (still under way when the run went on)."""
    import tempfile
    from demcmc_tpu_torch.models import gaussian
    from demcmc_tpu_torch.utils import checkpoint
    data, m = _gauss_data(), {}
    cell = pc.MCZ_MIG_CELL
    cases = []
    model, de = gaussian.make(data=data, Np=NP, n_groups=G, burnin=BURNIN,
                              discard_burnin=False)
    cases.append(("main-ckpt-k1", model, de, N_ITER, False,
                  _ckpt_interval(model, de, N_ITER, 0)))
    model, de = gaussian.make(
        data=data, n_groups=cell["n_groups"], Np=cell["Np"],
        alpha=cell["alpha"], sample="resample", n_initial=cell["n_initial"],
        burnin=cell["burnin"], theta_snooker=cell["theta_snooker"],
        sweep="sync", discard_burnin=False)
    cases.append(("main-ckpt-mcz-mig", model, de, cell["n_iter"], False,
                  _ckpt_interval(model, de, cell["n_iter"], 0)))
    model, de = gaussian.make(data=data, Np=NP, n_groups=G, burnin=100,
                              discard_burnin=False)
    cases.append(("main-ckpt-unfused", model, de, CKPT_UNFUSED_ITER, True,
                  70))
    save = checkpoint.save_state
    writes = []      # (future, done when the run went on) of each write

    def recording(path, state, async_=False):
        fut = save(path, state, async_=async_)
        writes.append((fut, fut.done()))
        return fut
    OUT.mkdir(exist_ok=True)
    checkpoint.save_state = recording
    try:
        with tempfile.TemporaryDirectory(dir=OUT) as tmp:
            for case in cases:
                m.update(_resume_case(*case, f"{tmp}/{case[0]}", writes))
    finally:
        checkpoint.save_state = save
    return m


def _resume_case(tag, model, de, n, unfused, every, path, writes):
    """One case of :func:`phase_main_ckpt`: the uninterrupted run, the run
    with checkpoints, and the run resumed from the last of them."""
    import demcmc_tpu_torch as tdm
    full, _ = _quiet_sample(model, de, n, 0, unfused, return_state=True,
                            allow_fused=not unfused)
    writes.clear()
    _quiet_sample(model, de, n, 0, unfused, allow_fused=not unfused,
                  checkpoint_every=every, checkpoint_path=path)
    state = tdm.load_state(path)
    done = state.iteration - de.n_initial - 1
    if not 0 < done < n:
        raise AssertionError(f"{tag}: last snapshot at {done}")
    resumed, _ = _quiet_sample(model, de, n - done, 0, unfused, state=state,
                               return_state=True, allow_fused=not unfused)
    (cf, sf), (cr, sr) = full, resumed
    for x, y, what in ((cr.data, cf.data[done:], "draws"),
                       (cr.lp, cf.lp[done:], "lp"),
                       (cr.acceptance, cf.acceptance[done:], "acceptance")):
        if x.shape != y.shape or x.tobytes() != y.tobytes():
            raise AssertionError(f"{tag}: resumed {what} differ from the "
                                 f"uninterrupted run's")
    if sr.history is not None:            # grown again for the resumed run
        sr = sr._replace(history=sr.history[:sf.history.shape[0]])
    _same_run(tag, (cf, sf), (cf, sr),
              between="the resumed and the uninterrupted run")
    if tag == "main-ckpt-mcz-mig" and int(state.fire[0]) != 1:
        raise AssertionError(f"{tag}: the saved gate is not open")
    ms = [(f.result()["end"] - f.result()["start"]) * 1e3 for f, _ in writes]
    overlapped = [not done_then for _, done_then in writes]
    log(tag, f"checkpoint_every={every}: {len(ms)} writes of "
        + ", ".join(f"{x:.2f} ms" + (" (overlapped the next chunk)" if o
                                     else " (done before the run went on)")
                    for x, o in zip(ms, overlapped))
        + f"; resumed at iteration {state.iteration} (gate "
        f"{int(state.fire[0])}) for {n - done} iterations: draws and final "
        f"state equal the uninterrupted run's bit for bit")
    return {f"{tag}_write_ms": ms, f"{tag}_writes_overlapped": sum(overlapped)}


def phase_main_monitor(dev):
    """The Gaussian 4,096 with ``monitor=True``: the streaming split-R̂
    within 1e-2 of the draws' split R̂, one monitor row per kept draw; with
    ``stop_rhat=1.01`` over 20,000 iterations: an early stop at a chunk's
    end, R̂max at most 1.01, and the draws through ``[main]``'s quadrature
    gate."""
    from demcmc_tpu_torch import diagnostics
    from demcmc_tpu_torch.models import gaussian
    data = _gauss_data()
    model, de = gaussian.make(data=data, Np=NP, n_groups=G, burnin=BURNIN)
    chains, _ = _quiet_sample(model, de, N_ITER, 0, monitor=True)
    mon = chains.monitor
    r = mon.rhat()
    want = np.array([diagnostics.split_rhat(chains[n]) for n in chains.names])
    log("main-monitor", f"streaming split-R̂ {np.round(r, 6)} against the "
        f"draws' {np.round(want, 6)}; {mon.n} monitored draws")
    if mon.n != len(chains) or not np.all(np.abs(r - want) <= 1e-2):
        raise AssertionError("main-monitor: streaming R̂ off the draws'")
    t0 = time.perf_counter()
    chains, text = _quiet_sample(model, de, STOP_ITER, 0,
                                 stop_rhat=STOP_RHAT, progress=True)
    dt = time.perf_counter() - t0
    n = len(chains)
    r = chains.monitor.max_rhat()
    log("main-monitor", f"stop_rhat={STOP_RHAT}: stopped after {n} kept "
        f"draws ({n + BURNIN} of {STOP_ITER} iterations) in {dt:.3f} s, "
        f"streaming R̂max {r:.5f}; "
        f"{text.strip().splitlines()[-1] if text.strip() else ''}")
    if not 50 <= n < STOP_ITER - BURNIN or r > STOP_RHAT:
        raise AssertionError("main-monitor: no early stop at the target")
    _posterior_gate("main-monitor", chains, data, n, C)
    return {"monitor_rhat": r.tolist() if hasattr(r, "tolist") else r,
            "stop_rhat_kept_draws": n, "stop_rhat_seconds": dt}


def phase_trace_chunked(dev):
    """The Gaussian 4,096 cell's ``sample()`` under ``torch.profiler``:
    its rows reach pinned host memory in copies that overlap the K1
    windows (hidden against exposed copy ms), the idle share over the
    span, and the host's final wait for the last copy; then the pinned
    allocation of the cell's kept rows and of a size no phase allocated,
    each twice (the second time from PyTorch's host cache)."""
    from demcmc_tpu_torch import sampler
    from demcmc_tpu_torch.models import gaussian
    model, de = gaussian.make(data=_gauss_data(), Np=NP, n_groups=G,
                              burnin=BURNIN)
    waits = []
    result = sampler._Store.result

    def timed(self):
        t0 = time.perf_counter()
        out = result(self)
        waits.append(time.perf_counter() - t0)
        return out
    sampler._Store.result = timed
    try:
        out = _trace_sample("trace-chunked", model, de, N_ITER,
                            {"de_step": K1_NAME, "migrate": k2_kernels(de)},
                            "trace_chunked.json")
    finally:
        sampler._Store.result = result
    if out["trajectory_copies"] < 2 or out["trajectory_copy_hidden_ms"] <= 0:
        raise AssertionError("trace-chunked: the trajectory's copies do not "
                             "overlap the kernels")
    # the pinned allocation: the cell's kept rows (which the host cache
    # holds from the runs above), and a size no phase has allocated
    T = N_ITER - BURNIN
    alloc = {}
    for what, n in (("cell", T * C * (D + 1) * 4 + T * C),
                    ("new", PINNED_COLD_BYTES)):
        for turn in ("first", "again"):
            t0 = time.perf_counter()
            h = torch.empty(n, dtype=torch.uint8, pin_memory=True)
            alloc[f"{what}_{turn}"] = (time.perf_counter() - t0) * 1e3
            del h
    log("trace-chunked", f"host's final wait for the last copy "
        f"{waits[-1] * 1e3:.3f} ms; pinned allocation of the cell's "
        f"{(T * C * (D + 1) * 4 + T * C) / 1e6:.1f} MB "
        f"{alloc['cell_first']:.3f} ms, again {alloc['cell_again']:.3f} "
        f"ms; of {PINNED_COLD_BYTES / 1e6:.1f} MB, a size not cached, "
        f"{alloc['new_first']:.3f} ms, again from the host cache "
        f"{alloc['new_again']:.3f} ms")
    out.update({"final_wait_ms": waits[-1] * 1e3,
                **{f"pinned_alloc_{k}_ms": v for k, v in alloc.items()}})
    return {"trace_chunked_" + k: v for k, v in out.items()}


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


# ------------------------------------------- fourteenth slice: the custom
# strategy slots and stochastic models in the unfused step

def _kde_fresh_case(burnin):
    """(model, de) of the fresh-noise abc_kde cell: KDE_CELL's sizes and
    data, a new simulation at every evaluation."""
    from demcmc_tpu_torch.models import abc_kde
    c = pc.KDE_FRESH_CELL
    return abc_kde.make(data=pc.kde_inputs()[0], n_sim=pc.KDE_N_SIM,
                        Np=c["Np"], n_groups=c["n_groups"], burnin=burnin,
                        fresh_noise=True)


def phase_main_kde_fresh(dev):
    """``sample()`` on the fresh-noise abc_kde cell (3,072 chains, 10,000
    simulations per evaluation) through the unfused step: K4 and the
    noise panel fill launched once per iteration and once for the initial
    weights, K1, K2 and K3 never; (μ, σ) means and sds within
    KDE_TOL of the quadrature of the panel-averaged synthetic
    likelihood (computed in a forked process meanwhile), max R̂ < 1.01."""
    c = pc.KDE_FRESH_CELL
    n_iter = c["n_iter"]
    model, de = _kde_fresh_case(c["burnin"])
    t0 = time.perf_counter()
    oracle = _forked(pc.kde_fresh_oracle, pc.kde_inputs()[0])
    chains, launches, dt = _unfused_sample(
        "main-kde-fresh", model, de, n_iter,
        {"kde_logpdf": n_iter + 1, "philox_fill": n_iter + 1})
    oracle = oracle()
    log("main-kde-fresh", f"oracle ({pc.KDE_FRESH_PANELS} panels, "
        f"{pc.KDE_FRESH_GRID}^2 grid; ready "
        f"{time.perf_counter() - t0:.1f} s after the phase began): {oracle}")
    ok, rows = pc.kde_gate(chains["mu"], chains["sigma"], oracle)
    for name, (mean, sd) in rows.items():
        log("main-kde-fresh", f"{name}: mean {mean:.5f} (oracle "
            f"{oracle[name][0]:.5f}), sd {sd:.5f} (oracle "
            f"{oracle[name][1]:.5f})")
    if not ok:
        raise AssertionError("main-kde-fresh: posterior off the oracle")
    _rhat_gate("main-kde-fresh", chains, "kde_fresh_rhat_max")
    C_ = de.n_chains
    return launches, {"kde_fresh_us_per_iteration": dt / n_iter * 1e6,
                      "kde_fresh_chain_steps_per_s": C_ * n_iter / dt,
                      "kde_fresh_acceptance":
                          float(chains.acceptance.mean())}


def phase_main_abc_fixed(dev):
    """``sample()`` on the fixed-noise ABC binomial (4,096 chains, N =
    10, n_sim = 10,000, its panel from numpy seed 123) through the
    unfused step, no kernel of the port launched: θ's mean and sd within
    ABC_FIXED_TOL of the exact posterior of the panel's step-function
    likelihood, max R̂ < 1.01."""
    from demcmc_tpu_torch.models import binomial
    c = pc.ABC_FIXED_CELL
    model, de = binomial.make(N=c["N"], k=c["k"], abc=True,
                              n_sim=pc.N_SIM, Np=c["Np"],
                              n_groups=c["n_groups"], burnin=c["burnin"])
    n_iter = c["n_iter"]
    chains, launches, dt = _unfused_sample("main-abc-fixed", model, de,
                                           n_iter, {})
    oracle = pc.abc_fixed_oracle(pc.abc_panel(pc.N_SIM, c["N"]), c["k"])
    ok, (mean, sd) = pc.abc_fixed_gate(chains["theta"], oracle)
    log("main-abc-fixed", f"theta: mean {mean:.5f} (exact {oracle[0]:.5f}),"
        f" sd {sd:.5f} (exact {oracle[1]:.5f})")
    if not ok:
        raise AssertionError("main-abc-fixed: posterior off the oracle")
    _rhat_gate("main-abc-fixed", chains, "abc_fixed_rhat_max")
    return {"abc_fixed_us_per_iteration": dt / n_iter * 1e6,
            "abc_fixed_chain_steps_per_s": de.n_chains * n_iter / dt,
            "abc_fixed_acceptance": float(chains.acceptance.mean())}


def _delegating_sample(ctx, key, n, exclude_self, replace):
    from demcmc_tpu_torch.ops import proposals
    return proposals.sample_current(ctx, key, n, exclude_self, replace)


def _delegating_proposal(ctx, key):
    from demcmc_tpu_torch.ops import proposals
    return proposals.random_gamma(ctx, key)


def _random_walk(ctx, key):
    return ctx.theta + 0.15 * key.normal(ctx.theta.shape, ctx.theta.dtype)


def _tempered(model, spec, de, x):
    from demcmc_tpu_torch.ops import accept
    return 0.5 * accept.compute_posterior(model, spec, de, x)


def _tempered_noisy(model, spec, de, x, noise):
    from demcmc_tpu_torch.ops import accept
    return 0.5 * accept.compute_posterior(model, spec, de, x, noise)


def _always(key, w_cur, w_prop, log_adj):
    return torch.ones(w_cur.shape, dtype=torch.bool, device=w_cur.device)


def _bounded_prior(uniform, n):
    """μ ~ N(0, 1), σ ~ U(0.5, 2): the JAX random-walk test's start."""
    u = uniform(3)
    mu = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u[0], 1.2e-38))) \
        * torch.cos(2.0 * np.pi * u[1])
    return [mu, 0.5 + 1.5 * u[2]]


def phase_main_custom(dev):
    """The unfused 4,096-chain Gaussian with custom strategy slots: a
    ``sample`` slot and a ``generate_proposal`` that delegate to their
    built-ins give the built-in unfused run bit for bit; the random walk
    drawing from its key (two panel fills an iteration, the key's words)
    within the JAX test's bounds of the quadrature posterior; tempering
    at T = 2 widens μ's sd by over 1.25; always-accept accepts every
    proposal; no kernel of the port but the fill is launched.  Then the
    tempered fitness on the fresh abc_kde cell (:func:`_custom_kde`)."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian
    c = pc.GAUSS_UNFUSED_CELL
    data = _gauss_data()

    def run(tag, n_iter, want, burnin, **slots):
        model, de = gaussian.make(data=data, Np=c["Np"],
                                  n_groups=c["n_groups"], burnin=burnin)
        if slots.pop("bounded", False):
            model.sample_prior = _bounded_prior
        chains, _, dt = _unfused_sample(tag, model, de.replace(**slots),
                                        n_iter, want)
        return chains, dt / n_iter * 1e6

    m = {}
    n = pc.CUSTOM_BITWISE_ITER
    ref, m["custom_builtin_us_per_iteration"] = run(
        "main-custom builtin", n, {}, n // 2)
    for name, slots in (("sample", {"sample": _delegating_sample}),
                        ("proposal",
                         {"generate_proposal": _delegating_proposal})):
        got, m[f"custom_{name}_us_per_iteration"] = run(
            f"main-custom {name}", n, {}, n // 2, **slots)
        for a, b, what in ((got.data, ref.data, "draws"),
                           (got.lp, ref.lp, "lp"),
                           (got.acceptance, ref.acceptance, "acceptance")):
            if np.ascontiguousarray(a).tobytes() != \
                    np.ascontiguousarray(b).tobytes():
                raise AssertionError(f"main-custom {name}: {what} differ "
                                     f"from the built-in run")
        log("main-custom", f"a delegating {name} slot: {n} iterations bit "
            f"for bit the built-in unfused run")
    rw = pc.CUSTOM_RW
    chains, m["custom_rw_us_per_iteration"] = run(
        "main-custom random-walk", rw["n_iter"],
        {"philox_fill": 2 * (rw["n_iter"] + 1)}, rw["burnin"],
        generate_proposal=_random_walk, bounded=True)
    truth = gaussian.posterior_grid(data)
    off = {k: abs(chains.mean(k) - truth[k]["mean"]) for k in truth}
    log("main-custom", f"random walk: |mean - oracle| mu {off['mu']:.5f}, "
        f"sigma {off['sigma']:.5f}; acceptance "
        f"{float(chains.acceptance.mean()):.4f}")
    if not (off["mu"] < rw["mu_tol"] and off["sigma"] < rw["sigma_tol"]):
        raise AssertionError("main-custom: the random walk is off the "
                             "posterior")
    t = pc.CUSTOM_TEMPER
    cold, _ = run("main-custom cold", t["n_iter"], {}, t["burnin"])
    hot, m["custom_tempered_us_per_iteration"] = run(
        "main-custom tempered", t["n_iter"], {}, t["burnin"],
        evaluate_fitness=_tempered)
    ratio = float(hot.std("mu") / cold.std("mu"))
    m["custom_tempered_sd_ratio"] = ratio
    log("main-custom", f"tempered (T = 2): sd of mu {hot.std('mu'):.5f} "
        f"against {cold.std('mu'):.5f}, ratio {ratio:.4f}")
    if not ratio > t["ratio"]:
        raise AssertionError("main-custom: tempering did not widen the "
                             "posterior")
    k = pc.CUSTOM_ALWAYS
    chains, _ = run("main-custom always", k, {}, k // 2,
                    update_particle=_always)
    if float(chains.acceptance.mean()) != 1.0:
        raise AssertionError("main-custom: always-accept rejected")
    log("main-custom", f"always-accept: acceptance 1.0 over {k} "
        f"iterations")
    if tdm.sampler.fused_supported(*gaussian.make(
            data=data, generate_proposal=_delegating_proposal), dev):
        raise AssertionError("main-custom: a custom slot would fuse")
    m.update(_custom_kde(dev))
    return m


def _custom_kde(dev):
    """The tempered fitness slot on the fresh-noise abc_kde cell: on one
    panel, through ``make_fitness`` (per cell under vmap), one K4 launch
    for the 3,072 cells and half the built-in fitness within
    CUSTOM_KDE_RTOL; then ``sample()`` for CUSTOM_KDE's iterations, K4
    and the panel fill once an evaluation."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import accept, fused_step, kde
    c = pc.CUSTOM_KDE
    model, de = _kde_fresh_case(c["burnin"])
    hot = de.replace(evaluate_fitness=_tempered_noisy)
    spec = tdm.make_spec(model, de)
    C_ = de.n_chains
    x = model.init_population(spec, 7, C_, device=dev).reshape(
        de.n_groups, de.Np, -1)
    panel = torch.empty((pc.KDE_N_SIM, C_), dtype=torch.float32,
                        device=dev)
    fused_step.philox_fill(panel, 5, 77, rng.EVAL_NS)
    with torch.inference_mode():
        want = 0.5 * accept.make_fitness(model, spec, de)(x, panel)
        before = kde.kde_logpdf.launches
        got = accept.make_fitness(model, spec, hot)(x, panel)
        torch.cuda.synchronize()
        n_k4 = kde.kde_logpdf.launches - before
    diff = (got - want).abs()
    rel = float((diff / (1 + want.abs())).max())
    log("main-custom", f"tempered fitness on the fresh abc_kde cell, one "
        f"panel: {n_k4} K4 launch for {C_} cells; max |slot - half the "
        f"built-in| {float(diff.max()):.3g} (relative {rel:.3g}, "
        f"{'bit for bit' if torch.equal(got, want) else 'not bit for bit'})")
    if n_k4 != 1 or not torch.isfinite(got).all() or \
            not rel <= pc.CUSTOM_KDE_RTOL:
        raise AssertionError("main-custom: the tempered fitness on abc_kde "
                             "is off half the built-in's, or took more "
                             "than one K4 launch")
    n_iter = c["n_iter"]
    _, _, dt = _unfused_sample(
        "main-custom kde-tempered", model, hot, n_iter,
        {"kde_logpdf": n_iter + 1, "philox_fill": n_iter + 1})
    return {"custom_kde_tempered_us_per_iteration": dt / n_iter * 1e6}


def phase_main_lv(dev):
    """Lotka–Volterra at the reference example's width (36 chains): its
    log posterior on the card against the CPU's on LV_DENSITY_DRAWS prior
    draws (within LV_DENSITY_RTOL / LV_DENSITY_ATOL, ms of one evaluation
    on each); then ``sample()`` through the unfused step for LV_CELL's
    iterations, no kernel of the port launched, µs per iteration."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import lotka_volterra
    from demcmc_tpu_torch.ops import accept
    c = pc.LV_CELL
    model, de = lotka_volterra.make(Np=c["Np"], n_groups=c["n_groups"],
                                    burnin=c["burnin"])
    spec = tdm.make_spec(model, de)
    x = model.init_population(spec, 7, pc.LV_DENSITY_DRAWS, device="cpu")
    secs = {}
    with torch.inference_mode():
        for where, xx in (("card", x.to(dev)), ("cpu", x)):
            accept.compute_posterior(model, spec, de, xx[:8])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w = accept.compute_posterior(model, spec, de, xx).cpu()
            torch.cuda.synchronize()
            secs[where] = (w, time.perf_counter() - t0)
    got, want = secs["card"][0], secs["cpu"][0]
    fin = torch.isfinite(want)
    diff = (got - want).abs()[fin]
    rel = float((diff / (pc.LV_DENSITY_ATOL + pc.LV_DENSITY_RTOL
                         * want.abs()[fin])).max())
    log("main-lv", f"log posterior of {pc.LV_DENSITY_DRAWS} prior draws: "
        f"card {secs['card'][1] * 1e3:.2f} ms, cpu {secs['cpu'][1] * 1e3:.2f} "
        f"ms; {int(fin.sum())} finite; max |card - cpu| "
        f"{float(diff.max()):.3g} ({rel:.3f} of the tolerance)")
    if not torch.equal(torch.isfinite(got), fin) or rel > 1.0:
        raise AssertionError("main-lv: the card's density is off the CPU's")
    n_iter = c["n_iter"]
    chains, _, dt = _unfused_sample("main-lv", model, de, n_iter, {})
    log("main-lv", f"posterior means after {n_iter - c['burnin']} kept "
        f"draws (no gate: the run is short of the reference's 3,000 "
        f"iterations): " + ", ".join(
            f"{k} {chains.mean(k):.4f}" for k in chains.names))
    return {"lv_us_per_iteration": dt / n_iter * 1e6,
            "lv_chain_steps_per_s": de.n_chains * n_iter / dt,
            "lv_density_card_ms": secs["card"][1] * 1e3,
            "lv_density_cpu_ms": secs["cpu"][1] * 1e3}


def phase_trace_kde_fresh(dev):
    """The fresh-noise abc_kde cell (200 iterations, burn-in 100) under
    ``torch.profiler``: K4 and the panel fill once per iteration and
    once for the initial weights; each one's device µs per iteration,
    the device's idle share."""
    model, de = _kde_fresh_case(100)
    return {"kde_fresh_" + k: v for k, v in _trace_unfused(
        "trace-kde-fresh", model, de, 200, "trace_kde_fresh.json", True,
        fills=201).items()}


def phase_timing9(dev, launches, errs):
    """The noise panel fill's device ms per launch at the fresh abc_kde
    cell's shape (10,000 uniforms × 3,072 chains; spin-queued, plain,
    fill, fill, plain), beside its plain version (torch's Philox on the
    card) and its bound: bytes, the panel written once (no input);
    operations, PHILOX_OPS per block of four rows and chain, and 3 per
    uniform.  K4's row for the fresh cell (:func:`_k4_row`) on that
    cell's inputs: the data, and simulations μ + σ·Φ⁻¹(u + 2⁻²⁴) from
    the filled panel, as the fresh-noise density makes them, K4 held
    against its plain version on them as [k4] holds it."""
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.models import abc_kde
    from demcmc_tpu_torch.ops import fused_step, kde
    from demcmc_tpu_torch.utils import kde as kde_utils
    c = pc.KDE_FRESH_CELL
    n, rows_ = c["n_groups"] * c["Np"], pc.KDE_N_SIM
    out = torch.empty((rows_, n), dtype=torch.float32, device=dev)

    def fill():
        fused_step.philox_fill(out, 5, 77, rng.EVAL_NS)

    def plain():
        rng.to_uni(rng.words(5, 77, rows_, n, rng.EVAL_NS, dev))

    t = {}
    for name, fn, k in (("plain", plain, 2), ("fill", fill, 20),
                        ("fill", fill, 20), ("plain", plain, 2)):
        t.setdefault(name, []).append(device_ms(fn, k))
    ms = {k: float(np.mean([x_ for x_, _, _ in v])) for k, v in t.items()}
    for k, v in t.items():
        log("timing9", f"{k}: {ms[k]:.6f} ms per call on the device ("
            + ", ".join(f"{x_:.6f}{'' if q else ' host-gapped'}"
                        for x_, q, _ in v) + ")")
    nbytes = 4 * rows_ * n
    nops = PHILOX_OPS * (-(-rows_ // 4)) * n + 3 * rows_ * n
    tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_OPS * 1e3
    log("timing9", f"philox_fill: {nbytes} bytes, {nops} operations, bound "
        f"{max(tb, to):.4g} ms ({'bytes' if tb >= to else 'operations'}); "
        f"at {max(tb, to) / ms['fill']:.3f} of its bound")
    fill()
    g = np.random.default_rng(n)
    mu = torch.tensor(g.normal(0.14, 0.13, n).astype(np.float32),
                      device=dev)
    sg = torch.tensor(g.uniform(0.7, 1.3, n).astype(np.float32), device=dev)
    z = torch.special.ndtri(out + abc_kde.HALF_ULP)
    sims = (mu[None] + sg[None] * z).T.contiguous()
    h = kde_utils.silverman_bandwidth(sims)
    x = torch.tensor(pc.kde_inputs()[0], dtype=torch.float32, device=dev)
    got = kde.kde_logpdf(x, sims, h, pc.KDE_FLOOR)
    ref = kde.kde_logpdf_plain(x, sims, h, pc.KDE_FLOOR)
    diff = (got - ref).abs()
    err, rel = float(diff.max()), float((diff / (1 + ref.abs())).max())
    log("timing9", f"K4 on the fresh cell's inputs: max |K4 - plain| "
        f"{err:.3g}, relative {rel:.3g}")
    if not rel <= 2e-5 or not torch.isfinite(got).all():
        raise AssertionError("timing9: K4 disagrees with its plain version "
                             "on the fresh cell's inputs")
    k4 = _k4_row("timing9", f"kde_logpdf/abc_kde-fresh-{n}", x, sims, h,
                 launches["kde_logpdf"], err)
    return [{"name": f"philox_fill/eval-panel-{rows_}x{n}", "route": "cuda",
             "source": "demcmc_tpu_torch/csrc/de_step.cu",
             "replaces": "demcmc_tpu/ops/fused_step.py:1508",
             "launches": launches["philox_fill"],
             "max_abs_err": errs["philox"], "ms": ms["fill"],
             "plain_ms": ms["plain"], "bound_ms": max(tb, to),
             "bound_by": "bytes" if tb >= to else "operations",
             "library_ms": None}, k4]


# ------------------------------------------- fifteenth slice: replicated
# runs (sample_replicated, sample_replicated_packed, optimize_replicated)

REP_NAME, REP_K2_NAME = "RepPartners", "migrate_segments_kernel"


def _same_bits(tag, pairs):
    """Raise unless every (kernel, plain, what) pair is equal bit for bit
    (bool tensors as bytes)."""
    for a, b, what in pairs:
        va = a.view(torch.uint8) if a.dtype == torch.bool else ints(a)
        vb = b.view(torch.uint8) if b.dtype == torch.bool else ints(b)
        if not torch.equal(va, vb):
            raise AssertionError(f"{tag}: {what} differ from the plain "
                                 f"version")


def _rep_case(models, de, dev, seeds=None, packed_key=None):
    """(step, state, spec) of a replicated launch over ``models`` (one
    per replication): :class:`sampler.RepStep` and the replications'
    initial states side by side; ``seeds`` default 11, 12, ..."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import sampler
    spec = tdm.make_spec(models[0], de)
    seeds = list(seeds or range(11, 11 + len(models)))
    step = sampler.RepStep(models, de, spec, dev, seeds, packed_key)
    state = sampler._rep_state(models, de, spec, seeds, dev)
    return step, [state.theta, state.weight, state.fire], spec


def _rep_compare(tag, cfg, spec, state, it, K=1, emit=(0, 1), words=None,
                 phase="all"):
    """One replicated K1 launch (a window of ``K``) and its plain version
    from copies of ``state``: θ, w, every replication's gate and the
    stored rows bit for bit.  Returns the plain result and its accepted
    count."""
    from demcmc_tpu_torch.ops import fused_step
    dev = state[0].device
    C_, T = cfg.G * cfg.Np, fused_step.n_emitted(K, emit)
    k = [x.clone() for x in state]
    p = [x.clone() for x in state]
    ok = (torch.empty((T, C_, cfg.d), device=dev),
          torch.empty((T, C_), device=dev),
          torch.empty((T, C_), dtype=torch.bool, device=dev))
    op = tuple(torch.empty_like(x) for x in ok)
    fused_step.de_step_rep(cfg, spec, *k, it, out=ok, bits=words, K=K,
                           emit=emit, phase=phase)
    fused_step.de_step_rep_plain(cfg, spec, *p, it, words, op, K, emit,
                                 phase)
    torch.cuda.synchronize()
    _same_bits(tag, ((k[0], p[0], "theta"), (k[1], p[1], "w"),
                     (k[2], p[2], "the gates fire[R]"),
                     (ok[0], op[0], "stored theta"),
                     (ok[1], op[1], "stored w"),
                     (ok[2], op[2], "accept flags")))
    return p, int(op[2].sum())


def _rep_k1_run(tag, step, state, spec, n_bits=8, burnin=4, K=16, it0=1):
    """``n_bits`` bits-in iterations from ``it0`` (the gates set at the
    start; crossing burn-in where they reach it), one on Philox words,
    then (``K``) a window of K on Philox words storing every row (past
    burn-in, the post variant the main path takes there), each against
    the plain version."""
    cfg = step.cfg
    rng_ = np.random.default_rng(cfg.G * cfg.Np + n_bits)
    state[2].fill_(1)
    acc = 0
    t0 = time.perf_counter()
    for it in range(it0, it0 + n_bits):
        words = random_words(rng_, cfg.rows.n_words, cfg.G * cfg.Np,
                             state[0].device)
        state, n = _rep_compare(tag, cfg, spec, state, it, words=words)
        acc += n
    state, n = _rep_compare(tag, cfg, spec, state, it0 + n_bits)
    acc += n
    if K:
        it = it0 + n_bits + 1
        state, n = _rep_compare(tag, cfg, spec, state, it, K=K,
                                phase="post" if it > burnin else "all")
        acc += n
    log(tag, f"{cfg.reps.n_reps} replications x {cfg.reps.c_rep} chains, "
        f"{'local' if cfg.reps.local else 'global'} chain words: "
        f"{n_bits} bits-in iterations from {it0}, one on Philox words"
        + (f", a window of {K}" if K else "")
        + f": bit for bit the plain version ({acc} accepts; "
        f"{time.perf_counter() - t0:.1f} s)")
    return state


def phase_k1_rep(dev):
    """The replicated K1 against its plain version, bit for bit, on the
    Gaussian (the hoisted body; local chain words, and global ones as a
    packed run draws them), LBA (lanes over 100 trials, each
    replication's own trials), the ABC and discrete binomials' data
    tables and the Gaussian MLE's greedy max; at the main paths' shapes
    (``[main-rep]``'s 64 × 4 × 4 on its seeds, local chain words across
    the burn-in switch; ``[main-packed]``'s global words with a window of
    16 past burn-in; ``[main-opt-rep]``'s greedy max at 64 × 2 × 12);
    then each replication's rows of a window of 16 on Philox words bit
    for bit a solo K1 launch on that replication (its model, seed and
    chains)."""
    import dataclasses
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.models import binomial, discrete_binomial
    from demcmc_tpu_torch.models import gaussian, lba
    from demcmc_tpu_torch.ops import fused_step
    data = pc.rep_datasets()
    de = tdm.DE(bounds=gaussian.BOUNDS, Np=4, n_groups=4, burnin=4,
                alpha=0.1)
    gm = [gaussian.make_model(x) for x in data[:16]]
    de0 = dataclasses.replace(de, alpha=0.0)
    for key in (None, 5):
        step, st, spec = _rep_case(gm, de if key is None else de0, dev,
                                   packed_key=key)
        _rep_k1_run("k1-rep-gauss", step, st, spec,
                    K=16 if key is not None else 0)
    # a window needs no inner gate: at α = 0 the plain window checks none
    step, st, spec = _rep_case(gm, de0, dev)
    _rep_k1_run("k1-rep-gauss", step, st, spec, K=16)
    lm = [lba.make(key=r, n_trials=100, Np=16, n_groups=2)[0]
          for r in range(4)]
    _, lde = lba.make(key=0, n_trials=100, Np=16, n_groups=2, burnin=4)
    step, st, spec = _rep_case(lm, lde, dev)
    _rep_k1_run("k1-rep-lba", step, st, spec, n_bits=4, K=0)
    am = []
    for r in range(4):
        m, ade = binomial.make(N=10, k=4 + r, abc=True, fresh_noise=True,
                               n_sim=500, Np=8, n_groups=4, burnin=4)
        am.append(m)
    step, st, spec = _rep_case(am, ade, dev)
    _rep_k1_run("k1-rep-abc", step, st, spec, n_bits=4, K=0)
    # four datasets whose tables of unique counts have one shape (one
    # launch takes data of one shape)
    dm, key = [], 0
    while len(dm) < 4:
        m, dde = discrete_binomial.make(key=key, Np=12, n_groups=2,
                                        burnin=4, dtype=np.float32)
        key += 1
        shape = m.cuda_density.data.shape
        if not dm or shape == dm[0].cuda_density.data.shape:
            dm.append(m)
    step, st, spec = _rep_case(dm, dde, dev)
    _rep_k1_run("k1-rep-discrete", step, st, spec, n_bits=4, K=0)
    ode = tdm.DE(bounds=gaussian.BOUNDS, Np=4, n_groups=4, burnin=4,
                 update_particle="maximize", evaluate_fitness="fun")
    step, st, spec = _rep_case(gm[:8], ode, dev)
    _rep_k1_run("k1-rep-max", step, st, spec, n_bits=4, K=0)

    # the main paths' shapes: [main-rep]'s 64 x 4 x 4 with its seeds and
    # local chain words across the burn-in switch (windows of one, as its
    # gates cut them); [main-packed]'s global chain words on one key with
    # a window past burn-in; [main-opt-rep]'s greedy max at 64 x 2 x 12
    c, o = pc.REP_CELL, pc.OPT_REP_CELL
    full = [gaussian.make_model(x) for x in pc.rep_datasets(c)]
    seeds = rng.replication_seeds(c["key"], c["n_reps"])
    step, st, spec = _rep_case(full, _rep_de(), dev, seeds)
    _rep_k1_run("k1-rep-cell", step, st, spec, n_bits=3, K=1,
                burnin=c["burnin"], it0=c["burnin"] - 1)
    step, st, spec = _rep_case(full, _rep_de(), dev, seeds,
                               packed_key=c["key"])
    _rep_k1_run("k1-rep-cell", step, st, spec, n_bits=1, K=16,
                burnin=c["burnin"], it0=c["burnin"])
    om = [gaussian.make_model(x) for x in pc.opt_rep_datasets(o)]
    step, st, spec = _rep_case(om, _opt_rep_de(), dev,
                               rng.replication_seeds(o["key"], o["n_reps"]))
    _rep_k1_run("k1-rep-cell-max", step, st, spec, n_bits=2, K=0)

    # each replication's rows: a solo K1 launch on its chains
    step, st, spec = _rep_case(gm, de0, dev)
    cfg, reps = step.cfg, step.reps
    K, it0 = 16, 3
    T, C_ = K, cfg.G * cfg.Np
    out = (torch.empty((T, C_, 2), device=dev), torch.empty((T, C_),
                                                            device=dev),
           torch.empty((T, C_), dtype=torch.bool, device=dev))
    k = [x.clone() for x in st]
    fused_step.de_step_rep(cfg, spec, *k, it0, out=out, K=K)
    one = fused_step.StepConfig.make(gm[0], de0, spec)
    Cr = reps.c_rep
    for r in range(reps.n_reps):
        sl = slice(r * Cr, (r + 1) * Cr)
        s = [st[0][sl].clone(), st[1][sl].clone(), st[2][r:r + 1].clone()]
        o = tuple(torch.empty_like(x[:, sl]).contiguous() for x in out)
        solo = fused_step.StepConfig.make(gm[r], de0, spec)
        fused_step.de_step(solo, gm[r], spec, *s, it0, seed=reps.seeds[r],
                           out=o, K=K)
        torch.cuda.synchronize()
        _same_bits(f"k1-rep-solo r={r}", (
            (k[0][sl], s[0], "theta"), (k[1][sl], s[1], "w"),
            (out[0][:, sl], o[0], "stored theta"),
            (out[1][:, sl], o[1], "stored w"),
            (out[2][:, sl], o[2], "accept flags")))
    del one
    log("k1-rep-solo", f"every replication's rows of a window of {K} "
        f"({reps.n_reps} x {Cr} chains) bit for bit a solo K1 launch on "
        f"its model, seed and chains")
    return 0.0


def _np_exchange(theta, w, u, n_act, gum):
    """The exchange in numpy (``tests/test_fused_step.py``'s
    ``_np_migration_oracle``): groups ranked by ``u`` (ties by index),
    the first ``n_act`` ranks' victims (argmax(gum − w), first on ties)
    moved rank r ← rank (r − 1) mod n_act.  theta [G, Np, d]."""
    G_ = theta.shape[0]
    order = np.lexsort((np.arange(G_), u))
    rank = np.empty(G_, int)
    rank[order] = np.arange(G_)
    vid = np.argmax(gum - w, axis=1)
    nt, nw = theta.copy(), w.copy()
    for g in range(G_):
        r = rank[g]
        if r < n_act:
            src = order[(r - 1) % n_act]
            nt[g, vid[g]] = theta[src, vid[src]]
            nw[g, vid[g]] = w[src, vid[src]]
    return nt, nw


def phase_k2_rep(dev):
    """The segmented K2 against its plain version and the per-segment
    oracle (:func:`_np_exchange` on each replication's words), bit for
    bit, at R = 64 replications of 4 groups of 4 (d = 2), in both modes:
    each replication's gate (about half of them set; local and global
    chain words), and a packed window's events (0 to 3 a replication at
    offsets within a window of 64, each on the words of its own
    iteration); ±inf weights in some groups."""
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import fused_step, migration as mig
    R, G_, Np_, d = 64, 4, 4, 2
    Cr = G_ * Np_
    g = np.random.default_rng(9)
    seeds = [int(x) for x in g.integers(0, 2 ** 63, R)]
    theta0 = torch.tensor(g.normal(size=(R * Cr, d)).astype(np.float32),
                          device=dev)
    w0 = torch.tensor(g.normal(size=R * Cr).astype(np.float32), device=dev)
    w0[::37] = -float("inf")
    w0[5::41] = float("inf")
    it = 777
    moved = 0
    for mode in ("fire-local", "fire-global", "events"):
        local = mode == "fire-local"
        fire = events = None
        if mode.startswith("fire"):
            fire = torch.tensor(g.integers(0, 2, R).astype(np.int32),
                                device=dev)
        else:
            ev = np.zeros((64, R), dtype=bool)
            for r in range(R):
                ev[g.choice(64, int(g.integers(0, 4)), replace=False), r] = 1
            events = mig.segment_events(ev, R)
        reps = fused_step.Replicas(tuple(seeds), local, Cr, None, ())
        tk, wk = theta0.clone(), w0.clone()
        tp, wp = theta0.clone(), w0.clone()
        mig.migrate_segments(tk, wk, G_, Np_, reps, it, fire=fire,
                             events=events)
        mig.migrate_segments_plain(tp, wp, G_, Np_, reps, it, fire=fire,
                                   events=events)
        torch.cuda.synchronize()
        _same_bits(f"k2-rep {mode}", ((tk, tp, "theta"), (wk, wp, "w")))
        # the oracle, replication by replication
        tn = theta0.cpu().numpy().reshape(R, G_, Np_, d).copy()
        wn = w0.cpu().numpy().reshape(R, G_, Np_).copy()
        for r in range(R):
            chain0 = 0 if local else r * Cr
            if fire is not None:
                its = [it] if int(fire[r]) else []
                ns = rng.STEP_NS
            else:
                its = [it + int(x) for x in events[1][r, :events[0][r]]]
                ns = rng.PACKED_MIG_NS
            for t in its:
                words = rng.words(seeds[r], t, mig.N_ROWS, Cr, ns=ns,
                                  chain0=chain0)
                u, n_act, gum = mig.draws(words, G_, Np_)
                tn[r], wn[r] = _np_exchange(tn[r], wn[r], u.numpy(),
                                            int(n_act), gum.numpy())
        if not (np.array_equal(tp.cpu().numpy().reshape(tn.shape).view(
                np.int32), tn.view(np.int32)) and np.array_equal(
                wp.cpu().numpy().reshape(wn.shape).view(np.int32),
                wn.view(np.int32))):
            raise AssertionError(f"k2-rep {mode}: the plain version differs "
                                 f"from the per-segment oracle")
        n = int((ints(tk) != ints(theta0)).any(1).sum())
        moved += n
        what = (f"gates {int(fire.sum())}" if fire is not None
                else f"events {int(events[0].sum())}")
        log("k2-rep", f"{mode}: R={R} x G={G_} x Np={Np_}, {what}: "
            f"segmented K2 bit for bit its plain version and the "
            f"per-segment oracle ({n} chains moved)")
    if moved == 0:
        raise AssertionError("k2-rep: no chain moved")
    return 0.0


def _rep_de(cell=None, **kw):
    """The replicated cell's configuration (``port_cells.REP_CELL``)."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian
    c = cell or pc.REP_CELL
    kw = {**dict(Np=c["Np"], n_groups=c["n_groups"], burnin=c["burnin"],
                 alpha=c["alpha"]), **kw}
    return tdm.DE(bounds=gaussian.BOUNDS, **kw)


def _opt_rep_de():
    """The replicated optimization cell's configuration (``port_cells.
    OPT_REP_CELL``: K1's greedy max on the Gaussian's likelihood)."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian
    c = pc.OPT_REP_CELL
    return tdm.DE(bounds=gaussian.BOUNDS, n_groups=c["n_groups"], Np=c["Np"],
                  burnin=0, update_particle="maximize",
                  evaluate_fitness="fun")


def _rep_rhat_child(reps):
    t0 = time.perf_counter()
    rhat = max(float(np.max(ch.rhat())) for ch in reps)
    return rhat, time.perf_counter() - t0


def _rep_gates(tag, reps, data, metrics, key):
    """Each replication's μ and σ posterior means within ``port_cells.
    REP_TOL`` of its own dataset's quadrature; the max R̂ over every
    replication and parameter, in a forked process (:func:`_rhat_gate`'s
    way, applied by :func:`_rhat_results`)."""
    from demcmc_tpu_torch.models import gaussian
    worst, where = 0.0, None
    for r, (ch, x) in enumerate(zip(reps, data)):
        if not np.isfinite(ch.data).all():
            raise AssertionError(f"{tag}: replication {r} has non-finite "
                                 f"draws")
        truth = gaussian.posterior_grid(x)
        for k in ("mu", "sigma"):
            e = abs(float(ch.mean(k)) - truth[k]["mean"])
            if e > worst:
                worst, where = e, (r, k)
    log(tag, f"worst |posterior mean - quadrature| over {len(reps)} "
        f"replications: {worst:.5f} (replication {where[0]}, {where[1]}; "
        f"gate {pc.REP_TOL})")
    if not worst < pc.REP_TOL:
        raise AssertionError(f"{tag}: a replication's posterior is off its "
                             f"oracle")
    metrics[key + "_worst_mean_err"] = worst
    _RHAT_JOBS.append((tag, key + "_rhat_max",
                       _forked(_rep_rhat_child, reps),
                       (len(reps),) + reps[0].data.shape))


def phase_main_rep(dev):
    """``sample_replicated`` at ``bench.py:133-161``'s width
    (``port_cells.REP_CELL``: 64 Gaussian datasets, 4 × 4 chains each,
    burn-in 100, α = 0.1): launches exactly as the plan over the 64
    replications' gates says (windows per iteration logged), replications
    0, 31 and 63 bit for bit their solo ``sample()``, every replication's
    posterior against its quadrature, max R̂; then the 64 replications
    run in turn through ``sample()``, wall time against the batch's."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.models import gaussian
    c = pc.REP_CELL
    data, de, n_iter = pc.rep_datasets(c), _rep_de(), c["n_iter"]
    seeds = rng.replication_seeds(c["key"], c["n_reps"])
    tdm.sample_replicated(gaussian.make_model, de, 2 * de.burnin,
                          data[:2], key=c["key"])        # warm the loader
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    reps = tdm.sample_replicated(gaussian.make_model, de, n_iter, data,
                                 key=c["key"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    want = plan_counts(gaussian.make_model(data[0]), de, n_iter, seeds)
    log("main-rep", f"launches {launches} (the plan over the "
        f"{c['n_reps']} replications' gates: {want}); "
        f"{want['de_step_rep'] / n_iter:.4f} K1 windows and "
        f"{want['migrate_segments'] / n_iter:.4f} K2 launches per "
        f"iteration (a window ends where any replication's gate opens)")
    _counts(**want)
    R = c["n_reps"]
    for r in (0, R // 2 - 1, R - 1):
        solo = tdm.sample(gaussian.make_model(data[r]), de, n_iter,
                          key=seeds[r])
        _same_draws("main-rep", reps[r], solo, f"replication {r} and its "
                    f"solo sample()")
    log("main-rep", f"replications 0, {R // 2 - 1} and {R - 1} bit for bit "
        f"their solo sample()")
    metrics = {"main_rep_wall_s": wall,
               "main_rep_us_per_iteration": wall / n_iter * 1e6}
    _rep_gates("main-rep", reps, data, metrics, "main_rep")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(c["n_reps"]):
        tdm.sample(gaussian.make_model(data[r]), de, n_iter, key=seeds[r])
    torch.cuda.synchronize()
    turn = time.perf_counter() - t0
    log("main-rep", f"{c['n_reps']} replications x {n_iter} iterations: "
        f"one batch {wall:.3f} s, in turn through sample() {turn:.3f} s "
        f"({turn / wall:.2f}x)")
    metrics["main_rep_in_turn_s"] = turn
    return reps, launches, metrics


def phase_main_packed(dev):
    """``sample_replicated_packed`` on the same cell: K1 windows of
    ``SUPER_K`` (cut at the burn-in switch), one segmented K2 before each
    window that holds an event (the events from ``key``), the posterior
    and R̂ gates."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.models import gaussian
    c = pc.REP_CELL
    data, de, n_iter = pc.rep_datasets(c), _rep_de(), c["n_iter"]
    seeds = rng.replication_seeds(c["key"], c["n_reps"])
    _reset_counts()
    t0 = time.perf_counter()
    reps = tdm.sample_replicated_packed(gaussian.make_model, de, n_iter,
                                        data, key=c["key"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    want = plan_counts(gaussian.make_model(data[0]), de, n_iter, seeds,
                       packed_key=c["key"])
    log("main-packed", f"launches {launches} (windows of SUPER_K and the "
        f"events' plan: {want}); {wall / n_iter * 1e6:.2f} us/iteration "
        f"on the host clock")
    _counts(**want)
    metrics = {"main_packed_wall_s": wall,
               "main_packed_us_per_iteration": wall / n_iter * 1e6}
    _rep_gates("main-packed", reps, data, metrics, "main_packed")
    return launches, metrics


def phase_main_opt_rep(dev):
    """``optimize_replicated`` through K1's greedy max at
    ``tests/test_replicated.py:105-131``'s width (``port_cells.
    OPT_REP_CELL``: G = 2, Np = 12, 60 observations, 1,500 iterations) on
    64 datasets: launches as the plan, replications 0, 31 and 63 bit for
    bit their solo ``optimize()``, each MLE within ``port_cells.
    OPT_REP_TOL`` of its dataset's mean and sd (ddof 0)."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.models import gaussian
    c = pc.OPT_REP_CELL
    data, de = pc.opt_rep_datasets(c), _opt_rep_de()
    seeds = rng.replication_seeds(c["key"], c["n_reps"])
    _reset_counts()
    t0 = time.perf_counter()
    pops = tdm.optimize_replicated(gaussian.make_model, de, c["n_iter"],
                                   data, key=c["key"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = plan_counts(gaussian.make_model(data[0]), de, c["n_iter"], seeds)
    launches = _counts()
    log("main-opt-rep", f"launches {launches} (the plan: {want}); "
        f"{wall:.3f} s")
    _counts(**want)
    R = c["n_reps"]
    for r in (0, R // 2 - 1, R - 1):
        solo = tdm.optimize(gaussian.make_model(data[r]), de, c["n_iter"],
                            key=seeds[r])
        for x, y, what in ((pops[r].theta, solo.theta, "theta"),
                           (pops[r].weight, solo.weight, "weight")):
            x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
            if x.shape != y.shape or x.tobytes() != y.tobytes():
                raise AssertionError(f"main-opt-rep: replication {r}'s "
                                     f"{what} differ from its solo "
                                     f"optimize()")
    log("main-opt-rep", f"replications 0, {R // 2 - 1} and {R - 1} bit for "
        f"bit their solo optimize()")
    worst = 0.0
    for r, pop in enumerate(pops):
        theta, _ = tdm.get_optimal(de, gaussian.make_model(data[r]), pop)
        _, rows = pc.mle_gate(float(theta["mu"]), float(theta["sigma"]),
                              data[r], c.get("tol", pc.OPT_REP_TOL))
        worst = max(worst, *(abs(a - b) for a, b in rows.values()))
    log("main-opt-rep", f"worst |MLE - closed form| over {len(pops)} "
        f"datasets: {worst:.3g} (gate {pc.OPT_REP_TOL})")
    if not worst <= pc.OPT_REP_TOL:
        raise AssertionError("main-opt-rep: an MLE is off its closed form")
    return {"main_opt_rep_wall_s": wall, "main_opt_rep_worst_err": worst,
            "main_opt_rep_launches": launches}


def phase_main_rep_mesh(dev, reps):
    """``[main-rep]`` with ``mesh=chain_mesh(devices=[cuda:0] * 4)``: 16
    whole replications a shard, every replication bit for bit the
    unsharded run's, each shard's launches its own plan's (its windows cut
    at its own replications' gates)."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.models import gaussian
    c = pc.REP_CELL
    data, de, n_iter = pc.rep_datasets(c), _rep_de(), c["n_iter"]
    seeds = rng.replication_seeds(c["key"], c["n_reps"])
    mesh = tdm.parallel.chain_mesh(devices=[dev] * 4)
    _reset_counts()
    t0 = time.perf_counter()
    got = tdm.sample_replicated(gaussian.make_model, de, n_iter, data,
                                key=c["key"], mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    model, n = gaussian.make_model(data[0]), c["n_reps"] // 4
    plans = [plan_counts(model, de, n_iter, seeds[i:i + n])
             for i in range(0, c["n_reps"], n)]
    want = {k: sum(p[k] for p in plans) for k in plans[0]}
    launches = _counts()
    log("main-rep-mesh", f"launches {launches} (each shard's plan over its "
        f"own {n} replications' gates, summed: {want}); {wall:.3f} s")
    _counts(**want)
    for r in range(c["n_reps"]):
        _same_draws("main-rep-mesh", got[r], reps[r],
                    f"replication {r} and the unsharded run")
    log("main-rep-mesh", f"all {c['n_reps']} replications bit for bit the "
        f"unsharded run")
    return {"main_rep_mesh_wall_s": wall}


def _trace_rep(tag, run, n_iter, want, fname):
    """``run()`` under ``torch.profiler``: the replicated K1 and the
    segmented K2 in the device trace as often as ``want`` says; µs per
    iteration on the host clock, kernel launches per iteration and the
    device's idle share from the first to the last launch of the two."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    OUT.mkdir(exist_ok=True)
    path = OUT / fname
    prof.export_chrome_trace(str(path))
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") in
          ("kernel", "gpu_memcpy", "gpu_memset")]
    path.unlink()          # tens of MB: the numbers are logged
    spans = {k: [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                 for e in ev if e["cat"] == "kernel" and x in e["name"]]
             for k, x in (("de_step_rep", REP_NAME),
                          ("migrate_segments", REP_K2_NAME))}
    counts = {k: len(v) for k, v in spans.items()}
    if counts != {k: want.get(k, 0) for k in counts}:
        raise AssertionError(f"{tag}: traced launches {counts}, expected "
                             f"{want}")
    ours = [sp for v in spans.values() for sp in v]
    lo, hi = min(a for a, _ in ours), max(b for _, b in ours)
    every = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
             for e in ev]
    busy = _busy(every, lo, hi)
    n_kernels = sum(1 for e in ev if e["cat"] == "kernel")
    out = {"traced_us_per_iteration": wall / n_iter * 1e6,
           "launches_per_iteration": n_kernels / n_iter,
           "k1_k2_launches_per_iteration": sum(counts.values()) / n_iter,
           "span_us_per_iteration": (hi - lo) / n_iter,
           "span_busy_us_per_iteration": busy / n_iter,
           "span_idle_share": 1.0 - busy / (hi - lo)}
    mean = {k: sum(b - a for a, b in v) / max(len(v), 1)
            for k, v in spans.items()}
    log(tag, f"traced: {out['traced_us_per_iteration']:.2f} us/iteration "
        f"on the host clock; first to last launch "
        f"{out['span_us_per_iteration']:.2f} us/iteration on the device "
        f"clock, busy {out['span_busy_us_per_iteration']:.3f}, idle share "
        f"{out['span_idle_share']:.4f}; {counts} ("
        f"{out['k1_k2_launches_per_iteration']:.4f} an iteration; every "
        f"kernel of the call, the replications' set-up included, "
        f"{out['launches_per_iteration']:.4f}); "
        f"mean traced time a launch: " + ", ".join(
            f"{k} {v:.3f} us" for k, v in mean.items()))
    return out


REP_TRACE_ITER = 2100      # the traced replicated runs: past burn-in


def phase_trace_rep(dev):
    """``[main-rep]`` and ``[main-packed]`` (``REP_TRACE_ITER``
    iterations) under ``torch.profiler``: µs per iteration, launches per
    iteration, the idle share."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.models import gaussian
    c = pc.REP_CELL
    data, de, n = pc.rep_datasets(c), _rep_de(), REP_TRACE_ITER
    seeds = rng.replication_seeds(c["key"], c["n_reps"])
    out = {}
    for tag, packed in (("trace-rep", None), ("trace-packed", c["key"])):
        want = plan_counts(gaussian.make_model(data[0]), de, n, seeds,
                           packed_key=packed)
        if packed is None:
            def run():
                tdm.sample_replicated(gaussian.make_model, de, n, data,
                                      key=c["key"])
        else:
            def run():
                tdm.sample_replicated_packed(gaussian.make_model, de, n,
                                             data, key=c["key"])
        out.update({f"{tag.replace('-', '_')}_{k}": v for k, v in
                    _trace_rep(tag, run, n, want,
                               f"{tag}.json").items()})
    return out


def phase_timing10(dev, launches, errs):
    """The replicated K1's device ms per launch at ``[main-rep]``'s shape
    (64 replications × 16 chains; one iteration, as its windows mostly
    are, past burn-in and in it; and a window of 64 past burn-in, the
    packed run's), and the segmented K2's with 7 of 64 replications'
    gates open (≈ α R, as an iteration of ``[main-rep]``), beside their
    plain versions (plain, kernel, kernel, plain) and their bounds: each
    replication's :func:`_step_work` on its own words plus the table's
    bytes; K2, :func:`_exchange_work` of each fired replication plus the
    gates read."""
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.models import gaussian
    from demcmc_tpu_torch.ops import fused_step, migration as mig
    c = pc.REP_CELL
    data, de = pc.rep_datasets(c), _rep_de()
    models = [gaussian.make_model(x) for x in data]
    step, st, spec = _rep_case(models, de, dev, rng.replication_seeds(
        c["key"], c["n_reps"]))
    cfg, reps = step.cfg, step.reps
    theta, w, fire = st
    R, Cr, C_ = reps.n_reps, reps.c_rep, cfg.G * cfg.Np
    out = (torch.empty((1, C_, 2), device=dev), torch.empty((1, C_),
                                                            device=dev),
           torch.empty((1, C_), dtype=torch.bool, device=dev))
    it, it_b, K = 2000, 50, fused_step.super_k()
    fired = torch.zeros(R, dtype=torch.int32, device=dev)
    fired[::10] = 1
    n_fired = int(fired.sum())

    def k1():
        fused_step.de_step_rep(cfg, spec, theta, w, fire, it, out=out,
                               check=False, phase="post")

    def k1_plain():
        fused_step.de_step_rep_plain(cfg, spec, theta, w, fire, it, None,
                                     out, phase="post")

    def k1_burnin():
        fused_step.de_step_rep(cfg, spec, theta, w, fire, it_b, out=out,
                               check=False)

    def k1_window():
        fused_step.de_step_rep(cfg, spec, theta, w, fire, it, check=False,
                               K=K, emit=(K, 1), phase="post")

    def k2():
        mig.migrate_segments(theta, w, de.n_groups, de.Np, reps, it,
                             fire=fired, check=False)

    def k2_plain():
        mig.migrate_segments_plain(theta, w, de.n_groups, de.Np, reps, it,
                                   fire=fired)

    t = {}
    for name, fn, n in (("k1_plain", k1_plain, 2), ("k1", k1, 200),
                        ("k1", k1, 200), ("k1_plain", k1_plain, 2),
                        ("k1_burnin", k1_burnin, 200),
                        ("k1_window", k1_window, 20),
                        ("k1_window", k1_window, 20),
                        ("k2_plain", k2_plain, 2), ("k2", k2, 200),
                        ("k2", k2, 200), ("k2_plain", k2_plain, 2)):
        t.setdefault(name, []).append(device_ms(fn, n))
    ms = {k: float(np.mean([x_ for x_, _, _ in v])) for k, v in t.items()}
    for k, v in t.items():
        log("timing10", f"{k}: {ms[k]:.6f} ms per call on the device ("
            + ", ".join(f"{x_:.6f}{'' if q else ' host-gapped'}"
                        for x_, q, _ in v) + ")")
    log("timing10", f"replicated K1 window of {K} past burn-in: "
        f"{ms['k1_window'] / K * 1e3:.3f} us per iteration; one iteration "
        f"in burn-in {ms['k1_burnin']:.6f} ms")
    one = fused_step.solo_config(cfg)
    k1_bytes = k1_ops = 0
    for r in range(R):
        words = rng.words(reps.seeds[r], it, cfg.rows.n_words, Cr,
                          device=dev)
        b, o = _step_work(one, words, GAUSS_F32_OPS)
        k1_bytes, k1_ops = k1_bytes + b, k1_ops + o
    k1_bytes += R * (len(models[0].cuda_density.params) * 4 + 8)
    k2_bytes, k2_ops = _exchange_work(de.n_groups, de.Np, 2)
    k2_bytes, k2_ops = n_fired * k2_bytes + 4 * R + 8 * R, n_fired * k2_ops
    rows = []
    for name, src, repl, key, nbytes, nops, plain, n in (
            (f"de_step_rep/gaussian-{R}x{Cr}",
             "demcmc_tpu_torch/csrc/de_step_rep.cu",
             "demcmc_tpu/ops/fused_step.py:1858", "k1", k1_bytes, k1_ops,
             "k1_plain", launches["de_step_rep"]),
            (f"migrate_segments/{R}x{de.n_groups}x{de.Np}-fired-{n_fired}",
             "demcmc_tpu_torch/csrc/migration.cu",
             "demcmc_tpu/ops/fused_step.py:1144", "k2", k2_bytes, k2_ops,
             "k2_plain", launches["migrate_segments"])):
        tb, to = nbytes / PEAK_BYTES * 1e3, nops / PEAK_OPS * 1e3
        log("timing10", f"{name}: {nbytes} bytes, {nops} operations, bound "
            f"{max(tb, to):.4g} ms ({'bytes' if tb >= to else 'operations'}"
            f"); at {max(tb, to) / ms[key]:.3f} of its bound")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": n,
                     "max_abs_err": errs.get(key + "_rep", 0.0),
                     "ms": ms[key], "plain_ms": ms[plain],
                     "bound_ms": max(tb, to),
                     "bound_by": "bytes" if tb >= to else "operations",
                     "library_ms": None})
    return rows


# ------------------------------------------- sixteenth slice: multi-GPU
# finished (DE-MCz under a mesh, the data axis, several processes; F7)


DIST_TIMEOUT = 420          # seconds a torchrun of tools/dist_cards.py may
                            # take (about 60 s on one card)


def phase_k3_shard(dev):
    """K3 with ``chain0`` on each of 4 shards of the mcz-mig population (C
    = 512, G = 128 × Np = 4, α = 0.1, θs = 0.1), each on its own copy of
    the population's history, against its plain version on the same
    shard and against the shard's slice of a launch on the whole
    population, bit for bit (θ, w, trajectory row, accept flags, gate and
    the history row): 8 bits-in iterations (every shard reads its columns
    of the population's words, its own of the index buffer) crossing
    burn-in, the gate forced open at two, then one on Philox words.  Each
    shard writes its own columns of row ``it − 1`` and no other; between
    iterations every copy takes the population's row, as the mesh's
    exchange gives it.  Returns the largest |difference|."""
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import fused_step, resample_step as tres
    it0 = pc.MCZ_MIG_CELL["n_initial"] + 1
    model, de, spec, cfg, s = _mcz_mig_case(
        dev, "C512", burnin=it0 + 3,
        theta_sn=pc.MCZ_MIG_CELL["theta_snooker"], extra_rows=20)
    C_, Np_ = de.n_chains, de.Np
    full = [s.theta, s.weight, torch.ones(1, dtype=torch.int32, device=dev),
            s.history]

    def slot(n):
        return (torch.empty((n, D), device=dev), torch.empty(n, device=dev),
                torch.empty(n, dtype=torch.bool, device=dev))
    shards = []
    for g0, n in fused_step.shard_groups(de.n_groups, 4):
        a, b = g0 * Np_, (g0 + n) * Np_
        k = [full[0][a:b].clone(), full[1][a:b].clone(), full[2].clone(),
             full[3].clone()]
        shards.append((fused_step.local_config(cfg, n), a, b, k,
                       [x.clone() for x in k]))
    gen = np.random.default_rng(12)
    fires, worst = set(), 0.0
    for i in range(9):
        it = it0 + i
        words = idx = None
        if i < 8:
            words = random_words(gen, cfg.rows.n_words, C_, dev)
            if i in (2, 5):                  # open the next iteration's gate
                words[cfg.rows.fire, 0] = 0
            idx = tres.indices_from_words(cfg, random_words(
                gen, tres.index_rows(cfg), C_, dev), it)
        before = full[3][it - 1].clone()
        of = slot(C_)
        tres.resample_step(cfg, model, spec, *full, it, seed=77, bits=words,
                           idx=idx, out=of)
        for scfg, a, b, k, p in shards:
            ok, op = slot(b - a), slot(b - a)
            sidx = None if idx is None else idx[:, a:b].contiguous()
            tres.resample_step(scfg, model, spec, *k, it, seed=77,
                               bits=words, idx=sidx, out=ok, chain0=a)
            pw = words if words is not None else rng.words(
                77, it, cfg.rows.n_words, b, device=dev)
            pidx = sidx if sidx is not None else tres.indices(
                scfg, 77, it, device=dev, chain0=a, n_pop=C_)
            tres.resample_step_plain(scfg, model, spec, *p, it, pw, pidx,
                                     out=op, chain0=a)
            torch.cuda.synchronize()
            for x, y, z, what in (
                    (k[0], p[0], full[0][a:b], "theta"),
                    (k[1], p[1], full[1][a:b], "w"),
                    (k[2], p[2], full[2], "gate"),
                    (k[3][it - 1, a:b], p[3][it - 1, a:b],
                     full[3][it - 1, a:b], "history row"),
                    (ok[0], op[0], of[0][a:b], "trajectory theta"),
                    (ok[1], op[1], of[1][a:b], "trajectory w"),
                    (ok[2].view(torch.uint8), op[2].view(torch.uint8),
                     of[2][a:b].view(torch.uint8), "accept flags")):
                if x.dtype != torch.uint8:
                    worst = max(worst, float((x - y).abs().max()),
                                float((x - z).abs().max()))
                x, y, z = (t if t.dtype == torch.uint8 else ints(t)
                           for t in (x, y, z))
                if not torch.equal(x, y):
                    raise AssertionError(f"k3-shard: {what} of the shard "
                                         f"from chain {a} differs from the "
                                         f"plain version at it={it}")
                if not torch.equal(x, z):
                    raise AssertionError(f"k3-shard: {what} of the shard "
                                         f"from chain {a} differs from the "
                                         f"whole population's at it={it}")
            for h in (k[3], p[3]):
                rest = torch.ones(C_, dtype=torch.bool, device=dev)
                rest[a:b] = False
                if not torch.equal(ints(h[it - 1][rest]),
                                   ints(before[rest])):
                    raise AssertionError(f"k3-shard: the shard from chain "
                                         f"{a} wrote other shards' history "
                                         f"columns at it={it}")
                h[it - 1].copy_(full[3][it - 1])
        fires.add(int(full[2][0]))
        log("k3-shard", f"{'bits-in' if i < 8 else 'Philox'} it={it} "
            f"({'burn-in' if it <= it0 + 3 else 'sampling'}): 4 shards of "
            f"{C_ // 4} chains equal their plain versions and the whole "
            f"population's launch bit for bit, history columns their own; "
            f"gate {int(full[2][0])}")
    if fires != {0, 1}:
        raise AssertionError(f"k3-shard: the gate took only {fires}")
    return worst


def phase_main_mesh_mcz(dev, cards=None, tag="main-mesh-mcz"):
    """DE-MCz under a chain mesh of the card or, given ``cards``, of the
    first D of them (:func:`_mesh_runs`; ``tools/mesh_cards.py``: a
    history replica a card, the rows copied between cards): the mcz-mig
    cell (``port_cells.MCZ_MIG_CELL``, 5,000 iterations, α = 0.1) and the
    two-block DE-MCz Gaussian (C = 512, the blocks (μ), (σ), 300
    iterations) on 1, 2 and 4 shards, each sharded run bit for bit the
    unsharded one (draws, final state and history), K3 once per iteration
    and shard, K2 once per open gate.  Returns each cell's launches by
    shard count, and the metrics."""
    from demcmc_tpu_torch.models import gaussian
    cell = pc.MCZ_MIG_CELL
    model, de = gaussian.make(
        data=_gauss_data(), n_groups=cell["n_groups"], Np=cell["Np"],
        alpha=cell["alpha"], sample="resample", n_initial=cell["n_initial"],
        burnin=cell["burnin"], theta_snooker=cell["theta_snooker"],
        sweep="sync")
    out, launches = {}, {}
    shards = tuple(D for D in MESH_SHARDS if cards is None or D <= len(cards))
    m, launches["mcz"] = _mesh_runs(tag, dev, model, de, cell["n_iter"], 0,
                                    shards, cards=cards)
    if not launches["mcz"][1]["migrate"]:
        raise AssertionError(f"{tag}: no gate opened")
    out.update({"mesh_mcz_" + k: v for k, v in m.items()})
    _, model, de = next(c for c in _blocked_cases(150)
                        if c[0] == "mcz-C512")
    m, launches["blocks"] = _mesh_runs(tag + "-blocks", dev, model, de, 300,
                                       0, shards, cards=cards)
    out.update({"mesh_mcz_blocks_" + k: v for k, v in m.items()})
    return launches, out


def _no_launches(tag):
    """Raise if any kernel of the port launched since the counts' reset."""
    got = _counts()
    if any(got.values()):
        raise AssertionError(f"{tag}: launches {got}, expected none")


def _piecewise_twin(model, loglike, pieces, data):
    """``model`` on unsharded ``data`` with a loglike that sums
    ``loglike(piece)`` over ``pieces`` in order: a data-mesh run's
    arithmetic on one device."""
    from demcmc_tpu_torch.model import DEModel

    def summed(_, *params):
        total = None
        for p in pieces:
            part = loglike(p, *params)
            total = part if total is None else total + part
        return total
    return DEModel(loglike_batched=summed,
                   prior_loglike_batched=model.prior_loglike_batched,
                   sample_prior=model.sample_prior, names=model.names,
                   data=data)


def _data_mesh_run(tag, dev, model, twin, de, n_iter, mesh):
    """The data-mesh run and its piecewise-sum twin (unsharded), bit for
    bit, no kernel of the port launched; returns the chains and the µs
    per iteration of both."""
    import demcmc_tpu_torch as tdm
    secs, runs = {}, {}
    for name, kw in (("mesh", {"mesh": mesh}), ("twin", {"device": dev})):
        m = model if name == "mesh" else twin
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            runs[name] = tdm.sample(m, de, n_iter, key=0, return_state=True,
                                    **kw)
        torch.cuda.synchronize()
        secs[name] = (time.perf_counter() - t0) / n_iter * 1e6
        _no_launches(f"{tag} ({name})")
    _same_run(tag, runs["mesh"], runs["twin"],
              between="the data-mesh run and its piecewise-sum twin")
    log(tag, f"{n_iter} iterations on a {mesh.shape} mesh: "
        f"{secs['mesh']:.2f} us/iteration, the unsharded twin "
        f"{secs['twin']:.2f}; bit for bit; no kernel of the port launched")
    return runs["mesh"][0], secs


def _placed(tag, sd, mesh):
    """Raise unless piece j of every chain row of ``sd`` is a tensor on
    data column j's device of that row."""
    for i in range(mesh.devices.shape[0]):
        for j, p in enumerate(sd.row(i).pieces):
            for t in (p if isinstance(p, tuple) else (p,)):
                if t.device != mesh.devices[i, j]:
                    raise AssertionError(f"{tag}: piece {j} of chain row "
                                         f"{i} on {t.device}, not "
                                         f"{mesh.devices[i, j]}")


def phase_main_data_mesh(dev, cards=None, tag="main-data-mesh"):
    """The data axis: the 4,096-chain bench Gaussian (50 observations,
    3,000 iterations) on ``data_mesh(2, 2)`` and LBA at 4,096 chains (100
    trials, 128 iterations) on ``data_mesh(2, 4)``, over ``dev`` repeated
    or, given ``cards``, over them in row-major order (repeated to fill
    the mesh); each piece a tensor on its data column's device, each run
    bit for bit its piecewise-sum twin on ``dev`` (:func:`_data_mesh_run`,
    the same pieces copied to the host); the Gaussian within 0.01 of the
    quadrature with max R̂ < 1.01."""
    from demcmc_tpu_torch import parallel
    from demcmc_tpu_torch.models import gaussian, lba
    from demcmc_tpu_torch.parallel.mesh import host

    def grid(n):
        return [dev] * n if cards is None else (list(cards) * n)[:n]
    data = _gauss_data()
    mesh = parallel.data_mesh(2, 2, devices=grid(4))
    sd = parallel.shard_data(data, mesh)
    _placed(tag + "-gauss", sd, mesh)
    model, de = gaussian.make(data=sd, Np=NP, n_groups=G, burnin=BURNIN)
    twin = _piecewise_twin(model, gaussian.loglike_batched,
                           [host(p) for p in sd.pieces], data)
    chains, secs = _data_mesh_run(tag + "-gauss", dev, model, twin,
                                  de, N_ITER, mesh)
    rhat, acc = _posterior_gate(tag + "-gauss", chains, data,
                                N_ITER - BURNIN, de.n_chains)
    out = {"data_mesh_gauss_us_per_iteration": secs["mesh"],
           "data_mesh_gauss_twin_us_per_iteration": secs["twin"],
           "data_mesh_gauss_rhat_max": rhat,
           "data_mesh_gauss_acceptance": acc}
    lmodel, lde = _lba_case(MESH_SHORT // 2)
    mesh = parallel.data_mesh(2, 4, devices=grid(8))
    sd = parallel.shard_data(lmodel.data, mesh)
    _placed(tag + "-lba", sd, mesh)
    model = lba.make_model(sd)
    _placed(tag + "-lba", model.data, mesh)
    twin = _piecewise_twin(model, lba.loglike_batched,
                           [host(p) for p in sd.pieces], lmodel.data)
    _, secs = _data_mesh_run(tag + "-lba", dev, model, twin, lde,
                             MESH_SHORT, mesh)
    out.update({"data_mesh_lba_us_per_iteration": secs["mesh"],
                "data_mesh_lba_twin_us_per_iteration": secs["twin"]})
    return out


def _dist_run(tag, n_proc, *args):
    """``tools/dist_cards.py`` under torchrun with ``n_proc`` processes;
    at the time limit torchrun is asked to stop (it ends its ranks, each
    in a session of its own, then exits), and killed 30 s later.  Raises
    unless it exits 0.  Returns the ranks' results."""
    script = Path(__file__).resolve().parent / "tools" / "dist_cards.py"
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n_proc}", str(script), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=DIST_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
        raise AssertionError(f"{tag}: tools/dist_cards.py ran past "
                             f"{DIST_TIMEOUT} s")
    OUT.mkdir(exist_ok=True)
    (OUT / f"{tag}.log").write_text(out + err)
    if proc.returncode:
        raise AssertionError(f"{tag}: tools/dist_cards.py exited "
                             f"{proc.returncode}:\n{out[-3000:]}\n"
                             f"{err[-3000:]}")
    lines = [x for x in out.splitlines() if x.startswith("DIST ")]
    for x in out.splitlines():
        if x.startswith("[dist rank"):
            log(tag, x)
    log(tag, f"{n_proc} processes in {time.perf_counter() - t0:.1f} s "
        f"(log in chiprun_out/{tag}.log)")
    return json.loads(lines[0][5:])["ranks"]


def phase_main_dist(dev):
    """Several processes through ``global_chain_mesh()``
    (``tools/dist_cards.py``): 2 processes on the one card (gloo, θ, w
    and history rows staged through pinned memory) and, with 2 cards or
    more, 2 processes with a card each (NCCL): the 4,096-chain Gaussian
    (kernels' step, α = 0.1) and the mcz-mig cell, every rank's result bit
    for bit the single-process run, its launches as planned.  Returns the
    metrics."""
    out = {}
    runs = [("main-dist-gloo", ("--backend", "gloo", "--device",
                                f"cuda:{dev.index or 0}"))]
    if torch.cuda.device_count() >= 2:
        runs.append(("main-dist-nccl", ()))
    for tag, args in runs:
        ranks = _dist_run(tag, 2, *args)
        r0 = ranks[0]
        log(tag, f"backend {r0['backend']}"
            f"{' (staged)' if r0['staged'] else ''} over "
            f"{r0['devices']}")
        for cell in ("gauss", "mcz-mig"):
            key = f"{tag[5:]}_{cell}".replace("-", "_")
            out[key + "_one_us_per_iteration"] = r0[cell][
                "one_us_per_iteration"]
            out[key + "_us_per_iteration"] = max(
                r[cell]["group_us_per_iteration"] for r in ranks)
    return out


def phase_rep_f7(dev):
    """Fault F7 on the card: two replications of the bench Gaussian (G =
    256, Np = 16, α = 0.1) through ``sample_replicated`` run in turn (no
    replicated K1, no segmented K2), each bit for bit its solo
    ``sample()``, K1 and K2 launched as their solo plans say;
    ``sample_replicated_packed`` raises its ``ValueError`` before any
    launch."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian
    datasets = np.stack([_gauss_data(), np.random.default_rng(1)
                         .standard_normal(50).astype(np.float32)])
    _, de = gaussian.make(Np=NP, n_groups=G, burnin=BURNIN)
    models = [gaussian.make_model(x) for x in datasets]
    if tdm.sampler.rep_supported(models, de, dev):
        raise AssertionError("rep-f7: a replicated batch at 4,096 chains a "
                             "replication")
    keys = [0, 1]
    _reset_counts()
    reps = tdm.sample_replicated(gaussian.make_model, de, N_ITER, datasets,
                                 keys=keys)
    torch.cuda.synchronize()
    want = {"de_step": 0, "migrate": 0}
    for m, k in zip(models, keys):
        plan = plan_counts(m, de, N_ITER, k)
        want = {x: want[x] + plan[x] for x in want}
    _counts(**want)
    for r, (m, k) in enumerate(zip(models, keys)):
        solo = tdm.sample(m, de, N_ITER, key=k)
        _same_draws(f"rep-f7 replication {r}", reps[r], solo,
                    "sample_replicated and the solo sample()")
    _reset_counts()
    try:
        tdm.sample_replicated_packed(gaussian.make_model, de, N_ITER,
                                     datasets, key=0)
    except ValueError as e:
        if "use sample_replicated" not in str(e):
            raise
    else:
        raise AssertionError("rep-f7: the packed run did not raise")
    _no_launches("rep-f7 (packed)")
    log("rep-f7", f"two replications of {de.n_chains} chains (α = "
        f"{de.alpha}) ran in turn, each bit for bit its solo sample(); "
        f"launches {want} (no de_step_rep, no migrate_segments); the packed "
        f"run raised before any launch")
    return {"rep_f7_launches": want}


def phase_timing11(dev, launches, errs):
    """K3 on one shard of 4 of the mcz-mig population (the second: 128
    chains from chain 128, one iteration past burn-in, on the
    population's history) beside its plain version (plain, kernel,
    kernel, plain) and its bound (:func:`_step_work` on the shard's
    words): row 3B-shard, with the launches of ``[main-mesh-mcz]``'s
    4-shard run."""
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import fused_step, resample_step as tres
    cell = pc.MCZ_MIG_CELL
    it = 2000
    model, de, spec, cfg, s = _mcz_mig_case(
        dev, "C512", burnin=cell["burnin"], theta_sn=cell["theta_snooker"],
        extra_rows=it)
    C_, Np_ = de.n_chains, de.Np
    g0, n = fused_step.shard_groups(de.n_groups, 4)[1]
    scfg, c0, c = fused_step.local_config(cfg, n), g0 * Np_, n * Np_
    th, w = s.theta[c0:c0 + c].clone(), s.weight[c0:c0 + c].clone()
    fire, hist = s.fire.clone(), s.history
    out = (torch.empty((c, D), device=dev), torch.empty(c, device=dev),
           torch.empty(c, dtype=torch.bool, device=dev))
    words = rng.words(0, it, cfg.rows.n_words, c0 + c, device=dev)
    idx = tres.indices(scfg, 0, it, device=dev, chain0=c0, n_pop=C_)

    def k3():
        tres.resample_step(scfg, model, spec, th, w, fire, hist, it, out=out,
                           check=False, phase="post", chain0=c0)

    def k3_plain():
        tres.resample_step_plain(scfg, model, spec, th, w, fire, hist, it,
                                 words, idx, out, phase="post", chain0=c0)

    t = {}
    for name, fn, nn in (("plain", k3_plain, 2), ("k3", k3, 200),
                         ("k3", k3, 200), ("plain", k3_plain, 2)):
        t.setdefault(name, []).append(device_ms(fn, nn))
    ms = {k: float(np.mean([x for x, _, _ in v])) for k, v in t.items()}
    for k, v in t.items():
        log("timing11", f"{k}: {ms[k]:.6f} ms per call on the device ("
            + ", ".join(f"{x:.6f}{'' if q else ' host-gapped'}"
                        for x, q, _ in v) + ")")
    nbytes, ops = _step_work(scfg, rng.words(0, it, cfg.rows.n_words, c,
                                             device=dev, chain0=c0),
                             GAUSS_F32_OPS)
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS * 1e3
    log("timing11", f"resample_step/shard: {ms['k3']:.6f} ms against a bound "
        f"of {max(tb, to):.3g} ms ({nbytes} bytes, {ops} operations); plain "
        f"{ms['plain']:.6f} ms")
    return [{"name": f"resample_step/shard-{c}of{C_}", "route": "cuda",
             "source": "demcmc_tpu_torch/csrc/de_step_resample.cu",
             "replaces": "demcmc_tpu/ops/fused_step.py:2224",
             "launches": launches["mcz"][4]["resample_step"],
             "max_abs_err": errs["k3_shard"], "ms": ms["k3"],
             "plain_ms": ms["plain"], "bound_ms": max(tb, to),
             "bound_by": "bytes" if tb >= to else "operations",
             "library_ms": None}]


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; "
                 "this script needs an NVIDIA GPU")
    import demcmc_tpu_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda")
    log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    took = {}

    def run(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        took[phase.__name__[len("phase_"):]] = round(
            time.perf_counter() - t0, 1)
        return out

    paths = {}
    paths["hier"], metrics = run(phase_build_beside_hier, dev)
    errs = {"philox": run(phase_philox, dev)}
    errs.update(k2=run(phase_k2, dev), k1=run(phase_k1, dev))
    errs["k1_super"] = run(phase_k1_super, dev)
    errs["k3_super"] = run(phase_k3_super, dev)
    launches, m = run(phase_main, dev)
    metrics.update(m)
    metrics.update(run(phase_main_super, dev))
    metrics.update(run(phase_trace, dev))
    rows = run(phase_timing, dev, launches, errs)
    errs["k1_variants"] = run(phase_k1_variants, dev)
    errs["k3"] = run(phase_k3, dev)
    paths["main"] = launches
    paths["65k"], m = run(phase_main_65k, dev)
    metrics.update(m)
    paths["mvn"], m = run(phase_main_mvn, dev)
    metrics.update(m)
    paths["wide"], m = run(phase_main_wide, dev)
    metrics.update(m)
    paths["seq"], m = run(phase_main_seq, dev)
    metrics.update(m)
    metrics.update(run(phase_trace_slice2, dev))
    rows += run(phase_timing_slice2, dev, paths, errs)
    errs["k1_zoo"] = run(phase_k1_zoo, dev)
    zoo = {}
    for name, phase in (("lba", phase_main_lba), ("abc", phase_main_abc),
                        ("discrete", phase_main_discrete)):
        zoo[name], m = run(phase, dev)
        metrics.update(m)
    metrics.update(run(phase_trace3, dev))
    rows += run(phase_timing3, dev, zoo, errs["k1_zoo"])
    errs["k4"] = run(phase_k4, dev)
    kde_launches, m = run(phase_main_kde, dev)
    metrics.update(m)
    for phase in (phase_main_unfused_gauss, phase_main_lnr):
        metrics.update(run(phase, dev)[1])
    metrics.update(run(phase_trace4, dev))
    rows += run(phase_timing4, dev, kde_launches, errs["k4"])
    metrics.update(run(phase_k_sweep, dev))
    rows += run(phase_timing5, dev, paths, errs)
    errs["k3_mig"] = run(phase_k3_mig, dev)
    errs["k_blocks"], paths["k_blocks"] = run(phase_k_blocks, dev)
    for name, phase in (("mcz_mig", phase_main_mcz_mig),
                        ("blocked", phase_main_blocked)):
        paths[name], m = run(phase, dev)
        metrics.update(m)
    metrics.update(run(phase_trace5, dev))
    rows += run(phase_timing6, dev, paths, errs)
    errs["k1_greedy"] = run(phase_k1_greedy, dev)
    for which, phase in (("rastrigin", phase_main_opt_rastrigin),
                         ("mle", phase_main_opt_mle)):
        m = run(phase, dev)
        paths["opt_" + which] = m.pop("launches")
        metrics.update(m)
    metrics.update(run(phase_main_opt_f64, dev))
    rows += run(phase_timing7, dev, paths, errs)
    errs["k1_shard"] = run(phase_k1_shard, dev)
    mesh_launches, m = run(phase_main_mesh, dev)
    metrics.update(m)
    rows += run(phase_timing8, dev, mesh_launches, errs)
    for phase in (phase_main_chunked, phase_main_ckpt, phase_main_monitor,
                  phase_trace_chunked):
        metrics.update(run(phase, dev))
    new = ("main_chunked", "main_ckpt", "main_monitor", "trace_chunked")
    log("end", f"the chunked run's phases took "
        f"{sum(took[k] for k in new):.1f} s")
    fresh, m = run(phase_main_kde_fresh, dev)
    metrics.update(m)
    for phase in (phase_main_abc_fixed, phase_main_custom, phase_main_lv,
                  phase_trace_kde_fresh):
        metrics.update(run(phase, dev))
    rows += run(phase_timing9, dev, fresh, errs)
    new = ("main_kde_fresh", "main_abc_fixed", "main_custom", "main_lv",
           "trace_kde_fresh", "timing9")
    log("end", f"the custom slots' and stochastic models' phases took "
        f"{sum(took[k] for k in new):.1f} s")
    errs["k1_rep"] = run(phase_k1_rep, dev)
    errs["k2_rep"] = run(phase_k2_rep, dev)
    reps, rep_launches, m = run(phase_main_rep, dev)
    metrics.update(m)
    packed_launches, m = run(phase_main_packed, dev)
    metrics.update(m)
    metrics.update(run(phase_main_opt_rep, dev))
    metrics.update(run(phase_main_rep_mesh, dev, reps))
    del reps
    metrics.update(run(phase_trace_rep, dev))
    rows += run(phase_timing10, dev, rep_launches, errs)
    new = ("k1_rep", "k2_rep", "main_rep", "main_packed", "main_opt_rep",
           "main_rep_mesh", "trace_rep", "timing10")
    log("end", f"the replicated runs' phases took "
        f"{sum(took[k] for k in new):.1f} s")
    errs["k3_shard"] = run(phase_k3_shard, dev)
    mcz_launches, m = run(phase_main_mesh_mcz, dev)
    metrics.update(m)
    for phase in (phase_main_data_mesh, phase_main_dist, phase_rep_f7):
        metrics.update(run(phase, dev))
    rows += run(phase_timing11, dev, mcz_launches, errs)
    new = ("k3_shard", "main_mesh_mcz", "main_data_mesh", "main_dist",
           "rep_f7", "timing11")
    log("end", f"the sixteenth slice's phases took "
        f"{sum(took[k] for k in new):.1f} s")
    _rhat_results(metrics)
    card = gpu_line()
    log("end", "host seconds of Chains.rhat() by cell: "
        + ", ".join(f"{k} {v:.2f}" for k, v in RHAT_SECONDS.items())
        + f" (card: {card})")
    log("end", f"all phases passed in {time.perf_counter() - t_start:.1f} s "
        f"on {card} (seconds per phase: {json.dumps(took)}); "
        f"{json.dumps(metrics)}")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
