"""Same-call A/B of the K1, K2, K3 and K4 kernels between source trees, on
one GPU.

    python3 tools/k1_ab.py [--sass DENSITY] [--changed CLASSES]
        [--sass-only] LABEL=DIR [LABEL=DIR ...]

Each DIR is the root of a checkout (for example ``git archive`` of two
commits unpacked under ``_verify/``).  For each tree, in turns (the trees in
order, then in reverse), a process started in that tree builds its
libraries from its own sources and times one-iteration K1 launches on the
ABC binomial (4,096 chains, n_sim = 10,000; from the prior's draws and
from θ drawn from the posterior Beta(7, 5), with the proposals in bounds
of each where the tree's ``chip_smoke`` can say), discrete binomial
(3,072; and 2 × 1,024, where a chain gets one lane), LBA (4,096 chains,
100 trials; and 2 × 1,024), 4,096-chain Gaussian,
65,536-chain snooker Gaussian and 16,384-chain sequential-sweep Gaussian
(``main-seq``'s 4,096 × 4) cells past burn-in, the blocked cell (4,096,
the blocks (μ), (σ)) and the optimization cells (opt-mle, K1 max on the
Gaussian; opt-rastrigin, K1 min) at 4,096 chains, fired K2 launches on Philox
words at (G, Np) = (8, 16), (32, 16), (64, 16), (128, 16), (64, 4), (128,
4), (256, 4), (512, 4), (256, 16), (4,096, 16), (4,096, 4) and (8,192, 16)
(in a tree whose K2 has two forms, also each form forced), one-iteration K3
launches at the 30-dim MVN flagship's shapes (C = 3, θs = 0.1) and K4 at
the abc_kde cell's shape (3,072 chains × 50 points × 10,000 simulations),
with
``chip_smoke.device_ms`` (launches queued behind a spin kernel, CUDA
events).  A tree whose ``de_step`` takes ``K`` also times windows of 64
iterations (no gate open before the last, the post variant), per
iteration (the optimization cells' storing no row, as ``optimize()``
runs them), K1 windows in burn-in on the Gaussian, sequential and blocked
cells, and K3 windows of 64 at the MVN flagship past burn-in and in it, at
the MVN's C = 64, on the C = 512 DE-MCz Gaussian (128 × 4) past burn-in
and in it, at the mcz-mig cell's 128 × 4 (α = 0.1) on a window whose last
iteration opens the gate and the others do not, and at C = 2,048 (512 × 4)
where the tree's ``window_chains`` holds it (else the same 64 iterations
as one launch each, so the digests compare a window with single
launches); and one-iteration K3 launches on the Gaussian at C = 512.

Each turn also writes digests (SHA-256 of the bytes) of the kernels'
results on fixed inputs: K1's θ, w, accept flags and gate after one
iteration in burn-in, one past it and a window of 64 on the LBA, ABC,
discrete and Gaussian cells, on the sequential, snooker, blocked and
optimization cells (a window in burn-in too), on LBA at 4 × 64 and 2 ×
1,024 on 100 and 37
trials, on the discrete binomial at 2 × 256, 2 × 512 and 2 × 1,024 (4, 2
and 1 lanes a chain beside the cell's 8) and at the cell's shape on 20
unique counts,
and on the ABC binomial at 4 × 64, 2 × 64 (sequential), 2 × 1,024
and the cell's shape with bounds (−0.5, 1.5); K3's after one iteration on
the MVN flagship, and after windows of 64 in burn-in and past it on the
MVN at C = 3 and at the populations of ``chip_smoke.MVN_LANE_CASES`` in
this script's own tree (C = 32, 64, 16 synchronous, 3 without snooker);
K3's θ, w, accept flags, gate and history after the Gaussian windows
above;
K2's θ and w after a fired exchange in bits-in mode at K2's shapes with
pairs of tied leader words and at G = 256 and 4,096 with every leader's
tied (inputs from this script's own tree's ``chip_smoke._mig_case``; a
tree with two forms digests both, so forms that disagree differ); K4's
``[C, E]``
output at the cell's shape and at (64, 1, 10,000), (40, 33, 4,173) and
(8, 300, 2,500) with subnormal, tiny and huge bandwidths on the first
chains.  The digests of every tree and turn must agree: the script prints
each one's verdict and exits 1 where they differ.  It also prints each
tree's ``fused_step.block_chains`` for the ABC and LBA densities and
``resample_step.window_chains`` for the MVN flagship.  The first turn of
each tree writes its K1, K3 and K4 libraries' per-function register and
stack use (``cuobjdump -res-usage``) to ``chiprun_out/ab_<label>.res``,
``ab_<label>_k3.res`` and ``ab_<label>_kde.res``, and prints the range
of registers and stack over the functions on ``CHANGED`` by kernel, and
writes the SASS of K4 and of the K1 instantiations on one density or
more (``--sass``: the starts of their C++ class names, comma separated,
``Gaussian`` by default) to ``ab_<label>_kde.sass`` and
``ab_<label>_<density>.sass``, and hashes
every K1 and K3 function's SASS (addresses, encodings and constants
stripped): the script prints how many of the functions off the Gaussian
and the Rastrigin (``CHANGED``, the densities whose kernels this change
redesigns) are identical between the trees, and names each that is not,
with a diff of its stripped SASS between the trees in
``chiprun_out/ab_sass_diff_<label>_<i>.txt``.  ``--changed`` names those
densities (comma separated; ``none``: every K1 and K3 function must keep
its SASS), ``--sass-only`` runs one turn that only builds each tree and
compares the SASS (no timings, no digests).  Prints one line per tree
and measurement, then the card's name and power limit.
"""

import difflib
import hashlib
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

OUT = Path(__file__).resolve().parent.parent / "chiprun_out"
WINDOW_K = 64
IT = 2000
# K4's bandwidths on the first chains of its digest shapes: subnormal and
# huge (the true division), 2^-59.5 and 2^59 (the fast quotient's edges);
# chip_smoke.K4_EDGE_H, written out here for trees whose chip_smoke.py
# lacks it
EDGE_H = (1e-39, 1e30, 2.0 ** -59.5, 2.0 ** 59)
KDE_SHAPES = ((64, 1, 10_000), (40, 33, 4173), (8, 300, 2500))
# the ABC cell with bounds wider than [0, 1] (the density's count branch);
# chip_smoke.ABC_WIDE_BOUNDS, written out for trees that lack it
ABC_WIDE_BOUNDS = ((-0.5, 1.5),)
# the kernels whose SASS this change may alter (class names in the
# mangled function names): K1 and K3 on the d = 2 densities
CHANGED = ("GaussianDensity", "RastriginDensity")
# K2's digested shapes (G, Np), d = 2, and the timed ones (the small G
# between 8 and 256 place the one-CTA form's threshold)
K2_SHAPES = ((8, 16), (256, 16), (4096, 16), (4096, 4), (8192, 16))
K2_TIMED = ((8, 16), (32, 16), (64, 16), (128, 16), (64, 4), (128, 4),
            (256, 4), (512, 4)) + K2_SHAPES[1:]
# the MVN flagship's population, (n_groups, Np, sweep, θs; None: 0.1)
MVN_FLAGSHIP = (1, 3, "auto", None)
# K3 on the Gaussian DE-MCz (synchronous, θs = 0.1, n_initial = 50):
# name -> (n_groups, Np, α)
K3_GAUSS = {"k3g512": (128, 4, 0.0), "k3mig": (128, 4, 0.1),
            "k3g2048": (512, 4, 0.0)}


def mvn_pops():
    """The MVN DE-MCz populations of the K3 digests: the flagship and
    ``chip_smoke.MVN_LANE_CASES`` of this script's own tree (passed to the
    workers of every tree)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    return {"mvn": MVN_FLAGSHIP, **chip_smoke.MVN_LANE_CASES}


def mvn_case(dev, pop, burnin=2000, key=4, extra_rows=3000):
    """(model, spec, cfg, state) of the 30-dim MVN DE-MCz at population
    ``pop`` = (n_groups, Np, sweep, θs), with ``extra_rows`` history rows
    to write."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import mvnormal
    from demcmc_tpu_torch.ops import fused_step
    G_, Np_, sweep, sn = pop
    model, de = mvnormal.make(d=30, n_obs=100, key=1, burnin=burnin,
                              theta_snooker=0.1 if sn is None else sn,
                              n_groups=G_, Np=Np_, sweep=sweep)
    spec = tdm.make_spec(model, de)
    cfg = fused_step.StepConfig.make(model, de, spec)
    s = tdm.sampler._grow_history(
        tdm.init_state(model, de, spec, key, device=dev), extra_rows)
    return model, spec, cfg, s


def k3_window(resample_step, case, it0, phase, dev):
    """A function launching one K3 window of WINDOW_K from a copy of the
    case's state (fresh on each call: the same window every time), and
    that state and its outputs."""
    import torch
    model, spec, cfg, s = case
    C = cfg.G * cfg.Np
    st = [s.theta.clone(), s.weight.clone(), s.fire.clone(),
          s.history.clone()]
    out = (torch.empty((WINDOW_K, C, cfg.d), device=dev),
           torch.empty((WINDOW_K, C), device=dev),
           torch.empty((WINDOW_K, C), dtype=torch.bool, device=dev))

    def run():
        resample_step.resample_step(cfg, model, spec, *st, it0, out=out,
                                    K=WINDOW_K, phase=phase)
    return run, st, out


def k3_gauss(cs, dev, G_, Np_, alpha, burnin=1000, extra_rows=3000):
    """(model, spec, cfg, state) of the Gaussian DE-MCz at G_ × Np_."""
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian
    from demcmc_tpu_torch.ops import fused_step
    model, de = gaussian.make(data=cs._gauss_data(), n_groups=G_, Np=Np_,
                              alpha=alpha, sample="resample", n_initial=50,
                              burnin=burnin, theta_snooker=0.1, sweep="sync")
    spec = tdm.make_spec(model, de)
    cfg = fused_step.StepConfig.make(model, de, spec)
    s = tdm.sampler._grow_history(
        tdm.init_state(model, de, spec, 4, device=dev), extra_rows)
    return model, spec, cfg, s


def gate_at_end(cs, cfg, lo, K):
    """(seed, it0): a window of K from it0 >= lo whose inner iterations'
    gates are shut and whose last iteration's gate opens."""
    for seed in range(256):
        g = cs._gates(seed, lo, 4096 + K, cfg)
        for i in range(4096):
            if g[i + K - 1] and not g[i:i + K - 1].any():
                return seed, lo + i
    raise AssertionError("no window with its gate open at the end")


def k3_gauss_runs(cs, resample_step, dev):
    """{name: (run, state, outputs, window)} of the Gaussian K3 windows of
    WINDOW_K: at C = 512 in burn-in and past it, mcz-mig's with the gate
    open at its end, C = 2,048 past burn-in and in it -- as one launch
    where the tree's window holds the population, else one launch an
    iteration.  Each run starts from a fresh copy of its case's state."""
    import torch
    runs = {}
    for name, (G_, Np_, alpha) in K3_GAUSS.items():
        # mcz-mig's window starts where its gates say (gate_at_end)
        case = k3_gauss(cs, dev, G_, Np_, alpha,
                        extra_rows=8000 if alpha > 0.0 else 3000)
        model, spec, cfg, s = case
        C = G_ * Np_
        starts = [("post", 2500, "post", 0)]
        if name != "k3mig":
            starts.append(("burnin", 300, "all", 0))
        else:
            seed, it0 = gate_at_end(cs, cfg, 2000, WINDOW_K)
            starts = [("post", it0, "post", seed)]
        for tag, it0, phase, seed in starts:
            st = [s.theta.clone(), s.weight.clone(), s.fire.clone(),
                  s.history.clone()]
            out = (torch.empty((WINDOW_K, C, cfg.d), device=dev),
                   torch.empty((WINDOW_K, C), device=dev),
                   torch.empty((WINDOW_K, C), dtype=torch.bool, device=dev))
            window = C <= resample_step.window_chains(cfg, dev)

            def run(st=st, out=out, it0=it0, phase=phase, seed=seed,
                    cfg=cfg, model=model, spec=spec, window=window):
                if window:
                    resample_step.resample_step(
                        cfg, model, spec, *st, it0, seed=seed, out=out,
                        K=WINDOW_K, phase=phase)
                    return
                for k in range(WINDOW_K):
                    resample_step.resample_step(
                        cfg, model, spec, *st, it0 + k, seed=seed,
                        out=tuple(o[k] for o in out), phase=phase)
            runs[f"{name}_{tag}"] = (run, st, out, window)
    return runs


def res_summary(text, keep):
    """{kernel: (registers low-high, stack low-high)} over the functions
    of ``cuobjdump -res-usage`` output whose names hold ``keep``."""
    lines = text.splitlines()
    out = {}
    for i, line in enumerate(lines[:-1]):
        if "Function" not in line or keep not in line:
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+)", lines[i + 1])
        kind = re.search(r"demcmc\d+(sweep_kernel\w*?)I", line)
        if m and kind:
            out.setdefault(kind.group(1), []).append(
                (int(m.group(1)), int(m.group(2))))
    return {k: (f"REG {min(r for r, _ in v)}-{max(r for r, _ in v)}",
                f"STACK {min(t for _, t in v)}-{max(t for _, t in v)}",
                f"{len(v)} functions") for k, v in out.items()}


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def k1_digests(cs, fused_step, tdm, name, model, de, windows, dev,
               burnin_window=False):
    """Digests of one K1 iteration in burn-in, one past it and a window of
    WINDOW_K past it (and, with ``burnin_window``, one in burn-in) from the
    same initial state."""
    import torch
    spec = tdm.make_spec(model, de)
    cfg = fused_step.StepConfig.make(model, de, spec)
    s = tdm.init_state(model, de, spec, 5, device=dev)
    C = de.n_chains
    res = {}
    runs = [("burnin", de.burnin // 2, 1), ("post", IT, 1)]
    if windows:
        runs.append(("window", IT, WINDOW_K))
        if burnin_window:
            runs.append(("window_burnin", 100, WINDOW_K))
    for tag, it, K in runs:
        st = (s.theta.clone(), s.weight.clone(), s.fire.clone())
        shape = (C,) if K == 1 else (K, C)
        out = (torch.empty(shape + (cfg.d,), device=dev),
               torch.empty(shape, device=dev),
               torch.empty(shape, dtype=torch.bool, device=dev))
        kw = dict(K=K, phase="post") if K > 1 else {}
        if K > 1:
            hi = de.burnin - K if tag == "window_burnin" else 1 << 16
            seed, it = cs.quiet_start(0, cfg, it, hi, K)
            kw["seed"] = seed
            if tag == "window_burnin":
                kw["phase"] = "all"
        fused_step.de_step(cfg, model, spec, *st, it, out=out, **kw)
        res[f"digest_k1_{name}_{tag}"] = digest(*st, *out)
    return res


def own_smoke():
    """This script's own tree's ``chip_smoke`` (K2's digest inputs are made
    by its ``_mig_case`` in every tree)."""
    import importlib.util
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_own", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(label: str, dump: str, pops: dict, sass_only: bool = False):
    import numpy as np
    import torch
    sys.path.insert(0, str(Path.cwd()))
    if sass_only:
        res = {}
        sass_dump(label, dump, res)
        print("RESULT " + json.dumps(res), flush=True)
        return
    import chip_smoke as cs
    import demcmc_tpu_torch as tdm
    import port_cells as pc
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.models import binomial, gaussian
    from demcmc_tpu_torch.models import discrete_binomial as disc
    from demcmc_tpu_torch.models import lba as lba_model
    from demcmc_tpu_torch.ops import _build, accept, fused_step, kde

    dev = torch.device("cuda")
    windows = "K" in inspect.signature(fused_step.de_step).parameters

    def opt(which):
        return cs._opt_model(which)[:2]

    def lba(G_, Np_, n):
        return lba_model.make(key=0, n_trials=n, Np=Np_, n_groups=G_,
                              burnin=1000)

    def discrete(G_, Np_, n_unique=None):
        data = None
        if n_unique:
            g = np.random.default_rng(n_unique)
            data = np.concatenate([np.arange(n_unique), g.integers(
                0, n_unique, 50 - n_unique)])
        return disc.make(key=0, n_obs=50, data=data, dtype=np.float32,
                         Np=Np_, n_groups=G_, burnin=1000)

    cells = {"abc": cs._abc_case(1000), "discrete": cs._disc_case(1000),
             "gauss": gaussian.make(data=cs._gauss_data(), Np=cs.NP,
                                    n_groups=cs.G, burnin=1000)}
    timed = dict(cells, lba=cs._lba_case(1000),
                 lba_2x1024=lba(2, 1024, 100),
                 discrete_2x1024=discrete(2, 1024),
                 snooker65k=gaussian.make(data=cs._gauss_data(), Np=16,
                                          n_groups=4096, burnin=1000,
                                          alpha=0.1, theta_snooker=0.1),
                 seq_4096x4=gaussian.make(data=cs._gauss_data(), Np=4,
                                          n_groups=4096, burnin=1000,
                                          alpha=0.1, theta_snooker=0.1),
                 blocked=gaussian.make(
                     data=cs._gauss_data(), Np=pc.BLOCKED_CELL["Np"],
                     n_groups=pc.BLOCKED_CELL["n_groups"], burnin=1000,
                     blocks=pc.BLOCKED_CELL["blocks"], blocking_on=True),
                 opt_mle=opt("mle"), opt_rastrigin=opt("rastrigin"))
    res = {}
    for name, (model, de) in timed.items():
        spec = tdm.make_spec(model, de)
        cfg = fused_step.StepConfig.make(model, de, spec)
        s = tdm.init_state(model, de, spec, 5, device=dev)
        C = de.n_chains
        st = (s.theta, s.weight, s.fire)
        out = (torch.empty((C, cfg.d), device=dev),
               torch.empty(C, device=dev),
               torch.empty(C, dtype=torch.bool, device=dev))
        res[name] = cs.device_ms(lambda: fused_step.de_step(
            cfg, model, spec, *st, IT, out=out), 20 if name == "abc"
            else 200)[0]
        if name == "abc":
            # θ drawn from the posterior Beta(7, 5) instead of the prior:
            # K1 evaluates the density of the proposals in bounds only
            post = (torch.from_numpy(np.random.default_rng(0).beta(
                7, 5, (C, 1)).astype(np.float32)).to(dev), *st[1:])
            res["abc_posterior_state"] = cs.device_ms(
                lambda: fused_step.de_step(cfg, model, spec, *post, IT,
                                           out=out), 20)[0]
            if hasattr(cs, "_proposals"):
                words = rng.words(0, IT, cfg.rows.n_words, C, device=dev)
                for tag, x in (("prior", st), ("posterior", post)):
                    res[f"abc_in_bounds_{tag}_state"] = int(
                        accept.in_bounds(spec, cs._proposals(
                            cfg, model, spec, x, IT, words)).sum())
        if windows:
            seed, it0 = cs.quiet_start(0, cfg, IT, 1 << 16, WINDOW_K)
            wout = (torch.empty((WINDOW_K, C, cfg.d), device=dev),
                    torch.empty((WINDOW_K, C), device=dev),
                    torch.empty((WINDOW_K, C), dtype=torch.bool, device=dev))
            # the optimization cells store no row (optimize())
            kw = (dict(out=None, emit=(WINDOW_K, 1)) if name.startswith("opt")
                  else dict(out=wout))
            ms = cs.device_ms(lambda: fused_step.de_step(
                cfg, model, spec, *st, it0, seed=seed, K=WINDOW_K,
                phase="post", **kw), 2 if name == "abc" else 20)[0]
            res[name + "_window_per_iteration"] = ms / WINDOW_K
            if name in ("gauss", "seq_4096x4", "blocked"):
                seed, it0 = cs.quiet_start(0, cfg, 100, de.burnin - WINDOW_K,
                                           WINDOW_K)
                ms = cs.device_ms(lambda: fused_step.de_step(
                    cfg, model, spec, *st, it0, seed=seed, out=wout,
                    K=WINDOW_K, phase="all"), 20)[0]
                res[name + "_window_burnin_per_iteration"] = ms / WINDOW_K
    from demcmc_tpu_torch.ops import resample_step
    model, spec, cfg, s = mvn_case(dev, pops["mvn"])
    res["mvn_window_chains"] = resample_step.window_chains(cfg, dev)
    st = (s.theta, s.weight, s.fire, s.history)
    out = (torch.empty((3, cfg.d), device=dev), torch.empty(3, device=dev),
           torch.empty(3, dtype=torch.bool, device=dev))
    res["mvn_k3"] = cs.device_ms(lambda: resample_step.resample_step(
        cfg, model, spec, *st, IT + 500, out=out), 200)[0]
    st = [t.clone() for t in st]
    resample_step.resample_step(cfg, model, spec, *st, IT + 500, out=out)
    res["digest_k3_mvn"] = digest(*st, *out)
    # K3 on the Gaussian: one iteration at C = 512, and the windows of
    # k3_gauss_runs, timed where the tree's window holds them, digested
    model, spec, cfg, s = k3_gauss(cs, dev, 128, 4, 0.0)
    st = (s.theta, s.weight, s.fire, s.history)
    out = (torch.empty((512, cfg.d), device=dev), torch.empty(512, device=dev),
           torch.empty(512, dtype=torch.bool, device=dev))
    res["k3g512_one"] = cs.device_ms(lambda: resample_step.resample_step(
        cfg, model, spec, *st, IT + 500, out=out), 200)[0]
    res["k3g2048_window_chains"] = resample_step.window_chains(
        k3_gauss(cs, dev, 512, 4, 0.0, extra_rows=10)[2], dev)
    if windows:
        for name, (run, st, out, window) in k3_gauss_runs(
                cs, resample_step, dev).items():
            if window:
                res[f"{name}_window_per_iteration"] = \
                    cs.device_ms(run, 20)[0] / WINDOW_K
        for name, (run, st, out, window) in k3_gauss_runs(
                cs, resample_step, dev).items():
            run()
            res[f"digest_{name}_window"] = digest(*st, *out)
    if windows:
        # K3 windows of 64: timed at C = 3 (past burn-in and in it) and
        # C = 64, digested at every population of mvn_pops()
        for pop in pops:
            case = mvn_case(dev, pops[pop])
            for tag, it0, phase in (("post", IT + 500, "post"),
                                    ("burnin", 300, "all")):
                run, st, out = k3_window(resample_step, case, it0, phase,
                                         dev)
                if pop in ("mvn", "mvn-l8"):
                    ms = cs.device_ms(run, 20)[0]
                    res[f"{pop}_k3_window_{tag}_per_iteration"] = \
                        ms / WINDOW_K
                run, st, out = k3_window(resample_step, case, it0, phase,
                                         dev)
                run()
                res[f"digest_k3_{pop}_window_{tag}"] = digest(*st, *out)

    # K4 at the abc_kde cell's shape, timed and digested
    C4 = pc.KDE_CELL["n_groups"] * pc.KDE_CELL["Np"]
    x, sims, h = cs._kde_args(C4, pc.KDE_N_OBS, pc.KDE_N_SIM, dev,
                              seed=pc.KDE_N_SIM)
    res["k4"] = cs.device_ms(lambda: kde.kde_logpdf(x, sims, h,
                                                    pc.KDE_FLOOR), 20)[0]
    res["digest_k4_cell"] = digest(kde.kde_logpdf(x, sims, h, pc.KDE_FLOOR))
    for C_, E, S in KDE_SHAPES:
        x, sims, h = cs._kde_args(C_, E, S, dev, seed=S)
        for c, hc in enumerate(EDGE_H):
            h[c] = hc
            if c in (0, 2):
                sims[c, ::100] = x[0]
        res[f"digest_k4_{C_}x{E}x{S}"] = digest(
            kde.kde_logpdf(x, sims, h, pc.KDE_FLOOR))

    # K2 fired on Philox words, timed at each shape (both forms where the
    # tree has two), and digested on fixed words: pairs of tied leader
    # words, and every leader's tied at 256 and 4,096
    from demcmc_tpu_torch.ops import migration as mig
    # a form is forced by K2's chain threshold (None: the tree's choice)
    forms = {"": None}
    if hasattr(mig, "ONE_CTA_MAX_CHAINS"):
        forms.update({"_one_cta": 1 << 30, "_spread": 0})

    def in_form(cap, fn):
        keep = getattr(mig, "ONE_CTA_MAX_CHAINS", None)
        if cap is not None:
            mig.ONE_CTA_MAX_CHAINS = cap
        try:
            return fn()
        finally:
            if cap is not None:
                mig.ONE_CTA_MAX_CHAINS = keep

    fired = torch.ones(1, dtype=torch.int32, device=dev)
    for G_, Np_ in K2_TIMED:
        C_ = G_ * Np_
        g = np.random.default_rng(G_ + Np_)
        theta = torch.tensor(g.standard_normal((C_, 2)), dtype=torch.float32,
                             device=dev)
        w = torch.tensor(g.standard_normal(C_), dtype=torch.float32,
                         device=dev)
        for tag, cap in forms.items():
            res[f"k2_{G_}x{Np_}{tag}"] = in_form(cap, lambda: cs.device_ms(
                lambda: mig.migrate(theta, w, fired, G_, Np_, it=IT),
                200)[0])
    mig_case = own_smoke()._mig_case
    rng_ = np.random.default_rng(5)
    k2_cases = [(G_, Np_, "pairs") for G_, Np_ in K2_SHAPES]
    k2_cases += [(256, 16, "all"), (4096, 16, "all")]
    for G_, Np_, ties in k2_cases:
        theta, w, words = mig_case(rng_, G_, Np_, dev, ties)
        ds = set()
        for cap in forms.values():
            t, ww = theta.clone(), w.clone()
            in_form(cap, lambda: mig.migrate(t, ww, fired, G_, Np_,
                                             bits=words))
            ds.add(digest(t, ww))
        # every form's digest, so forms that disagree differ from a tree
        res[f"digest_k2_{G_}x{Np_}_{ties}"] = "|".join(sorted(ds))

    # K1 digests, the ABC binomial's lane shapes included
    dens = binomial.density(10, 6, pc.N_SIM)
    res["abc_block_chains"] = fused_step.block_chains(False, dens, False,
                                                      False, 1, dev)
    lba_dens = cs._lba_case(1000)[0].cuda_density
    res["lba_block_chains"] = fused_step.block_chains(False, lba_dens, False,
                                                      False, 1, dev)

    def abc(G_, Np_, **kw):
        return binomial.make(N=10, k=6, abc=True, fresh_noise=True,
                             n_sim=pc.N_SIM, Np=Np_, n_groups=G_,
                             burnin=1000, **kw)
    c = pc.ABC_CELL
    wide = (binomial.make_model(10, 6, abc=True, fresh_noise=True,
                                n_sim=pc.N_SIM),
            tdm.DE(bounds=ABC_WIDE_BOUNDS, burnin=1000, Np=c["Np"],
                   n_groups=c["n_groups"]))
    dcell = pc.DISC_CELL
    cases = dict(cells, lba=cs._lba_case(1000), abc_4x64=abc(4, 64),
                 abc_2x64_seq=abc(2, 64, sweep="sequential"),
                 abc_2x1024=abc(2, 1024), abc_wide=wide,
                 lba_4x64=lba(4, 64, 100), lba_4x64_37=lba(4, 64, 37),
                 lba_2x1024=lba(2, 1024, 100), lba_2x1024_37=lba(2, 1024, 37),
                 discrete_2x256=discrete(2, 256),
                 discrete_2x512=discrete(2, 512),
                 discrete_2x1024=discrete(2, 1024),
                 discrete_20u=discrete(dcell["n_groups"], dcell["Np"], 20),
                 **{k: timed[k] for k in ("snooker65k", "seq_4096x4",
                                          "blocked", "opt_mle",
                                          "opt_rastrigin")})
    for name, (model, de) in cases.items():
        res.update(k1_digests(cs, fused_step, tdm, name, model, de, windows,
                              dev, burnin_window=name in (
                                  "gauss", "seq_4096x4", "blocked",
                                  "opt_mle", "opt_rastrigin")))
    if dump:
        sass_dump(label, dump, res)
    print("RESULT " + json.dumps(res), flush=True)


def sass_dump(label: str, dump: str, res: dict):
    """The tree's K1, K3 and K4 libraries built; every K1 and K3
    function's stripped SASS hashed into ``res["sass"]``, the register and
    stack use of the functions on ``CHANGED`` into ``res``, and the files
    of the module docstring written."""
    from demcmc_tpu_torch.ops import _build
    cuobjdump = "/usr/local/cuda/bin/cuobjdump"
    libs = _build.build_all(("de_step", "de_step_resample", "kde"))
    res["sass"] = {}
    for name in ("de_step", "de_step_resample"):
        res["sass"].update(sass_hashes(cuobjdump, libs[name],
                                       OUT / f"ab_{label}_{name}.all"))
    for name, suffix in (("de_step", ""), ("de_step_resample", "_k3"),
                         ("kde", "_kde")):
        run = subprocess.run([cuobjdump, "-res-usage", str(libs[name])],
                             capture_output=True, text=True)
        (OUT / f"ab_{label}{suffix}.res").write_text(run.stdout
                                                     + run.stderr)
        for keep in CHANGED:
            for kind, v in res_summary(run.stdout, keep).items():
                res[f"res_{name}_{keep}_{kind}"] = ", ".join(v)
    (OUT / f"ab_{label}_kde.sass").write_text(subprocess.run(
        [cuobjdump, "-sass", str(libs["kde"])], capture_output=True,
        text=True).stdout)
    sass = subprocess.run([cuobjdump, "-sass", str(libs["de_step"])],
                          capture_output=True, text=True).stdout
    parts = re.split(r"(?=\n\s*Function : )", sass)
    for name in dump.split(","):
        (OUT / f"ab_{label}_{name}.sass").write_text(
            "".join(p for p in parts if name in p.split("\n", 2)[1]))


def sass_functions(sass):
    """{function: its SASS instructions with addresses, encodings and
    constants stripped} of ``cuobjdump -sass`` output."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = part.split("\n", 1)
        # K3's whole-population source, HistoryPartners<D, false>, under
        # the name it had before its shard form (HistoryPartners<D>)
        name = re.sub(r"(HistoryPartnersILi\d+E)Lb0EE", r"\1E", name.strip())
        out[name] = [re.sub(r"0x[0-9a-f]+", "X", m.group(1)) for m in
                             re.finditer(r"/\*[0-9a-f]{4,}\*/\s*(.*?);",
                                         body)]
    return out


def sass_hashes(cuobjdump, lib, keep):
    """{function: hash of its stripped SASS} for every function of a
    library; the whole SASS is written to ``keep`` (for a diff of the
    functions that differ between trees, ``main``)."""
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    keep.write_text(sass)
    return {f: hashlib.sha256("\n".join(ins).encode()).hexdigest()[:16]
            for f, ins in sass_functions(sass).items()}


def main():
    global CHANGED
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], sys.argv[3], json.loads(sys.argv[4]),
               sys.argv[5:6] == ["sass-only"])
        return
    args, dump, sass_only = sys.argv[1:], "Gaussian", False
    while args and args[0].startswith("--"):
        if args[0] == "--sass":
            dump, args = args[1], args[2:]
        elif args[0] == "--changed":
            CHANGED = tuple(c for c in args[1].split(",") if c != "none")
            args = args[2:]
        elif args[0] == "--sass-only":
            sass_only, args = True, args[1:]
        else:
            sys.exit(f"unknown option {args[0]}")
    trees = [a.split("=", 1) for a in args]
    OUT.mkdir(exist_ok=True)
    me = Path(__file__).resolve()
    pops = json.dumps(mvn_pops())
    results = {}
    turns = (trees,) if sass_only else (trees, trees[::-1])
    for turn, order in enumerate(turns):
        for label, d in order:
            run = subprocess.run(
                [sys.executable, str(me), "--worker", label,
                 dump if turn == 0 else "", pops]
                + ["sass-only"] * sass_only,
                cwd=d, capture_output=True, text=True, timeout=900)
            line = [x for x in run.stdout.splitlines()
                    if x.startswith("RESULT ")]
            if run.returncode or not line:
                sys.exit(f"{label}: worker failed\n{run.stdout}\n{run.stderr}")
            for k, v in json.loads(line[0][7:]).items():
                results.setdefault((label, k), []).append(v)
    digests, differ, sass = {}, [], {}
    for (label, k), v in results.items():
        if k == "sass":
            sass[label] = v[0]
        elif k.startswith("digest_"):
            digests.setdefault(k, set()).update(v)
        elif isinstance(v[0], float):
            print(f"{label} {k}: {sum(v) / len(v):.6f} ms on the device ("
                  + ", ".join(f"{x:.6f}" for x in v) + ")")
        else:
            print(f"{label} {k}: " + ", ".join(str(x) for x in v))
    for k, v in digests.items():
        print(f"{k}: " + ("equal in every tree and turn " if len(v) == 1
                          else "DIFFERS ") + ", ".join(sorted(v)))
        if len(v) > 1:
            differ.append(k)
    # the instantiations off CHANGED compile to the same code in every tree
    # (constants and addresses aside)
    labels = list(sass)
    for other in labels[1:]:
        a, b = sass[labels[0]], sass[other]
        common = [f for f in a if f in b
                  and not any(c in f for c in CHANGED)]
        same = sum(a[f] == b[f] for f in common)
        print(f"SASS {labels[0]} vs {other}: {same} of {len(common)} "
              f"functions off {', '.join(CHANGED) or 'no density'} "
              f"identical; "
              f"{len(a) - len(common)} / {len(b) - len(common)} others")
        for i, f in enumerate(f for f in common if a[f] != b[f]):
            print(f"SASS differs: {f} (diff in chiprun_out/"
                  f"ab_sass_diff_{other}_{i}.txt)")
            sides = []
            for lab in (labels[0], other):
                fns = {}
                for lib in ("de_step", "de_step_resample"):
                    fns.update(sass_functions(
                        (OUT / f"ab_{lab}_{lib}.all").read_text()))
                sides.append(fns.get(f, []))
            (OUT / f"ab_sass_diff_{other}_{i}.txt").write_text("\n".join(
                difflib.unified_diff(*sides, labels[0], other, lineterm="")))
        if same < len(common):
            differ.append(f"SASS off {', '.join(CHANGED) or 'no density'}")
    for f in OUT.glob("ab_*.all"):
        f.unlink()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    if differ:
        sys.exit(f"digests differ between trees: {differ}")


if __name__ == "__main__":
    main()
