"""Hold the JAX package and the port's plain path to the posterior gates of
the port's cells (``port_cells.py``) on the CPU, so that the GPU's run
(``chip_smoke.py``) relies on gates and run lengths the reference meets.

    JAX_PLATFORMS=cpu python tools/port_oracles_cpu.py [CELL ...]

CELL is any of ``lba discrete kde gauss-unfused lnr mcz-mig blocked
hier opt kde-fresh abc-fixed rep opt-rep`` (all by default).

1. LBA (100 trials, numpy seed 0): ``port_cells.lba_oracle``, then
   ``demcmc_tpu.sample`` (the JAX package's XLA step) with 256 chains at
   the cell's length, and with the cell's 4,096 chains at 3,000 iterations
   and at the cell's length, each through ``port_cells.lba_gate`` with its
   max R̂.
2. Discrete binomial (the cell's 3,072 chains, float32): ``demcmc_tpu.
   sample`` and ``demcmc_tpu_torch.sample(device='cpu')`` at 3,000
   iterations and at the cell's length, each through
   ``port_cells.discrete_gate`` with its max R̂.

3. abc_kde (fixed panel, numpy seeds 0 and 7): ``port_cells.kde_oracle``,
   then the JAX XLA step on a JAX model with the same data and panel (the
   JAX ``abc_kde.make``'s fixed-noise density) with 96 chains, at 2,000
   iterations and at the cell's length, through ``port_cells.kde_gate``.
4. gauss-unfused: the JAX XLA step on the 4,096-chain Gaussian at the
   cell's length, against the quadrature oracle (0.01) with its max R̂.
5. LNR (numpy seed 0): ``port_cells.lnr_oracle``, then the JAX XLA step
   on the cell's 3,072 chains at 3,000 iterations and at the cell's
   length, through ``port_cells.lnr_gate``.

6. mcz-mig: the JAX XLA step on the C = 512 DE-MCz Gaussian with α = 0.1
   (``port_cells.MCZ_MIG_CELL``) at 5,000 iterations and at the cell's
   length, against the quadrature oracle (0.01) with its max R̂.
7. blocked: the JAX XLA step on the 4,096-chain Gaussian with the blocks
   (μ), (σ) every iteration (``port_cells.BLOCKED_CELL``) at the cell's
   length, the same gate.
8. hier: ``port_cells.hier_oracle`` of the hierarchical cell's data, then
   the JAX XLA step (the JAX model on the same data) at the cell's length,
   through ``port_cells.hier_gate`` at 6,000, 10,000 and 20,000 kept
   draws, with max R̂ printed (not gated: see ``port_cells.HIER_CELL``).

9. opt: the optimization cells (``port_cells.OPT_*``): the float32
   Rastrigin and MLE cells through ``demcmc_tpu_torch.optimize(...,
   device='cpu')`` (K1's plain version with the greedy accepts) at keys
   0-2 and ``demcmc_tpu.optimize`` at key 0, each through
   ``port_cells.rastrigin_gate`` / ``mle_gate`` with the float32 gates;
   then the reference's float64 cells through both packages (the port's
   unfused step; the JAX package with x64 on) at the cells' length, with
   the float64 gates.

10. kde-fresh: ``port_cells.kde_fresh_oracle`` (the synthetic likelihood
   averaged over 32 panels), then the JAX XLA step on the JAX
   ``abc_kde.make(fresh_noise=True)`` model with the cell's data (a fresh
   simulation per evaluation) with 96 chains at the cell's length,
   through ``port_cells.kde_gate``.
11. abc-fixed: ``port_cells.abc_fixed_oracle`` of the JAX fixed-noise ABC
   binomial's panel (``uniform(PRNGKey(123), (10,000, 10))``) and the JAX
   XLA step with 64 chains at the cell's length; the same for the port's
   plain path on its own numpy panel; each through
   ``port_cells.abc_fixed_gate``.
12. rep: the replicated cell (``port_cells.REP_CELL``, 64 Gaussian
   datasets of 16 chains): the JAX package's ``sample_replicated`` on all
   64 at a third of the cell's length and at its length, the port's plain
   path on 4, each replication's posterior means against its quadrature
   oracle with the max R̂ over all.
13. opt-rep: the replicated MLE cell (``port_cells.OPT_REP_CELL``): the
   JAX package's ``optimize_replicated`` on all 64 datasets, the port's
   plain path on 8, each MLE against the closed form.

Prints one line per run; exits non-zero if a run at the cell's length
fails its gate or R̂ ≥ ``port_cells.RHAT_MAX``.  About three minutes on
four cores for the first two cells, twenty for the last three.
"""

import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import demcmc_tpu as jdm  # noqa: E402
import demcmc_tpu_torch as tdm  # noqa: E402
import port_cells as pc  # noqa: E402
from demcmc_tpu.models import discrete_binomial as jdisc  # noqa: E402
from demcmc_tpu.models import lba as jlba  # noqa: E402
from demcmc_tpu_torch.models import discrete_binomial as tdisc  # noqa: E402
from demcmc_tpu_torch.models import lba as tlba  # noqa: E402


def _verdict(ok, rhat, n_iter, cell_iter):
    passed = ok and rhat < pc.RHAT_MAX
    return passed or n_iter != cell_iter, "passes" if passed else "FAILS"


def check_lba():
    cell = pc.LBA_CELL
    model, _ = tlba.make(key=0, n_trials=100)
    t0 = time.perf_counter()
    oracle = pc.lba_oracle(*model.data)
    print(f"[lba] oracle: ESS {oracle[2]:.0f}, mean {np.round(oracle[0], 5)}"
          f", sd {np.round(oracle[1], 5)} ({time.perf_counter() - t0:.1f} s)")
    all_ok = oracle[2] >= pc.LBA_MIN_ESS
    for G, n_iter in ((16, cell["n_iter"]), (cell["n_groups"], 3000),
                      (cell["n_groups"], cell["n_iter"])):
        jm, jde = jlba.make(data=model.data, Np=cell["Np"], n_groups=G,
                            burnin=cell["burnin"])
        t0 = time.perf_counter()
        ch = jdm.sample(jm, jde, n_iter, key=0)
        ok, (m, s, dm, ds) = pc.lba_gate(np.asarray(ch.data), oracle)
        rhat = ch.rhat()
        good, word = _verdict(ok, float(rhat.max()), n_iter, cell["n_iter"])
        all_ok = all_ok and good
        print(f"[lba] demcmc_tpu.sample, {cell['Np'] * G} chains, {n_iter} "
              f"iterations ({time.perf_counter() - t0:.1f} s): mean "
              f"{np.round(m, 5)}, sd {np.round(s, 5)}; |mean - oracle| / "
              f"oracle sd {np.round(dm, 4)}, |sd / oracle sd - 1| "
              f"{np.round(ds, 4)}; R-hat {np.round(rhat, 5)}; {word}")
    return all_ok


def check_discrete():
    cell = pc.DISC_CELL
    kw = dict(key=0, n_obs=50, dtype=np.float32, n_groups=cell["n_groups"],
              Np=cell["Np"], burnin=cell["burnin"])
    model, de = tdisc.make(**kw)
    oracle = pc.discrete_oracle(model.data)
    print(f"[discrete] oracle: N {np.round(oracle['N'], 5)}, p "
          f"{np.round(oracle['p'], 5)} (mean, sd)")
    jm, jde = jdisc.make(**kw)
    all_ok = True
    for n_iter in (3000, cell["n_iter"]):
        for tag, run in (
                ("demcmc_tpu.sample", lambda: jdm.sample(jm, jde, n_iter,
                                                         key=0)),
                ("demcmc_tpu_torch.sample(device='cpu')",
                 lambda: tdm.sample(model, de, n_iter, key=0,
                                    device="cpu"))):
            t0 = time.perf_counter()
            ch = run()
            secs = time.perf_counter() - t0
            ok, rows = pc.discrete_gate(ch.group("N"), ch.group("p"), oracle)
            rhat = np.asarray(ch.rhat())
            good, word = _verdict(ok, float(rhat.max()), n_iter,
                                  cell["n_iter"])
            all_ok = all_ok and good
            print(f"[discrete] {tag}, {de.n_chains} chains, {n_iter} "
                  f"iterations ({secs:.1f} s): " + "; ".join(
                      f"{k} mean {m:.5f} ({dm:.4f} sd off), sd {s:.5f} "
                      f"({100 * (s / oracle[k][1] - 1):+.2f}%)"
                      for k, (m, s, dm, _) in rows.items())
                  + f"; R-hat {np.round(rhat, 5)}; {word}")
    return all_ok


def _report(tag, what, n_iter, cell, secs, ok, rows, rhat):
    good, word = _verdict(ok, float(np.max(rhat)), n_iter, cell["n_iter"])
    print(f"[{tag}] {what}, {n_iter} iterations ({secs:.1f} s): {rows}; "
          f"R-hat {np.round(rhat, 5)}; {word}")
    return good


def check_kde(n_groups=16):
    import jax.numpy as jnp
    from demcmc_tpu.model import DEModel
    from demcmc_tpu.models import gaussian as jg
    from demcmc_tpu.utils.kde import epanechnikov_logpdf
    cell = pc.KDE_CELL
    data, noise = pc.kde_inputs()
    t0 = time.perf_counter()
    oracle = pc.kde_oracle(data, noise)
    print(f"[kde] oracle: {oracle} ({time.perf_counter() - t0:.1f} s)")
    panel = jnp.asarray(noise)

    def loglike(data, mu, sigma):         # demcmc_tpu/models/abc_kde.py:50
        return jnp.sum(epanechnikov_logpdf(data, mu + sigma * panel))

    jm = DEModel(loglike=loglike, prior_loglike=jg.prior_loglike,
                 sample_prior=jg.sample_prior, names=jg.NAMES,
                 data=jnp.asarray(data))
    jde = jdm.DE(bounds=jg.BOUNDS, burnin=cell["burnin"], Np=cell["Np"],
                 n_groups=n_groups)
    all_ok = True
    for n_iter in (2000, cell["n_iter"]):
        t0 = time.perf_counter()
        ch = jdm.sample(jm, jde, n_iter, key=0)
        secs = time.perf_counter() - t0
        ok, rows = pc.kde_gate(ch["mu"], ch["sigma"], oracle)
        all_ok = _report("kde", f"demcmc_tpu.sample, {jde.n_chains} chains",
                         n_iter, cell, secs, ok, rows,
                         np.asarray(ch.rhat())) and all_ok
    return all_ok


def check_gauss_unfused():
    from demcmc_tpu.models import gaussian as jg
    cell = pc.GAUSS_UNFUSED_CELL
    data = np.random.default_rng(0).standard_normal(50).astype(np.float32)
    jm, jde = jg.make(data=data, Np=cell["Np"], n_groups=cell["n_groups"],
                      burnin=cell["burnin"])
    truth = jg.posterior_grid(data)
    t0 = time.perf_counter()
    ch = jdm.sample(jm, jde, cell["n_iter"], key=0)
    secs = time.perf_counter() - t0
    rows = {k: (float(ch.mean(k)), float(ch.std(k))) for k in ("mu", "sigma")}
    ok = all(abs(rows[k][0] - truth[k]["mean"]) < 0.01
             and abs(rows[k][1] - truth[k]["std"]) < 0.01 for k in rows)
    return _report("gauss-unfused", f"demcmc_tpu.sample, {jde.n_chains} "
                   f"chains (oracle {truth})", cell["n_iter"], cell, secs,
                   ok, rows, np.asarray(ch.rhat()))


def check_lnr():
    import jax.numpy as jnp
    from demcmc_tpu.models import lnr as jlnr
    cell = pc.LNR_CELL
    from demcmc_tpu_torch.models import lnr as tlnr
    choice, rt = tlnr.make()[0].data
    t0 = time.perf_counter()
    oracle = pc.lnr_oracle(choice, rt)
    print(f"[lnr] oracle: ESS {oracle[2]:.0f}, mean {np.round(oracle[0], 5)}"
          f", sd {np.round(oracle[1], 5)} ({time.perf_counter() - t0:.1f} s)")
    all_ok = oracle[2] >= pc.LNR_MIN_ESS
    jm, jde = jlnr.make(data=(jnp.asarray(choice), jnp.asarray(rt)),
                        Np=cell["Np"], n_groups=cell["n_groups"],
                        burnin=cell["burnin"])
    for n_iter in (3000, cell["n_iter"]):
        t0 = time.perf_counter()
        ch = jdm.sample(jm, jde, n_iter, key=0)
        secs = time.perf_counter() - t0
        ok, (m, s, dm, ds) = pc.lnr_gate(np.asarray(ch.data), oracle)
        rows = (f"mean {np.round(m, 5)}, sd {np.round(s, 5)}; |mean / "
                f"oracle - 1| {np.round(dm, 4)}, |sd / oracle sd - 1| "
                f"{np.round(ds, 4)}")
        all_ok = _report("lnr", f"demcmc_tpu.sample, {jde.n_chains} chains",
                         n_iter, cell, secs, ok, rows,
                         np.asarray(ch.rhat())) and all_ok
    return all_ok


def _gauss_gate(tag, what, ch, data, n_iter, cell, secs):
    from demcmc_tpu.models import gaussian as jg
    truth = jg.posterior_grid(data)
    rows = {k: (float(ch.mean(k)), float(ch.std(k))) for k in ("mu", "sigma")}
    ok = all(abs(rows[k][0] - truth[k]["mean"]) < 0.01
             and abs(rows[k][1] - truth[k]["std"]) < 0.01 for k in rows)
    return _report(tag, f"{what} (oracle {truth})", n_iter, cell, secs, ok,
                   rows, np.asarray(ch.rhat()))


def check_mcz_mig():
    from demcmc_tpu.models import gaussian as jg
    cell = pc.MCZ_MIG_CELL
    data = np.random.default_rng(0).standard_normal(50).astype(np.float32)
    jm, jde = jg.make(data=data, Np=cell["Np"], n_groups=cell["n_groups"],
                      burnin=cell["burnin"], alpha=cell["alpha"],
                      sample="resample", n_initial=cell["n_initial"],
                      theta_snooker=cell["theta_snooker"], sweep="sync")
    all_ok = True
    for n_iter in (5000, cell["n_iter"]):
        t0 = time.perf_counter()
        ch = jdm.sample(jm, jde, n_iter, key=0)
        all_ok = _gauss_gate("mcz-mig", f"demcmc_tpu.sample, {jde.n_chains} "
                             f"chains", ch, data, n_iter, cell,
                             time.perf_counter() - t0) and all_ok
    return all_ok


def check_blocked():
    from demcmc_tpu.models import gaussian as jg
    cell = pc.BLOCKED_CELL
    data = np.random.default_rng(0).standard_normal(50).astype(np.float32)
    jm, jde = jg.make(data=data, Np=cell["Np"], n_groups=cell["n_groups"],
                      burnin=cell["burnin"], blocking_on=True,
                      blocks=[list(b) for b in cell["blocks"]])
    t0 = time.perf_counter()
    ch = jdm.sample(jm, jde, cell["n_iter"], key=0)
    return _gauss_gate("blocked", f"demcmc_tpu.sample, {jde.n_chains} "
                       f"chains", ch, data, cell["n_iter"], cell,
                       time.perf_counter() - t0)


def check_hier():
    import jax.numpy as jnp
    from demcmc_tpu.models import hierarchical as jh
    from demcmc_tpu_torch.diagnostics import rank_normalized_rhat
    from demcmc_tpu_torch.models import hierarchical as th
    cell = pc.HIER_CELL
    model, _ = th.make(n_subj=cell["n_subj"], n_data=cell["n_data"],
                       key=cell["key"])
    oracle = pc.hier_oracle(model.data)
    print(f"[hier] oracle: " + ", ".join(
        f"{k} {oracle[k][0]:.5f} (sd {oracle[k][1]:.5f})"
        for k in ("mu_b0", "sigma_b0", "sigma"))
        + f"; mass at the box's edge: {oracle['mass_at_edge']}")
    jm, jde = jh.make(data=jnp.asarray(model.data), burnin=cell["burnin"])
    t0 = time.perf_counter()
    data = np.asarray(jdm.sample(jm, jde, cell["n_iter"], key=0).data)
    secs = time.perf_counter() - t0
    ok_all = not oracle["mass_at_edge"]
    for n in (6000, 10000, cell["n_iter"] - cell["burnin"]):
        x = data[:n]
        means = {"mu_b0": float(x[:, 0].mean()),
                 "sigma_b0": float(x[:, 1].mean()),
                 "sigma": float(x[:, -1].mean())}
        ok, rows = pc.hier_gate(means, x[:, 2:-1].mean(axis=(0, 2)), oracle)
        rhat = max(rank_normalized_rhat(x[:, j]) for j in range(x.shape[1]))
        last = n == cell["n_iter"] - cell["burnin"]
        ok_all = ok_all and (ok or not last)
        print(f"[hier] demcmc_tpu.sample, {jde.n_chains} chains, {n} kept "
              f"draws ({secs:.1f} s for the run): " + "; ".join(
                  f"{k} {v[0]:.5f} (oracle {v[1]:.5f}, |diff| {v[2]:.4f}, "
                  f"allowed {v[3]:.4f})" for k, v in rows.items()
                  if k != "b0")
              + f"; max |b0 - oracle| {rows['b0'][0]:.4f}; max R-hat "
              f"{rhat:.5f}; {'passes' if ok else 'FAILS'} the gate")
    return ok_all


def _opt_models(which, dtype, pkg):
    """(model, de) of an optimization cell in ``pkg`` (the JAX package or
    the port) at ``dtype``: the Rastrigin or the Gaussian MLE (the bench
    Gaussian's model in float32, the reference test's in float64)."""
    cell = {("rastrigin", 32): pc.OPT_RASTRIGIN_CELL,
            ("rastrigin", 64): pc.OPT_F64_RASTRIGIN_CELL,
            ("mle", 32): pc.OPT_MLE_CELL,
            ("mle", 64): pc.OPT_F64_MLE_CELL}[which, dtype]
    size = dict(Np=cell["Np"], n_groups=cell["n_groups"])
    size.update({"burnin": cell["burnin"]} if "burnin" in cell else {})
    f = np.float32 if dtype == 32 else np.float64
    if which == "rastrigin":
        return pkg.models.rastrigin.make(n_dim=cell["n_dim"], dtype=f,
                                         **size), cell
    data = pc.opt_mle_data(cell)
    opt = dict(update_particle="maximize", evaluate_fitness="fun")
    if dtype == 32:
        return pkg.models.gaussian.make(data=data, **size, **opt), cell
    if pkg is jdm:
        import jax
        import jax.numpy as jnp

        def loglike(data, mu, sigma):
            return jnp.sum(jax.scipy.stats.norm.logpdf(data, mu, sigma))

        def prior(key):
            k1, k2 = jax.random.split(key)
            return [jax.random.uniform(k1, minval=-5.0, maxval=5.0),
                    jax.random.uniform(k2, minval=0.1, maxval=5.0)]
        data = jnp.asarray(data)
    else:
        import torch

        def loglike(data, mu, sigma):
            x = torch.as_tensor(data, dtype=mu.dtype)
            s2 = sigma * sigma
            return torch.sum((torch.log(2.0 * np.pi * s2)
                              + (x - mu) * (x - mu) / s2) / -2.0)

        def prior(uniform, n):
            u = uniform(2)
            return [-5.0 + 10.0 * u[0], 0.1 + 4.9 * u[1]]
    model = pkg.DEModel(loglike=loglike, sample_prior=prior,
                        names=("mu", "sigma"), data=data)
    de = pkg.DE(bounds=((-np.inf, np.inf), (1e-6, np.inf)), dtype=f,
                **size, **opt)
    return (model, de), cell


def check_opt():
    from contextlib import nullcontext

    import jax
    tols = {32: (pc.OPT_BEST_F32, pc.OPT_ARGMIN_F32, pc.OPT_MLE_F32),
            64: (pc.OPT_BEST_F64, pc.OPT_ARGMIN_F64, pc.OPT_MLE_F64)}
    all_ok = True
    for dtype in (32, 64):
        best_tol, argmin_tol, mle_tol = tols[dtype]
        for which in ("rastrigin", "mle"):
            for pkg, keys in ((tdm, (0, 1, 2) if dtype == 32 else (None,)),
                              (jdm, (None,))):
                # the JAX package runs float64 with x64 on, float32 off
                ctx = (jax.enable_x64(dtype == 64) if pkg is jdm
                       else nullcontext())
                for key in keys:
                    kw = {"device": "cpu"} if pkg is tdm else {}
                    with ctx:
                        (model, de), cell = _opt_models(which, dtype, pkg)
                        key = cell["key"] if key is None else key
                        t0 = time.perf_counter()
                        pop = pkg.optimize(model, de, cell["n_iter"],
                                           key=key, **kw)
                        theta, best = pkg.get_optimal(de, model, pop)
                    secs = time.perf_counter() - t0
                    if which == "rastrigin":
                        ok, rows = pc.rastrigin_gate(best, theta["x"],
                                                     best_tol, argmin_tol)
                    else:
                        ok, rows = pc.mle_gate(theta["mu"], theta["sigma"],
                                               pc.opt_mle_data(cell),
                                               mle_tol)
                    print(f"[opt] {pkg.__name__}.optimize, {which}, "
                          f"float{dtype}, {de.n_chains} chains, "
                          f"{cell['n_iter']} iterations, key {key} "
                          f"({secs:.1f} s): {rows}; "
                          f"{'passes' if ok else 'FAILS'}", flush=True)
                    all_ok = all_ok and ok
    return all_ok


def check_kde_fresh(n_groups=16):
    from demcmc_tpu.models import abc_kde as jabc
    cell = pc.KDE_FRESH_CELL
    data, _ = pc.kde_inputs()
    t0 = time.perf_counter()
    oracle = pc.kde_fresh_oracle(data)
    print(f"[kde-fresh] oracle ({pc.KDE_FRESH_PANELS} panels): {oracle} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    jm, jde = jabc.make(data=data, n_sim=pc.KDE_N_SIM, Np=cell["Np"],
                        n_groups=n_groups, burnin=cell["burnin"],
                        fresh_noise=True, use_pallas=False)
    t0 = time.perf_counter()
    ch = jdm.sample(jm, jde, cell["n_iter"], key=0)
    secs = time.perf_counter() - t0
    ok, rows = pc.kde_gate(ch["mu"], ch["sigma"], oracle)
    return _report("kde-fresh", f"demcmc_tpu.sample, {jde.n_chains} chains",
                   cell["n_iter"], cell, secs, ok, rows,
                   np.asarray(ch.rhat()))


def check_abc_fixed(n_groups=8):
    import jax
    from demcmc_tpu.models import binomial as jbin
    from demcmc_tpu_torch.models import binomial as tbin
    cell = pc.ABC_FIXED_CELL
    kw = dict(N=cell["N"], k=cell["k"], abc=True, n_sim=pc.N_SIM,
              Np=cell["Np"], n_groups=n_groups, burnin=cell["burnin"])
    jax_panel = np.asarray(jax.random.uniform(jax.random.PRNGKey(123),
                                              (pc.N_SIM, cell["N"])))
    all_ok = True
    for tag, panel, run in (
            ("demcmc_tpu.sample", jax_panel,
             lambda: jdm.sample(*jbin.make(**kw), cell["n_iter"], key=0)),
            ("demcmc_tpu_torch.sample(device='cpu')",
             pc.abc_panel(pc.N_SIM, cell["N"]),
             lambda: tdm.sample(*tbin.make(**kw), cell["n_iter"], key=0,
                                device="cpu"))):
        oracle = pc.abc_fixed_oracle(panel, cell["k"])
        t0 = time.perf_counter()
        ch = run()
        secs = time.perf_counter() - t0
        ok, rows = pc.abc_fixed_gate(ch["theta"], oracle)
        all_ok = _report("abc-fixed", f"{tag}, {cell['Np'] * n_groups} "
                         f"chains (exact oracle {np.round(oracle, 5)})",
                         cell["n_iter"], cell, secs, ok, np.round(rows, 5),
                         np.asarray(ch.rhat())) and all_ok
    return all_ok


def _rep_rows(reps, datasets):
    """(worst |mean − oracle| of μ and σ over the replications, max R̂ over
    every replication and parameter) of a replicated run."""
    from demcmc_tpu_torch.models import gaussian as tg
    err, rhat = 0.0, 0.0
    for ch, x in zip(reps, datasets):
        truth = tg.posterior_grid(x)
        err = max(err, *(abs(float(ch.mean(k)) - truth[k]["mean"])
                         for k in ("mu", "sigma")))
        rhat = max(rhat, float(np.max(ch.rhat())))
    return err, rhat


def check_rep(n_port=4):
    """The replicated cell (``port_cells.REP_CELL``): the JAX package's
    ``sample_replicated`` (the vmapped XLA step) on all 64 replications
    at a third of the cell's length and at its length, and the port's
    plain path (``sample_replicated(device='cpu')``, each replication its
    solo run) on the first ``n_port``, each against every replication's
    quadrature oracle (``port_cells.REP_TOL``) with the max R̂."""
    import jax.numpy as jnp
    from demcmc_tpu.models import gaussian as jg
    from demcmc_tpu_torch.models import gaussian as tg
    cell = pc.REP_CELL
    data = pc.rep_datasets(cell)
    kw = dict(Np=cell["Np"], n_groups=cell["n_groups"],
              burnin=cell["burnin"], alpha=cell["alpha"])
    all_ok = True
    runs = [(f"demcmc_tpu.sample_replicated, {n_iter} iterations",
             n_iter, data, lambda n_iter=n_iter: jdm.sample_replicated(
                 jg.make_model, jdm.DE(bounds=jg.BOUNDS, **kw), n_iter,
                 jnp.asarray(data), key=cell["key"]))
            for n_iter in (cell["n_iter"] // 3, cell["n_iter"])]
    runs.append((f"demcmc_tpu_torch.sample_replicated(device='cpu'), "
                 f"{n_port} replications", cell["n_iter"], data[:n_port],
                 lambda: tdm.sample_replicated(
                     tg.make_model, tdm.DE(bounds=tg.BOUNDS, **kw),
                     cell["n_iter"], data[:n_port], key=cell["key"],
                     device="cpu")))
    for what, n_iter, x, run in runs:
        t0 = time.perf_counter()
        reps = run()
        secs = time.perf_counter() - t0
        err, rhat = _rep_rows(reps, x)
        ok = err < pc.REP_TOL
        good, word = _verdict(ok, rhat, n_iter, cell["n_iter"])
        all_ok = all_ok and good
        print(f"[rep] {what} ({secs:.1f} s): worst |posterior mean - "
              f"oracle| {err:.5f} (gate {pc.REP_TOL}), max R-hat "
              f"{rhat:.5f}; {word}")
    return all_ok


def check_opt_rep(n_port=8):
    """The replicated optimization cell (``port_cells.OPT_REP_CELL``):
    the JAX package's ``optimize_replicated`` (its XLA step, float32) on
    all 64 datasets and the port's plain path (K1's greedy max on the
    Gaussian's likelihood) on the first ``n_port``, each MLE against the
    closed form (``port_cells.OPT_REP_TOL``)."""
    import jax.numpy as jnp
    from demcmc_tpu.models import gaussian as jg
    from demcmc_tpu_torch.models import gaussian as tg
    cell = pc.OPT_REP_CELL
    data = pc.opt_rep_datasets(cell)
    kw = dict(Np=cell["Np"], n_groups=cell["n_groups"], burnin=0,
              update_particle="maximize", evaluate_fitness="fun")
    all_ok = True
    for what, pkg, mods, x in (
            ("demcmc_tpu.optimize_replicated", jdm, jg, data),
            ("demcmc_tpu_torch.optimize_replicated(device='cpu')", tdm, tg,
             data[:n_port])):
        de = pkg.DE(bounds=mods.BOUNDS, **kw)
        extra = {} if pkg is jdm else {"device": "cpu"}
        t0 = time.perf_counter()
        pops = pkg.optimize_replicated(
            mods.make_model, de, cell["n_iter"],
            jnp.asarray(x) if pkg is jdm else x, key=cell["key"], **extra)
        secs = time.perf_counter() - t0
        worst = 0.0
        for r, pop in enumerate(pops):
            theta, _ = pkg.get_optimal(de, mods.make_model(x[r]), pop)
            _, rows = pc.mle_gate(float(theta["mu"]), float(theta["sigma"]),
                                  x[r], pc.OPT_REP_TOL)
            worst = max(worst, *(abs(a - b) for a, b in rows.values()))
        ok = worst <= pc.OPT_REP_TOL
        all_ok = all_ok and ok
        print(f"[opt-rep] {what}, {len(x)} datasets, {cell['n_iter']} "
              f"iterations ({secs:.1f} s): worst |MLE - closed form| "
              f"{worst:.3g} (gate {pc.OPT_REP_TOL}); "
              f"{'passes' if ok else 'FAILS'}")
    return all_ok


CHECKS = {"lba": check_lba, "discrete": check_discrete, "kde": check_kde,
          "gauss-unfused": check_gauss_unfused, "lnr": check_lnr,
          "mcz-mig": check_mcz_mig, "blocked": check_blocked,
          "hier": check_hier, "opt": check_opt,
          "kde-fresh": check_kde_fresh, "abc-fixed": check_abc_fixed,
          "rep": check_rep, "opt-rep": check_opt_rep}

if __name__ == "__main__":
    names = sys.argv[1:] or list(CHECKS)
    ok = True
    for name in names:
        ok = CHECKS[name]() and ok
    sys.exit(0 if ok else 1)
