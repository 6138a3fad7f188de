"""In one process on one GPU, the unfused step with its sweeps as CUDA
graphs (``sampler.GRAPHS = True``, the default) against every iteration
eager (``GRAPHS = False``), in turns (eager, graphed, graphed, eager):

    python3 tools/unfused_graph_ab.py [CELL ...]

Cells (``sample(..., allow_fused=False)`` unless named ``opt``): ``hier``
(the hierarchical model, ``port_cells.HIER_CELL``'s width, 1,000
iterations across a burn-in of 500), ``gauss`` (the 4,096-chain Gaussian,
600 across 300), ``mcz`` (the DE-MCz Gaussian at C = 512 with α = 0.1
and snooker, 600), ``blocked-fn`` (the 4,096-chain Gaussian with two
blocks and a ``blocking_on`` that changes with the iteration, 300),
``lnr`` (``port_cells.LNR_CELL``'s width, 300), ``abc-fixed``
(``port_cells.ABC_FIXED_CELL``'s width, 300), ``lv`` (Lotka–Volterra, 36
chains, 12), ``opt`` (the float64 Rastrigin of ``examples/optimize.py``,
1,000), ``kde`` (the fixed abc_kde cell, whose density launches K4: its
step stays eager, 60) and ``lba`` (LBA at 4,096 chains, whose density
copies a table from pageable host memory each evaluation: its capture
fails and its step stays eager, 60).  Each cell's four runs must be
equal bit for bit.  Prints µs per iteration of each run, whether the
graphed step kept its graphs (or why it turned eager), and the card's
name and power limit.
"""

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _cells():
    import port_cells as pc
    from demcmc_tpu_torch.models import (abc_kde, binomial, gaussian,
                                         hierarchical, lba, lnr,
                                         lotka_volterra, rastrigin)
    data = np.random.default_rng(0).standard_normal(50).astype(np.float32)
    h = pc.HIER_CELL
    c = pc.ABC_FIXED_CELL
    return {
        "hier": (hierarchical.make(n_subj=h["n_subj"], n_data=h["n_data"],
                                   key=h["key"], burnin=500), 1000, False),
        "gauss": (gaussian.make(data=data, Np=16, n_groups=256,
                                burnin=300), 600, False),
        "mcz": (gaussian.make(data=data, Np=4, n_groups=128, burnin=300,
                              sample="resample", n_initial=50, alpha=0.1,
                              theta_snooker=0.1, sweep="sync"), 600, False),
        "blocked-fn": (gaussian.make(
            data=data, Np=16, n_groups=256, burnin=150,
            blocks=((True, False), (False, True)),
            blocking_on=lambda de: de.iter % 3 != 0), 300, False),
        "lnr": (lnr.make(Np=pc.LNR_CELL["Np"],
                         n_groups=pc.LNR_CELL["n_groups"], burnin=150),
                300, False),
        "abc-fixed": (binomial.make(N=c["N"], k=c["k"], abc=True,
                                    Np=c["Np"], n_groups=c["n_groups"],
                                    burnin=150), 300, False),
        "lv": (lotka_volterra.make(Np=12, n_groups=3, burnin=6), 12, False),
        "opt": (rastrigin.make(n_dim=2, Np=10, n_groups=4), 1000, True),
        "kde": (abc_kde.make(n_groups=512, Np=6, burnin=30), 60, False),
        "lba": (lba.make(Np=16, n_groups=256, burnin=30), 60, False),
    }


def _run(model, de, n_iter, opt, graphs):
    import torch

    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import sampler
    sampler.GRAPHS = graphs
    made = []
    init = sampler.UnfusedStep.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        made.append(self)
    sampler.UnfusedStep.__init__ = record
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            if opt:
                out = tdm.optimize(model, de, n_iter, key=1)
                arrays = (out.theta, out.weight)
            else:
                out = tdm.sample(model, de, n_iter, key=1,
                                 allow_fused=False)
                arrays = (out.data, out.acceptance)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        sampler.UnfusedStep.__init__ = init
        sampler.GRAPHS = True
    step = made[-1]
    graphs = ("kept" if step._graphs is not None
              else f"eager ({step.eager_reason or 'GRAPHS off'})")
    return [np.asarray(a) for a in arrays], dt / n_iter * 1e6, graphs


def main():
    import torch
    cells = _cells()
    names = sys.argv[1:] or list(cells)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"[graph-ab] torch {torch.__version__}, {card}", flush=True)
    ok = True
    for name in names:
        (model, de), n_iter, opt = cells[name]
        _run(model, dataclasses.replace(de, burnin=5), 20, opt, True)
        runs = [_run(model, de, n_iter, opt, g)
                for g in (False, True, True, False)]
        same = all(len(r[0]) == len(runs[0][0]) and all(
            a.tobytes() == b.tobytes() for a, b in zip(r[0], runs[0][0]))
            for r in runs)
        ok = ok and same
        print(f"[graph-ab] {name}: {de.n_chains} chains, {n_iter} "
              f"iterations; us/iteration eager {runs[0][1]:.2f}, "
              f"{runs[3][1]:.2f}; graphed {runs[1][1]:.2f}, "
              f"{runs[2][1]:.2f} (graphs: {runs[1][2]}); ratio "
              f"{(runs[1][1] + runs[2][1]) / (runs[0][1] + runs[3][1]):.4f}"
              f"; {'equal bit for bit' if same else 'DIFFERENT DRAWS'}",
              flush=True)
    print(f"[graph-ab] card: {card}")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
