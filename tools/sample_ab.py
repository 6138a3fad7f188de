"""Same-call A/B of ``sample()`` and ``optimize()`` on the host clock
between source trees, on one GPU, without a mesh.

    python3 tools/sample_ab.py [--profile CELL[,CELL...]] [--cells CELL[,CELL...]]
        LABEL=DIR [LABEL=DIR ...]

Each DIR is the root of a checkout (for example ``git archive`` of two
commits unpacked under ``_verify/``).  For each tree, in turns (the trees in
order, then in reverse), a process started in that tree builds its kernels
from its own sources and times the host-bound cells of its
``chip_smoke.py`` as a user calls them: the 4,096-chain Gaussian, the
blocked Gaussian, the discrete binomial, LBA, opt-mle and opt-rastrigin,
the 16,384-chain sequential Gaussian (``main-seq``, thin 10), the C = 512
DE-MCz Gaussian (``main-wide``) and its mcz-mig twin (α = 0.1, 5,000
iterations), and the device-bound 65,536-chain snooker Gaussian (thin 10)
as a control.  Each
cell runs once untimed, then ``REPEATS`` times between card
synchronisations; prints µs per iteration for each tree, cell and run,
then the card's name and power limit.  ``--cells`` times only the cells
named.  ``--profile`` also runs each cell named once more under
``cProfile`` in the first turn of each tree and writes the 30 functions
of most own time to ``chiprun_out/sample_ab_<label>_<cell>.prof``.
"""

import cProfile
import io
import json
import pstats
import subprocess
import sys
import time
from pathlib import Path

REPEATS = 3
OUT = Path(__file__).resolve().parent.parent / "chiprun_out"


def worker(label: str, profile: str, only: str):
    import torch
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian
    from demcmc_tpu_torch.ops import _build

    _build.build_all()
    data, pc = cs._gauss_data(), cs.pc
    bc, oc = pc.BLOCKED_CELL, pc.OPT_MLE_CELL
    rc, mc = pc.OPT_RASTRIGIN_CELL, pc.MCZ_MIG_CELL

    def zoo(name):
        case, cell = cs.ZOO[name]
        return case(burnin=cell["burnin"]), cell["n_iter"]

    cells = {
        "gauss4096": (gaussian.make(data=data, Np=cs.NP, n_groups=cs.G,
                                    burnin=cs.BURNIN), cs.N_ITER, {}),
        "blocked": (gaussian.make(data=data, Np=bc["Np"],
                                  n_groups=bc["n_groups"],
                                  burnin=bc["burnin"], blocks=bc["blocks"],
                                  blocking_on=True), bc["n_iter"], {}),
        "discrete": (*zoo("discrete"), {}),
        "lba": (*zoo("lba"), {}),
        "opt_mle": (cs._opt_model("mle")[:2], oc["n_iter"], {"opt": True}),
        "opt_rastrigin": (cs._opt_model("rastrigin")[:2], rc["n_iter"],
                          {"opt": True}),
        "seq16384": (gaussian.make(data=data, Np=cs.NSEQ, n_groups=cs.G65,
                                   burnin=cs.BURNIN, alpha=0.1,
                                   theta_snooker=0.1), cs.N_ITER,
                     {"thin": 10}),
        "mcz512": (gaussian.make(data=data, n_groups=mc["n_groups"],
                                 Np=mc["Np"], alpha=0.0, sample="resample",
                                 n_initial=mc["n_initial"],
                                 burnin=mc["burnin"],
                                 theta_snooker=mc["theta_snooker"],
                                 sweep="sync"), cs.N_ITER, {}),
        "mcz_mig": (gaussian.make(data=data, n_groups=mc["n_groups"],
                                  Np=mc["Np"], alpha=mc["alpha"],
                                  sample="resample",
                                  n_initial=mc["n_initial"],
                                  burnin=mc["burnin"],
                                  theta_snooker=mc["theta_snooker"],
                                  sweep="sync"), mc["n_iter"], {}),
        "snooker65k": (gaussian.make(data=data, Np=cs.N65, n_groups=cs.G65,
                                     burnin=cs.BURNIN, theta_snooker=0.1),
                       cs.N_ITER, {"thin": 10}),
    }
    res = {}
    for name, ((model, de), n_iter, kw) in cells.items():
        if only and name not in only.split(","):
            continue
        def run():
            if kw.get("opt"):
                tdm.optimize(model, de, n_iter, key=0)
            else:
                tdm.sample(model, de, n_iter, key=0, thin=kw.get("thin", 1))
        run()
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            res.setdefault(name, []).append(
                (time.perf_counter() - t0) / n_iter * 1e6)
        if name in profile.split(","):
            prof = cProfile.Profile()
            prof.runcall(run)
            torch.cuda.synchronize()
            text = io.StringIO()
            pstats.Stats(prof, stream=text).sort_stats("tottime") \
                .print_stats(30)
            OUT.mkdir(exist_ok=True)
            (OUT / f"sample_ab_{label}_{name}.prof").write_text(
                text.getvalue())
    print("RESULT " + json.dumps(res), flush=True)


def main():
    if sys.argv[1:2] == ["--worker"]:
        worker(*sys.argv[2:5])
        return
    args, opts = sys.argv[1:], {"--profile": "", "--cells": ""}
    while args[:1] and args[0] in opts:
        opts[args[0]], args = args[1], args[2:]
    profile, only = opts["--profile"], opts["--cells"]
    trees = [a.split("=", 1) for a in args]
    me = Path(__file__).resolve()
    results = {}
    for turn, order in enumerate((trees, trees[::-1])):
        for label, d in order:
            run = subprocess.run(
                [sys.executable, str(me), "--worker", label,
                 profile if turn == 0 else "", only],
                cwd=d, capture_output=True, text=True, timeout=900)
            line = [x for x in run.stdout.splitlines()
                    if x.startswith("RESULT ")]
            if run.returncode or not line:
                sys.exit(f"{label}: worker failed\n{run.stdout}\n{run.stderr}")
            for k, v in json.loads(line[0][7:]).items():
                results.setdefault((label, k), []).extend(v)
    for (label, k), v in sorted(results.items(), key=lambda x: x[0][::-1]):
        print(f"{k} {label}: {sum(v) / len(v):.2f} us/iteration ("
              + ", ".join(f"{x:.2f}" for x in v) + ")")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())


if __name__ == "__main__":
    main()
