"""In one process on one GPU, ``sample()``'s and ``optimize()``'s run loop
(``sampler.run_scan``: the chunk loop, only the kept rows stored and
streamed to pinned host memory) against the loop it replaced (the whole
trajectory on the card, the windows through ``Step.advance``, one
pageable ``.cpu()`` at the end), in turns, so that both see the same host:

    python3 tools/run_scan_ab.py [REPEATS]

Cells: the 4,096-chain Gaussian, opt-mle, opt-rastrigin, mcz-mig and the
65,536-chain snooker Gaussian (thin 10), as ``tools/sample_ab.py`` builds
them.  Each cell runs once untimed per loop, then ``REPEATS`` (default
5) rounds of (replaced, new, new, replaced) between card
synchronisations; the two loops' draws must be equal bit for bit.
Prints µs per iteration of each loop and cell, every run, and the
card's name and power limit.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def replaced_run_scan(step, state, n_iter, thin=1, phase2=None,
                      collect=True, *, skip=0, **_):
    """The run loop before the chunked run: every row stored on the card,
    windows through ``Step.advance`` (or one iteration at a time), one
    pageable copy at the end; the first ``skip`` rows dropped on the host
    after it."""
    from demcmc_tpu_torch import sampler
    if not sampler._kernels(step):
        state, ys = sampler.run_loop(step, state, n_iter, thin, collect)
    else:
        state, ys = sampler._trajectory_run(
            step, state, n_iter, thin,
            lambda s, traj: step.advance(s, n_iter, thin, traj,
                                         switch=phase2), collect)
    if ys is None:
        return state, None
    return state, sampler.StepOutput(*(x[skip:] for x in ys))


def main():
    import numpy as np
    import torch
    import chip_smoke as cs
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import optimize as topt
    from demcmc_tpu_torch import sampler
    from demcmc_tpu_torch.models import gaussian
    from demcmc_tpu_torch.ops import _build

    repeats = int(sys.argv[1]) if sys.argv[1:] else 5
    _build.build_all()
    data, pc = cs._gauss_data(), cs.pc
    mc = pc.MCZ_MIG_CELL
    cells = {
        "gauss4096": (gaussian.make(data=data, Np=cs.NP, n_groups=cs.G,
                                    burnin=cs.BURNIN), cs.N_ITER, {}),
        "opt_mle": (cs._opt_model("mle")[:2], pc.OPT_MLE_CELL["n_iter"],
                    {"opt": True}),
        "opt_rastrigin": (cs._opt_model("rastrigin")[:2],
                          pc.OPT_RASTRIGIN_CELL["n_iter"], {"opt": True}),
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
    new = sampler.run_scan
    loops = {"replaced": replaced_run_scan, "new": new}
    res = {}
    try:
        for name, ((model, de), n_iter, kw) in cells.items():
            def run(loop):
                sampler.run_scan = topt.run_scan = loops[loop]
                if kw.get("opt"):
                    pop = tdm.optimize(model, de, n_iter, key=0)
                    return pop.theta, pop.weight
                ch = tdm.sample(model, de, n_iter, key=0,
                                thin=kw.get("thin", 1))
                return ch.data, ch.lp
            out = {d: run(d) for d in loops}
            for a, b in zip(out["replaced"], out["new"]):
                if np.asarray(a).tobytes() != np.asarray(b).tobytes():
                    sys.exit(f"{name}: the two loops' results differ")
            for _ in range(repeats):
                for d in ("replaced", "new", "new", "replaced"):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run(d)
                    torch.cuda.synchronize()
                    res.setdefault((name, d), []).append(
                        (time.perf_counter() - t0) / n_iter * 1e6)
    finally:
        sampler.run_scan = topt.run_scan = new
    for (name, d), v in res.items():
        print(f"{name} {d}: {np.mean(v):.2f} us/iteration (median "
              f"{np.median(v):.2f}; " + ", ".join(f"{x:.2f}" for x in v)
              + ")")
    print(json.dumps({f"{n} {d}": float(np.median(v))
                      for (n, d), v in res.items()}))
    print(cs.gpu_line())


if __name__ == "__main__":
    main()
