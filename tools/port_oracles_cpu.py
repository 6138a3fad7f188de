"""Hold the JAX package and the port's plain path to the posterior gates of
the port's LBA and discrete binomial cells (``port_cells.py``) on the CPU,
so that the GPU's run (``chip_smoke.py``) relies on gates and run lengths
the reference meets.

    JAX_PLATFORMS=cpu python tools/port_oracles_cpu.py

1. LBA (100 trials, numpy seed 0): ``port_cells.lba_oracle``, then
   ``demcmc_tpu.sample`` (the JAX package's XLA step) with 256 chains at
   the cell's length, and with the cell's 4,096 chains at 3,000 iterations
   and at the cell's length, each through ``port_cells.lba_gate`` with its
   max R̂.
2. Discrete binomial (the cell's 3,072 chains, float32): ``demcmc_tpu.
   sample`` and ``demcmc_tpu_torch.sample(device='cpu')`` at 3,000
   iterations and at the cell's length, each through
   ``port_cells.discrete_gate`` with its max R̂.

Prints one line per run; exits non-zero if a run at the cell's length
fails its gate or R̂ ≥ ``port_cells.RHAT_MAX``.  About three minutes on
four cores.
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


if __name__ == "__main__":
    ok = check_lba()
    ok = check_discrete() and ok
    sys.exit(0 if ok else 1)
