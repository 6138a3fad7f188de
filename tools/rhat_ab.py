"""Same-process A/B of the port's host-side diagnostics between source
trees: rank-normalized R̂ and bulk ESS of every parameter, as
``Chains.rhat()`` and ``Chains.ess()`` call them.

    python3 tools/rhat_ab.py [--n N] [--c C] [--p P] LABEL=DIR [LABEL=DIR ...]

Each DIR is the root of a checkout (for example ``git archive`` of the
parent unpacked under ``_verify/parent``, and ``.``).  Each tree's
``demcmc_tpu_torch/diagnostics.py`` (numpy only) is loaded on its own, and
called on every parameter in turn as ``Chains.rhat()`` and ``Chains.ess()``
call it (one dict of tables shared by the parameters, where the tree's
functions take one).  Three sets of ``[N, P, C]`` draws (1,000 × 5 × 4,096 by
default) from seed 0 are timed: the port's own ``sample()`` on the CPU (a
normal model's mean and σ, 4,096 chains: rejected proposals repeat a draw,
so ranks tie as in a run), random-walk chains of unrounded normal steps,
whose values never tie, and normal values rounded to 3 decimals so that
ranks tie more, with a block of ±0.0.  The trees are timed in turns (in
order, then in reverse), each turn from a fresh module; prints seconds for each set, tree and turn, the CPU it ran on, and
fails unless every tree's values are bitwise equal.
"""

import argparse
import importlib.util
import inspect
import platform
import sys
import time
from pathlib import Path

import numpy as np


def load(label: str, root: str):
    path = Path(root) / "demcmc_tpu_torch" / "diagnostics.py"
    spec = importlib.util.spec_from_file_location(f"diag_{label}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cpu_name() -> str:
    try:
        for line in open("/proc/cpuinfo"):
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def run(diag, draws):
    shared = "tables" in inspect.signature(diag.rank_normalized_rhat).parameters

    def each(fn):
        kw = {"tables": {}} if shared else {}
        return [fn(draws[:, i, :], **kw) for i in range(draws.shape[1])]
    t0 = time.perf_counter()
    rhat = each(diag.rank_normalized_rhat)
    t1 = time.perf_counter()
    ess = each(diag.ess_bulk)
    t2 = time.perf_counter()
    return np.array(rhat + ess), t1 - t0, t2 - t1


def sampler_draws(n, p, c, burnin=200):
    """[n, p, c] draws of the port's ``sample()`` on the CPU (this script's
    own tree): the mean of a (p − 1)-dim normal and its σ
    (``models/mvnormal.py``), c chains in groups of 16, migration at α =
    0.1, ``burnin`` iterations discarded.  A rejected proposal repeats its
    chain's draw, so ranks tie as in a sampler's output."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import mvnormal
    torch.set_num_threads(2)
    model, de = mvnormal.make(d=p - 1, Np=16, n_groups=c // 16,
                              burnin=burnin, sample=None, n_initial=0,
                              alpha=0.1)
    chains = tdm.sample(model, de, n + burnin, key=0, device="cpu")
    print(f"[rhat-ab] sampler draws: acceptance "
          f"{chains.acceptance.mean():.4f}", flush=True)
    return np.ascontiguousarray(chains.data[-n:], dtype=np.float64)


def draw_sets(n, p, c):
    """name -> draws [n, p, c]: the sampler's, unrounded random walks (no
    ties), and rounded values (many ties, ±0.0)."""
    g = np.random.default_rng(0)
    walk = np.cumsum(g.normal(size=(n, p, c)), axis=0) * 0.1 \
        + g.normal(size=(n, p, c))
    tied = np.round(g.normal(size=(n, p, c)), 3)
    tied[: n // 10, :, : c // 8] = 0.0
    tied[: n // 20, :, : c // 16] = -0.0
    return {"sampler": sampler_draws(n, p, c), "unrounded": walk,
            "tied": tied}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--c", type=int, default=4096)
    ap.add_argument("--p", type=int, default=5)
    ap.add_argument("trees", nargs="+")
    a = ap.parse_args()
    trees = [t.split("=", 1) for t in a.trees]
    same = True
    for name, draws in draw_sets(a.n, a.p, a.c).items():
        values = {}
        for turn, (label, root) in enumerate(trees + trees[::-1]):
            diag = load(f"{label}{turn}", root)
            v, t_rhat, t_ess = run(diag, draws)
            values.setdefault(label, v)
            ok = np.array_equal(v.view(np.int64),
                                values[label].view(np.int64))
            print(f"[rhat-ab] {name} turn {turn} {label}: rhat "
                  f"{t_rhat:.3f} s, ess_bulk {t_ess:.3f} s, total "
                  f"{t_rhat + t_ess:.3f} s ({a.n} x {a.p} x {a.c} draws; "
                  f"same as its first turn: {ok})", flush=True)
            if not ok:
                sys.exit(1)
        first = next(iter(values.values()))
        eq = all(np.array_equal(v.view(np.int64), first.view(np.int64))
                 for v in values.values())
        print(f"[rhat-ab] {name}: values bitwise equal across trees: {eq}")
        same = same and eq
    print(f"[rhat-ab] cpu: {cpu_name()}")
    sys.exit(0 if same else 1)


if __name__ == "__main__":
    main()
