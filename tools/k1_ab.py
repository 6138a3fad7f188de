"""Same-call A/B of the K1 and K3 kernels between source trees, on one
GPU.

    python3 tools/k1_ab.py [--sass DENSITY] LABEL=DIR [LABEL=DIR ...]

Each DIR is the root of a checkout (for example ``git archive`` of two
commits unpacked under ``_verify/``).  For each tree, in turns (the trees in
order, then in reverse), a process started in that tree builds its K1
library from its own sources and times one-iteration K1 launches on the
ABC binomial (4,096 chains, n_sim = 10,000), discrete binomial (3,072) and
4,096-chain Gaussian cells past burn-in, and one-iteration K3 launches
at the 30-dim MVN flagship's shapes (C = 3, θs = 0.1), with
``chip_smoke.device_ms`` (launches queued behind a spin kernel, CUDA
events).  A tree whose ``de_step`` takes ``K`` also times windows of 64
iterations (no gate open before the last, the post variant), per
iteration.  The first turn of
each tree writes its library's per-function register and stack use
(``cuobjdump -res-usage``) and the SASS of the instantiations on one
density or more (``--sass``: the starts of their C++ class names, comma
separated, ``BinomialAbc`` by default) to ``chiprun_out/ab_<label>.res`` / ``ab_<label>_<density>.sass``.
Prints one line per tree and measurement, then the card's name and power
limit.
"""

import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

OUT = Path(__file__).resolve().parent.parent / "chiprun_out"
WINDOW_K = 64
IT = 2000


def worker(label: str, dump: str):
    import torch
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch.models import gaussian
    from demcmc_tpu_torch.ops import _build, fused_step

    dev = torch.device("cuda")
    windows = "K" in inspect.signature(fused_step.de_step).parameters
    cells = {"abc": cs._abc_case(1000), "discrete": cs._disc_case(1000),
             "gauss": gaussian.make(data=cs._gauss_data(), Np=cs.NP,
                                    n_groups=cs.G, burnin=1000)}
    res = {}
    for name, (model, de) in cells.items():
        spec = tdm.make_spec(model, de)
        cfg = fused_step.StepConfig.make(model, de, spec)
        s = tdm.init_state(model, de, spec, 5, device=dev)
        C = de.n_chains
        st = (s.theta, s.weight, s.fire)
        out = (torch.empty((C, cfg.d), device=dev),
               torch.empty(C, device=dev),
               torch.empty(C, dtype=torch.bool, device=dev))
        n = 20 if name == "abc" else 200
        res[name] = cs.device_ms(lambda: fused_step.de_step(
            cfg, model, spec, *st, IT, out=out), n)[0]
        if windows:
            seed, it0 = cs.quiet_start(0, cfg, IT, 1 << 16, WINDOW_K)
            wout = (torch.empty((WINDOW_K, C, cfg.d), device=dev),
                    torch.empty((WINDOW_K, C), device=dev),
                    torch.empty((WINDOW_K, C), dtype=torch.bool, device=dev))
            ms = cs.device_ms(lambda: fused_step.de_step(
                cfg, model, spec, *st, it0, seed=seed, out=wout, K=WINDOW_K,
                phase="post"), 2 if name == "abc" else 20)[0]
            res[name + "_window_per_iteration"] = ms / WINDOW_K
    from demcmc_tpu_torch.ops import resample_step
    model, spec, cfg, s = cs._resample_case(dev, "mvn", burnin=2000,
                                            theta_sn=0.1, key=4,
                                            extra_rows=3000)
    st = (s.theta, s.weight, s.fire, s.history)
    out = (torch.empty((3, cfg.d), device=dev), torch.empty(3, device=dev),
           torch.empty(3, dtype=torch.bool, device=dev))
    res["mvn_k3"] = cs.device_ms(lambda: resample_step.resample_step(
        cfg, model, spec, *st, IT + 500, out=out), 200)[0]
    if windows:
        wout = (torch.empty((WINDOW_K, 3, cfg.d), device=dev),
                torch.empty((WINDOW_K, 3), device=dev),
                torch.empty((WINDOW_K, 3), dtype=torch.bool, device=dev))
        ms = cs.device_ms(lambda: resample_step.resample_step(
            cfg, model, spec, *st, IT + 500, out=wout, K=WINDOW_K,
            phase="post"), 20)[0]
        res["mvn_k3_window_per_iteration"] = ms / WINDOW_K
    print("RESULT " + json.dumps(res), flush=True)
    if dump:
        lib = _build.build_all(("de_step",))["de_step"]
        run = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-res-usage",
                              str(lib)], capture_output=True, text=True)
        (OUT / f"ab_{label}.res").write_text(run.stdout + run.stderr)
        sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                               str(lib)], capture_output=True,
                              text=True).stdout
        parts = re.split(r"(?=\n\s*Function : )", sass)
        for name in dump.split(","):
            (OUT / f"ab_{label}_{name}.sass").write_text(
                "".join(p for p in parts if name in p.split("\n", 2)[1]))


def main():
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], sys.argv[3])
        return
    args, dump = sys.argv[1:], "BinomialAbc"
    if args[:1] == ["--sass"]:
        dump, args = args[1], args[2:]
    trees = [a.split("=", 1) for a in args]
    OUT.mkdir(exist_ok=True)
    me = Path(__file__).resolve()
    results = {}
    for turn, order in enumerate((trees, trees[::-1])):
        for label, d in order:
            run = subprocess.run(
                [sys.executable, str(me), "--worker", label,
                 dump if turn == 0 else ""],
                cwd=d, capture_output=True, text=True, timeout=900)
            line = [x for x in run.stdout.splitlines()
                    if x.startswith("RESULT ")]
            if run.returncode or not line:
                sys.exit(f"{label}: worker failed\n{run.stdout}\n{run.stderr}")
            for k, v in json.loads(line[0][7:]).items():
                results.setdefault((label, k), []).append(v)
    for (label, k), v in results.items():
        print(f"{label} {k}: {sum(v) / len(v):.6f} ms on the device ("
              + ", ".join(f"{x:.6f}" for x in v) + ")")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())


if __name__ == "__main__":
    main()
