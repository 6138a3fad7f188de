"""Same-call A/B of K1 and K3 windows between source trees, on one GPU:
device µs an iteration of the cases of ``tools/sweep_phases.py``.

    python3 tools/window_ab.py LABEL=DIR [LABEL=DIR ...]

Each DIR is the root of a checkout (for example a copy of this tree with
one constant of ``demcmc_tpu_torch/csrc/step_body.cuh`` changed, such as
the block size ``kHoistThreadsTarget``).  For each tree, in turns (the
trees in order, then in reverse), a process started in that tree builds
K1 and K3 from its own sources and times windows of 64 iterations of K1 on
the 4,096-chain Gaussian, ``main-seq``'s 4,096 × 4 and the blocked cell,
and of K3 on the C = 512 DE-MCz Gaussian, each in burn-in and past it
(``sweep_phases.make_case``, ``chip_smoke.device_ms``: 20 windows queued
behind a spin kernel, CUDA events).  Prints each case's µs an iteration
for every tree and turn, then the card's name and power limit.
"""

import json
import subprocess
import sys
from pathlib import Path

CASES = ("k1-gauss-4096", "k1-seq-4096x4", "k1-blocked-4096", "k3-C512")
ME = Path(__file__).resolve()


def worker():
    import torch
    sys.path.insert(0, str(Path.cwd()))
    sys.path.insert(0, str(ME.parent))
    import chip_smoke as cs
    import sweep_phases as sp
    from demcmc_tpu_torch.ops import _build

    _build.build_all(("de_step", "de_step_resample"))
    dev = torch.device("cuda")
    res = {}
    for case in CASES:
        for tag, burn in (("burn-in", True), ("post", False)):
            run = sp.make_case(cs, case, dev, burn)
            res[f"{case} {tag}"] = cs.device_ms(run, 20)[0] * 1e3 / 64
    print("RESULT " + json.dumps(res), flush=True)


def main():
    if sys.argv[1:2] == ["--worker"]:
        worker()
        return
    trees = [a.split("=", 1) for a in sys.argv[1:]]
    out = {}
    for order in (trees, trees[::-1]):
        for label, d in order:
            run = subprocess.run([sys.executable, str(ME), "--worker"],
                                 cwd=d, capture_output=True, text=True,
                                 timeout=900)
            line = [x for x in run.stdout.splitlines()
                    if x.startswith("RESULT ")]
            if run.returncode or not line:
                sys.exit(f"{label}: worker failed\n{run.stdout}\n{run.stderr}")
            for k, v in json.loads(line[0][7:]).items():
                out.setdefault(k, {}).setdefault(label, []).append(v)
    for k, d in out.items():
        print(f"{k}: " + ", ".join(
            f"{label} " + " / ".join(f"{v:.3f}" for v in vs)
            for label, vs in d.items()) + " µs an iteration")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
