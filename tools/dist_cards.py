"""``sample(mesh=global_chain_mesh())`` over several processes, one rank
per card (or ranks sharing one card), each rank's result held against the
single-process run.

    torchrun --standalone --nproc-per-node=N tools/dist_cards.py \\
        [--backend nccl|gloo] [--device cuda:0|cpu] [--n-iter-scale S]

Every rank joins the group (``parallel.distributed.initialize``: by
default NCCL with a card a rank, ``cuda:LOCAL_RANK``; ``--backend gloo
--device cuda:0`` puts every rank on one card, its collectives staged
through pinned host memory; ``--device cpu`` runs gloo CPU ranks, a
rehearsal with ``--n-iter-scale`` well below 1).  Each cell runs first on
the rank's own device in one process (the unsharded run), then over the
group through ``global_chain_mesh()``: the 4,096-chain bench Gaussian
(kernels' step, α = 0.1, 3,000 iterations) and the mcz-mig cell
(``port_cells.MCZ_MIG_CELL``: the C = 512 DE-MCz Gaussian, α = 0.1, 5,000
iterations).  Every rank's ``Chains`` must equal its unsharded run bit for
bit, and on a card K1 (K3: once an iteration) runs on its own shard as
the gates' plan says and K2 once per open gate; any difference raises.
Rank 0 prints one line ``DIST {json}``: the backend, the world size, µs
per iteration of each cell in one process and over the group, and each
rank's launches.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _cells(scale: float):
    import port_cells as pc
    from demcmc_tpu_torch.models import gaussian
    data = np.random.default_rng(0).standard_normal(50).astype(np.float32)
    cell = pc.MCZ_MIG_CELL
    n_g, n_m = max(int(3000 * scale), 40), max(int(cell["n_iter"] * scale),
                                                40)
    return {
        "gauss": (gaussian.make(data=data, Np=16, n_groups=256,
                                burnin=min(1000, n_g // 2), alpha=0.1),
                  n_g),
        "mcz-mig": (gaussian.make(
            data=data, n_groups=cell["n_groups"], Np=cell["Np"],
            alpha=cell["alpha"], sample="resample",
            n_initial=cell["n_initial"],
            burnin=min(cell["burnin"], n_m // 2),
            theta_snooker=cell["theta_snooker"], sweep="sync"), n_m),
    }


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches():
    from demcmc_tpu_torch.ops import fused_step, migration, resample_step
    return {"de_step": fused_step.de_step.launches,
            "resample_step": resample_step.resample_step.launches,
            "migrate": migration.migrate.launches}


def _reset():
    from demcmc_tpu_torch.ops import fused_step, migration, resample_step
    fused_step.de_step.launches = 0
    resample_step.resample_step.launches = 0
    migration.migrate.launches = 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--n-iter-scale", type=float, default=1.0)
    args = ap.parse_args()
    import torch
    import demcmc_tpu_torch as tdm
    from demcmc_tpu_torch import rng
    from demcmc_tpu_torch.ops import fused_step
    from demcmc_tpu_torch.parallel import distributed as dist
    lay = dist.initialize(backend=args.backend, device=args.device)
    if lay is None:
        sys.exit("dist_cards: run under torchrun (no RANK/WORLD_SIZE)")
    torch.set_num_threads(1)
    rank, world, dev = dist.rank(), dist.world_size(), lay.device
    mesh = dist.global_chain_mesh()
    out = {"backend": lay.backend, "staged": lay.staged, "world": world,
           "devices": [str(d) for d in mesh.devices]}
    for name, ((model, de), n_iter) in _cells(args.n_iter_scale).items():
        spec = tdm.make_spec(model, de)
        cfg = fused_step.StepConfig.make(model, de, spec)
        secs = {}
        for how in ("one", "group"):
            _reset()
            torch.distributed.barrier()
            _sync(dev)
            t0 = time.perf_counter()
            if how == "one":
                ref = tdm.sample(model, de, n_iter, key=0, device=dev)
            else:
                got = tdm.sample(model, de, n_iter, key=0, mesh=mesh)
            _sync(dev)
            secs[how] = time.perf_counter() - t0
            counts = _launches()
        for what in ("data", "lp", "acceptance"):
            a, b = getattr(got, what), getattr(ref, what)
            if a.shape != b.shape or a.tobytes() != b.tobytes():
                raise AssertionError(f"rank {rank} {name}: {what} differs "
                                     f"from the single-process run")
        # launches over the group: this rank's shard stepped as planned,
        # K2 once per open gate (every rank on the gathered population)
        it0 = de.n_initial + 1
        gates = rng.gates(0, it0, n_iter, cfg.rows.fire, cfg.alpha)
        u0 = float(rng.to_uni(rng.words(0, it0, 1, 1, ns=rng.GATE_NS))[0, 0])
        opened = int(u0 <= np.float32(cfg.alpha)) + int(gates[:-1].sum())
        k = "resample_step" if de.uses_resample else "de_step"
        step = tdm.build_step(model, de, spec, mesh=mesh)
        st = step.split(tdm.sampler._grow_history(
            tdm.init_state(model, de, spec, 0, device=dev), n_iter))
        windows = len(step.plan(st, n_iter, switch=tdm.sampler._phase2(
            step, de, st, n_iter)))
        want = {"de_step": 0, "resample_step": 0, k: windows,
                "migrate": opened}
        if dev.type == "cuda" and counts != want:    # (CPU: plain calls)
            raise AssertionError(f"rank {rank} {name}: launches {counts}, "
                                 f"expected {want}")
        out[name] = {"one_us_per_iteration": secs["one"] / n_iter * 1e6,
                     "group_us_per_iteration": secs["group"] / n_iter * 1e6,
                     "n_iter": n_iter, "launches": counts}
        print(f"[dist rank {rank}] {name}: {n_iter} iterations, one "
              f"process {secs['one'] / n_iter * 1e6:.2f} us/iteration, "
              f"{world} ranks ({lay.backend}"
              f"{', staged' if lay.staged else ''}) "
              f"{secs['group'] / n_iter * 1e6:.2f} us/iteration; bit for "
              f"bit the single-process run; launches {counts}", flush=True)
    rows = [None] * world
    torch.distributed.all_gather_object(rows, out)
    if dist.is_coordinator():
        print("DIST " + json.dumps({"ranks": rows}), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
