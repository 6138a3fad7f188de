"""DE optimization (port of ``demcmc_tpu.optimize``; reference
``src/optimize.jl`` and ``get_optimal``, ``src/utilities.jl:250-266``).

The sampling loop configured with a greedy accept (``update_particle=
'maximize'`` or ``'minimize'``) and the objective-only fitness
(``evaluate_fitness='fun'``), run with no trajectory; it returns the final
population.  A float32 configuration of a model whose CUDA objective K1
is built for with the greedy accept (``_build.GREEDY_DENSITIES``) runs
on K1 (and K2 between its windows); every other one, float64 and DE-MCz
among them, on the unfused step (:func:`.sampler.build_step`); under a
chain mesh, one of them per shard (:class:`.sampler.ShardedStep`).
:func:`optimize_replicated` runs R such optimizations, one dataset each,
as one replicated K1 batch (:class:`.sampler.RepStep`) or in turn.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import DE, MCMCThreads
from .model import DEModel
from .sampler import (_grow_history, _on_mesh, _phase2, _rep_devices,
                      _replicated_setup, _run_replicated, build_step,
                      init_state, make_spec, rep_supported, run_scan)


class Population(NamedTuple):
    """Final particle population: the reference's ``vcat(groups...)``."""
    theta: np.ndarray    # [C, d] flat parameters
    weight: np.ndarray   # [C] objective values
    spec: object

    def _params(self, i: int) -> list:
        """Chain ``i``'s parameter list, as numpy arrays."""
        return [p.numpy() for p in
                self.spec.unflatten(torch.as_tensor(self.theta[i]))]

    @property
    def particles(self):
        """The population as host-side :class:`demcmc_tpu_torch.Particle`
        objects (the reference's return type for ``optimize``)."""
        from .particle import Particle
        return [Particle(theta=self._params(i),
                         weight=float(self.weight[i]), id=i + 1)
                for i in range(self.theta.shape[0])]


def optimize(model: DEModel, de: DE, *args, key: int = 0,
             progress: bool = False, mesh=None, device=None) -> Population:
    """Find the optimum of ``model``'s loglike (reference ``optimize``,
    ``src/optimize.jl:17-38``; ``demcmc_tpu/optimize.py:41-83``):
    ``optimize(model, de, n_iter)`` or ``optimize(model, de,
    MCMCThreads(), n_iter)``, with ``evaluate_fitness='fun'`` and
    ``update_particle='maximize'`` (or ``'minimize'``).  The iteration
    starts at 1 (at ``n_initial + 1`` for DE-MCz, whose history needs
    it); no trajectory is stored.  ``key`` is the integer Philox seed;
    ``device`` is ``cuda`` unless the caller asks for the CPU; ``mesh``
    (a :func:`~demcmc_tpu_torch.parallel.chain_mesh`) splits the groups
    over its devices, as :func:`~demcmc_tpu_torch.sample` does;
    ``progress=True`` prints the JAX package's progress line (the run in
    20 chunks; the same population).  Returns the final
    :class:`Population` (:func:`get_optimal` picks its best particle)."""
    args = [a for a in args if not isinstance(a, MCMCThreads)]
    if len(args) != 1:
        raise TypeError("expected optimize(model, de, n_iter)")
    n_iter = int(args[0])
    _check_opt_config(de)
    devices, device = _on_mesh(mesh, device)
    spec = make_spec(model, de)
    start = None if de.uses_resample else 1   # reference: de.iter = iter
    state = _grow_history(init_state(model, de, spec, key, device=device,
                                     start_iteration=start), n_iter)
    step = build_step(model, de, spec,
                      device=device if mesh is None else None, mesh=mesh)
    if devices is not None:
        state = step.split(state)
    state, _ = run_scan(step, state, n_iter,
                        phase2=_phase2(step, de, state, n_iter),
                        collect=False, progress=progress)
    if devices is not None:
        state = step.gather(state)
    return Population(theta=state.theta.cpu().numpy(),
                      weight=state.weight.cpu().numpy(), spec=spec)


def _check_opt_config(de: DE):
    """Refuse what cannot be optimized (``demcmc_tpu/optimize.py:86-98``):
    the MH accept, and minimizing the posterior fitness (an out-of-bounds
    proposal scores -inf and would be 'optimal')."""
    if de.is_mh:
        raise ValueError(
            "optimize requires update_particle='maximize' or 'minimize' "
            "(and evaluate_fitness='fun'), like the reference")
    if de.is_minimize and de.evaluate_fitness == "posterior":
        raise ValueError(
            "minimize with the posterior fitness is ill-posed: "
            "out-of-bounds proposals score -inf and would be 'optimal'. "
            "Set evaluate_fitness='fun' (objective-only; out-of-bounds "
            "scores +inf when minimizing)")


def optimize_replicated(make_model, de: DE, n_iter: int, datasets, key=0,
                        keys=None, mesh=None, device=None) -> list:
    """R independent optimizations, one dataset each (per-subject MLE
    fits, objective sweeps), as one batch: the optimization twin of
    :func:`~demcmc_tpu_torch.sample_replicated` (``demcmc_tpu/
    optimize.py:101-141``; the same ``make_model``/``datasets``/``key``/
    ``keys``/``mesh`` contract), storing no trajectory.  Replication r is
    bit for bit ``optimize(make_model(datasets[r]), de, n_iter,
    key=seeds[r])``: where every replication takes K1 with its greedy
    accept (:func:`~demcmc_tpu_torch.sampler.rep_supported`) as one
    replicated K1 batch with the segmented K2, else in turn.  Returns a
    list of R :class:`Population`; feed each to :func:`get_optimal`."""
    _check_opt_config(de)
    models, seeds, spec = _replicated_setup(make_model, de, datasets, key,
                                            keys)
    devices, by_rep = _rep_devices(mesh, device, len(models))
    if not all(rep_supported(models, de, d) for d in set(by_rep)):
        return [optimize(m, de, n_iter, key=s, device=d)
                for m, s, d in zip(models, seeds, by_rep)]
    start = None if de.uses_resample else 1   # reference: de.iter = iter
    state, _ = _run_replicated(models, de, spec, seeds, n_iter, 1, devices,
                               by_rep[0], collect=False,
                               start_iteration=start)
    theta, weight = state.theta.cpu().numpy(), state.weight.cpu().numpy()
    c_rep = de.n_groups * de.Np
    return [Population(theta=theta[r * c_rep:(r + 1) * c_rep],
                       weight=weight[r * c_rep:(r + 1) * c_rep], spec=spec)
            for r in range(len(models))]


def get_optimal(de: DE, model: DEModel, particles: Population):
    """Best particle by weight (reference ``get_optimal``,
    ``src/utilities.jl:260-266``): returns ``(dict θ, best_value)``, the
    direction taken from the ``update_particle`` slot (argmax when
    maximizing, argmin else)."""
    w = particles.weight
    idx = int(np.argmax(w) if de.is_maximize else np.argmin(w))
    theta = dict(zip(particles.spec.names, particles._params(idx)))
    return theta, float(w[idx])
