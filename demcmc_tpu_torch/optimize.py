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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import DE, MCMCThreads
from .model import DEModel
from .sampler import (_grow_history, _on_mesh, _phase2,
                      build_step, init_state, make_spec, run_scan)


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
                        keys=None, mesh=None) -> list:
    """R independent optimizations as one batch (``demcmc_tpu/optimize.py:
    101``): not ported yet; raises, naming ROADMAP.md A8."""
    raise NotImplementedError(
        "optimize_replicated is not ported to demcmc_tpu_torch yet "
        "(ROADMAP.md A8, replicated runs); use demcmc_tpu for it")


def get_optimal(de: DE, model: DEModel, particles: Population):
    """Best particle by weight (reference ``get_optimal``,
    ``src/utilities.jl:260-266``): returns ``(dict θ, best_value)``, the
    direction taken from the ``update_particle`` slot (argmax when
    maximizing, argmin else)."""
    w = particles.weight
    idx = int(np.argmax(w) if de.is_maximize else np.argmin(w))
    theta = dict(zip(particles.spec.names, particles._params(idx)))
    return theta, float(w[idx])
