"""demcmc_tpu_torch — Differential Evolution MCMC in PyTorch and CUDA.

The port of :mod:`demcmc_tpu` (JAX, TPU) to one NVIDIA H100, beside it in
the same repository; the JAX package stays the reference the port is
tested against.  It carries ``sample(model, de, n_iter)`` with the
synchronous or sequential DE sweep, the snooker proposal, migration and
DE-MCz resampling from the history, and ``optimize(model, de, n_iter)``
with the greedy accepts, in float32 or float64, through hand-written CUDA
kernels
(``csrc/de_step.cu``, ``csrc/de_step_resample.cu``, ``csrc/migration.cu``)
for models that name a CUDA density, and through the unfused step (the
JAX XLA step's twin, plain torch around the model's own torch density)
for every other model, whose density may launch a kernel of its own
(``csrc/kde.cu``); ``mesh=chain_mesh(...)`` splits a run's groups over
devices (:mod:`.parallel`); ``progress``, ``checkpoint_every`` (with
:func:`save_state`/:func:`load_state`), ``monitor`` and ``stop_rhat`` ride
on the JAX package's chunked run; ``sample_replicated``,
``sample_replicated_packed`` and ``optimize_replicated`` run R datasets'
runs as one batch (a replicated K1 launch a window).  Each kernel has a
plain PyTorch version beside it for CPU tensors.  Exports keep the JAX
package's names.
"""

from . import diagnostics, models, ops, parallel, utils
from .chains import Chains
from .config import DE, MCMCThreads
from .diagnostics import (ess, ess_bulk, ess_tail, rank_normalized_rhat,
                          split_rhat)
from .model import CudaDensity, DEModel, ParamSpec
from .ops.accept import (compute_posterior, evaluate_fun, greedy_update,
                         maximize, mh_update, minimize)
from .ops.proposals import (fixed_gamma, random_gamma, resample,
                            sample_current, snooker, variable_gamma)
from .optimize import (Population, get_optimal, optimize,
                       optimize_replicated)
from .particle import Particle
from .parallel import chain_mesh
from .sampler import (SamplerState, ShardedStep, UnfusedStep, build_step,
                      init_state, make_spec, run_scan, sample,
                      sample_replicated, sample_replicated_packed,
                      state_from_numpy)
from .utils.checkpoint import load_state, save_state
from .utils.pytree import as_union

__version__ = "0.1.0"

# the module's alias, as the reference's `const DEMCMC =
# DifferentialEvolutionMCMC`
import sys as _sys
DEMCMC = _sys.modules[__name__]

__all__ = [
    "DE", "DEModel", "MCMCThreads", "Chains", "ParamSpec", "CudaDensity",
    "Particle", "Population",
    "SamplerState", "UnfusedStep", "ShardedStep", "chain_mesh", "sample",
    "sample_replicated", "sample_replicated_packed", "init_state",
    "make_spec",
    "build_step", "optimize", "optimize_replicated", "get_optimal",
    "mh_update", "maximize", "minimize", "greedy_update",
    "compute_posterior", "evaluate_fun",
    "run_scan", "state_from_numpy", "random_gamma", "fixed_gamma",
    "variable_gamma", "snooker", "resample", "sample_current", "as_union",
    "save_state", "load_state", "DEMCMC", "split_rhat", "rank_normalized_rhat", "ess",
    "ess_bulk", "ess_tail", "diagnostics", "models", "ops", "parallel",
    "utils",
]
