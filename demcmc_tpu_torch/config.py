"""DE sampler configuration (the port's copy of ``demcmc_tpu.config``).

Same fields, names and defaults as the JAX package's frozen ``DE``
(reference ``src/structs.jl:57-131``; unicode spelled out: α→alpha,
β→beta, ϵ→epsilon, σ→sigma, κ→kappa, θsnooker→theta_snooker).  A
strategy slot holds the name of a built-in (given by its name or as the
port's function of that name) or a custom callable with the JAX
signature (the reference's extension mechanism, ``src/structs.jl:
71-76``), which the unfused step runs: ``generate_proposal(ctx, key)``,
``sample(ctx, key, n, exclude_self[, replace])``,
``update_particle(key, w_cur, w_prop, log_adj)`` and
``evaluate_fitness(model, spec, de, x[, noise])``, ``ctx`` a
:class:`~demcmc_tpu_torch.ops.proposals.ProposalContext` and ``key`` a
:class:`~demcmc_tpu_torch.rng.Key`.  The optimization modes
(``update_particle='maximize'``/``'minimize'`` with ``evaluate_fitness=
'fun'``) and ``dtype=float64`` are carried: float32 greedy configurations
of a model with a greedy CUDA density run on K1, every other one on the
unfused step.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Any

import numpy as np
import torch

_PROPOSALS = {n: n for n in ("random_gamma", "fixed_gamma",
                              "variable_gamma")}
_SAMPLES = {"sample": "sample", "current": "current",
            "sample_current": "current", "resample": "resample"}
_UPDATES = {"mh": "mh", "mh_update": "mh", "maximize": "maximize",
            "minimize": "minimize"}
_FITNESS = {"posterior": "posterior", "compute_posterior": "posterior",
            "fun": "fun", "evaluate_fun": "fun"}
_DTYPES = (np.dtype(np.float32), np.dtype(np.float64))


def _slot(value, names: dict, builtins: tuple, default, what: str):
    """A strategy slot: None is ``default``; a name, or one of the port's
    functions of that name (``builtins``), its canonical name; any other
    callable stays as it is (a custom slot).  Anything else raises."""
    if value is None:
        return default
    if isinstance(value, str):
        if value not in names:
            raise ValueError(f"{what}={value!r} names no built-in "
                             f"({', '.join(sorted(names))}); pass a "
                             f"callable for a custom slot")
        return names[value]
    if any(value is f for f in builtins):
        return names[value.__name__]
    if not callable(value):
        raise TypeError(f"{what} must be a name or a callable, not "
                        f"{value!r}")
    return value


def _default_blocking_on(de) -> bool:
    return False


def _always_blocking_on(de) -> bool:
    return True


def _blocking_const(de):
    """True or False where ``blocking_on`` is one of the two constant
    forms, None for any other callable, whose flag is a function of the
    iteration (``demcmc_tpu/ops/fused_step.py:380-389``)."""
    if de.blocking_on is _always_blocking_on:
        return True
    if de.blocking_on is _default_blocking_on:
        return False
    return None


def _freeze_block(block):
    """One block mask as nested tuples of bools (hashable, like the frozen
    ``DE``): a scalar element stays a bool, an array element becomes the
    nested tuple of its values."""
    out = []
    for elem in block:
        a = np.asarray(elem, dtype=bool)
        out.append(bool(a) if a.shape == () else _tuples(a.tolist()))
    return tuple(out)


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else bool(x)


@dataclass(frozen=True)
class DE:
    """Differential Evolution MCMC sampler configuration.

    Keyword parity with the reference constructor: ``n_groups=4, Np,
    burnin=1000, discard_burnin=True, alpha=.1, beta=.1, epsilon=.001,
    sigma=.05, kappa=1.0, theta_snooker=0.0, bounds, n_initial=0`` plus
    the strategy slots.  ``generate_proposal`` takes ``'random_gamma'``
    (default), ``'fixed_gamma'``, ``'variable_gamma'`` or the functions of
    the same names in :mod:`demcmc_tpu_torch.ops.proposals`;
    ``update_particle`` ``'mh'`` (default), ``'maximize'`` or
    ``'minimize'`` and ``evaluate_fitness`` ``'posterior'`` (default) or
    ``'fun'``, or the functions of those names in
    :mod:`demcmc_tpu_torch.ops.accept`, each kept as its name, or a
    custom callable (the module's docstring), kept as it is and compared
    by identity; ``dtype``
    float32 (default) or float64, the state's type.  ``blocks``,
    a list of masks over the parameters (reference ``src/structs.jl:48``),
    runs one sweep per block where ``blocking_on`` (a bool, or a callable
    of the sampler's view ``sampler._DEView``) says so.
    """

    Np: int = None
    n_groups: int = 4
    burnin: int = 1000
    discard_burnin: bool = True
    alpha: float = 0.1          # migration probability (α)
    beta: float = 0.1           # mutation probability (β)
    epsilon: float = 0.001      # crossover noise half-width (ϵ)
    sigma: float = 0.05         # mutation noise sd (σ)
    kappa: float = 1.0          # recombination keep-probability (κ)
    theta_snooker: float = 0.0  # snooker probability (θsnooker)
    bounds: Any = None
    n_initial: int = 0
    generate_proposal: Any = None
    update_particle: Any = None
    evaluate_fitness: Any = None
    sample: Any = None
    blocking_on: Any = _default_blocking_on
    blocks: Any = None
    dtype: Any = np.float32
    sweep: str = "auto"
    """Within-group update order: ``'sync'`` updates the whole group from
    iteration-start state in one pass; ``'sequential'`` replays the
    reference's in-place sweep; ``'auto'`` picks 'sequential' when
    ``Np <= 4`` (see ``demcmc_tpu.config.DE.sweep``)."""
    sample_prior: Any = None

    def __post_init__(self):
        if self.Np is None:
            raise ValueError("Np (particles per group) is required")
        if self.n_groups == 1 and self.alpha > 0:
            object.__setattr__(self, "alpha", 0.0)
        from .ops import accept, proposals   # the slots' functions
        object.__setattr__(self, "generate_proposal", _slot(
            self.generate_proposal, _PROPOSALS,
            (proposals.random_gamma, proposals.fixed_gamma,
             proposals.variable_gamma), "random_gamma",
            "generate_proposal"))
        if self.sweep not in ("auto", "sync", "sequential"):
            raise ValueError(f"sweep must be 'auto', 'sync' or "
                             f"'sequential'; got {self.sweep!r}")
        if self.Np < 3:
            raise ValueError("Np must be >= 3 (two distinct non-self "
                             "partners, three distinct snooker members)")
        if self.blocking_on is None or isinstance(self.blocking_on,
                                                  (bool, np.bool_)):
            # the reference slot is a callable of the sampler's view; a
            # bool is one of the two constant forms (JAX config.py:112-119)
            object.__setattr__(self, "blocking_on",
                               _always_blocking_on if self.blocking_on
                               else _default_blocking_on)
        elif not callable(self.blocking_on):
            raise TypeError(f"blocking_on must be a bool or a callable of "
                            f"the sampler's view, not {self.blocking_on!r}")
        if self.blocks is not None:
            if len(self.blocks) == 0:
                raise ValueError("blocks must be a non-empty list of "
                                 "parameter masks (or None)")
            object.__setattr__(self, "blocks", tuple(
                _freeze_block(b) for b in self.blocks))
        object.__setattr__(self, "sample", _slot(
            self.sample, _SAMPLES,
            (proposals.sample_current, proposals.resample), None, "sample"))
        object.__setattr__(self, "update_particle", _slot(
            self.update_particle, _UPDATES,
            (accept.mh_update, accept.maximize, accept.minimize), "mh",
            "update_particle"))
        object.__setattr__(self, "evaluate_fitness", _slot(
            self.evaluate_fitness, _FITNESS,
            (accept.compute_posterior, accept.evaluate_fun), "posterior",
            "evaluate_fitness"))
        if np.dtype(self.dtype) not in _DTYPES:
            raise ValueError(f"dtype must be float32 or float64, not "
                             f"{np.dtype(self.dtype)}")
        object.__setattr__(self, "dtype", np.dtype(self.dtype).type)

    @property
    def n_chains(self) -> int:
        return self.n_groups * self.Np

    @property
    def uses_resample(self) -> bool:
        """DE-MCz: partners come from the history of past states."""
        return self.sample == "resample"

    @property
    def custom_slots(self) -> tuple:
        """The names of the strategy slots that hold a custom callable."""
        return tuple(name for name in ("generate_proposal", "sample",
                                       "update_particle", "evaluate_fitness")
                     if callable(getattr(self, name)))

    @property
    def uses_snooker(self) -> bool:
        """Snooker proposals are drawn (``theta_snooker > 0``)."""
        return self.theta_snooker > 0.0

    @property
    def is_mh(self) -> bool:
        """Metropolis–Hastings accept (sampling), the default."""
        return self.update_particle == "mh"

    @property
    def is_maximize(self) -> bool:
        """Greedy accept of a larger objective (optimization)."""
        return self.update_particle == "maximize"

    @property
    def is_minimize(self) -> bool:
        """Greedy accept of a smaller objective (optimization)."""
        return self.update_particle == "minimize"

    @property
    def fun_fitness(self) -> bool:
        """Objective-only fitness (``evaluate_fun``), no prior."""
        return self.evaluate_fitness == "fun"

    @property
    def torch_dtype(self) -> torch.dtype:
        """The state's torch dtype."""
        return torch.float64 if self.dtype is np.float64 else torch.float32

    @property
    def sequential_sweep(self) -> bool:
        """Resolved ``sweep`` knob."""
        if self.sweep == "sequential":
            return True
        if self.sweep == "sync":
            return False
        return self.Np <= 4

    def replace(self, **kw) -> "DE":
        return replace(self, **kw)

    def _static_key(self):
        """Every field, arrays (``bounds``) frozen to nested tuples, so a
        configuration compares and hashes by content (JAX
        ``DE._static_key``): the dataclass's own ``__eq__`` would compare
        an array ``bounds`` elementwise and raise."""
        def freeze(x):
            if isinstance(x, np.ndarray):
                return ("nd", x.shape, tuple(x.reshape(-1).tolist()))
            if isinstance(x, (list, tuple)):
                return tuple(freeze(e) for e in x)
            return x
        return tuple(freeze(getattr(self, f.name)) for f in fields(self))

    def __hash__(self):
        return hash(self._static_key())

    def __eq__(self, other):
        if not isinstance(other, DE):
            return NotImplemented
        return self._static_key() == other._static_key()


class MCMCThreads:
    """API-compat marker (reference: AbstractMCMC's ``MCMCThreads()``),
    accepted and ignored by :func:`demcmc_tpu_torch.sample`."""
