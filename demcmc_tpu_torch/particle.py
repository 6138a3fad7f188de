"""Host-side ``Particle`` compatibility shim (the port's own copy of
``demcmc_tpu.particle``, numpy only).

The reference exports a mutable per-chain ``Particle`` struct with
algebraic operator overloads used to write proposal formulas
(reference ``src/structs.jl:202-223``, arithmetic at
``src/utilities.jl:269-369``).  The sampler has no per-particle
objects — the population is one tensor — but the type is part of the
reference's public API, so this numpy-based equivalent is provided for
host-side composition, teaching, and porting reference snippets:

* ``p1 + p2``, ``p1 - p2``, ``s * p``, ``p * s``, ``p + s`` elementwise
  over the (possibly heterogeneous scalar/vector/matrix) parameter list.
* A distribution operand draws **fresh noise per scalar element**
  (reference ``draw``, ``src/utilities.jl:300-306``): anything with an
  ``rvs()`` (scipy.stats frozen dist) or ``sample()`` method, or a
  zero-arg callable.
* Integer parameters follow the round-and-cast rule (reference ``*′``/
  ``+′``, ``src/utilities.jl:360-369``): Int×Float results round back to
  int, so discrete parameters stay on the lattice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List

import numpy as np


def _aslist(x):
    """A parameter list as a list (a single parameter becomes one)."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _draw_like(dist, ref: np.ndarray) -> np.ndarray:
    """Fresh per-element draws from a distribution-like operand."""
    shape = ref.shape
    if hasattr(dist, "rvs"):
        return np.asarray(dist.rvs(size=shape) if shape else dist.rvs())
    if hasattr(dist, "sample"):
        return np.asarray([dist.sample() for _ in range(ref.size)]
                          ).reshape(shape) if shape else np.asarray(dist.sample())
    if callable(dist):
        return np.asarray([dist() for _ in range(ref.size)]
                          ).reshape(shape) if shape else np.asarray(dist())
    raise TypeError(f"cannot draw from operand of type {type(dist)!r}")


def _is_dist(x) -> bool:
    return (not np.isscalar(x) and not isinstance(x, (np.ndarray, list))
            and (hasattr(x, "rvs") or hasattr(x, "sample")
                 or (callable(x) and not isinstance(x, type))))


def _combine(a: np.ndarray, b, op) -> np.ndarray:
    """Elementwise op with the reference's int round-and-cast rule."""
    if _is_dist(b):
        b = _draw_like(b, np.asarray(a))
    out = op(np.asarray(a), np.asarray(b))
    if np.issubdtype(np.asarray(a).dtype, np.integer):
        return np.round(out).astype(np.asarray(a).dtype)
    return out


@dataclass
class Particle:
    """One chain's state (reference ``Particle``, ``src/structs.jl:202-223``).

    Field names follow the reference: ``theta`` is the heterogeneous
    parameter list (Θ), ``weight`` the current log posterior, ``accept``/
    ``lp`` the per-iteration histories, ``id`` the global chain index.
    """

    theta: List[Any] = field(default_factory=list)
    weight: float = -np.inf
    accept: List[bool] = field(default_factory=list)
    lp: List[float] = field(default_factory=list)
    id: int = 0

    def __post_init__(self):
        self.theta = [np.asarray(p) for p in _aslist(self.theta)]

    # -- algebra (reference src/utilities.jl:269-369) ---------------------
    def _zip(self, other, op) -> "Particle":
        if isinstance(other, Particle):
            theta = [_combine(a, b, op)
                     for a, b in zip(self.theta, other.theta)]
        else:
            theta = [_combine(a, other, op) for a in self.theta]
        return Particle(theta=theta, id=self.id)

    def __add__(self, other):
        return self._zip(other, np.add)

    def __radd__(self, other):
        return self._zip(other, np.add)

    def __sub__(self, other):
        return self._zip(other, np.subtract)

    def __rsub__(self, other):
        return Particle(theta=[_combine(a, other, lambda x, y: y - x)
                               for a in self.theta], id=self.id)

    def __mul__(self, other):
        return self._zip(other, np.multiply)

    def __rmul__(self, other):
        return self._zip(other, np.multiply)

    # -- conveniences -----------------------------------------------------
    def flatten(self) -> np.ndarray:
        return np.concatenate([np.asarray(p, dtype=float).reshape(-1)
                               for p in self.theta])

    def __eq__(self, other) -> bool:
        if not isinstance(other, Particle):
            return NotImplemented
        return (len(self.theta) == len(other.theta)
                and all(np.array_equal(a, b)
                        for a, b in zip(self.theta, other.theta)))

    def __repr__(self) -> str:
        return (f"Particle(id={self.id}, weight={self.weight:.4g}, "
                f"theta={self.theta})")



