"""Small structural helpers (the port's copy of ``demcmc_tpu.utils.pytree``).

The reference's ``as_union`` (``src/utilities.jl:182-187``) exists only
to make Julia's heterogeneous ``Vector{Any}`` type-stable; Python lists
are heterogeneous already, so here it is an identity kept for API parity
(every mixed-shape reference example calls it).
"""

from __future__ import annotations

import numpy as np


def as_union(params):
    """API-parity no-op: return the parameter list unchanged."""
    return list(params) if isinstance(params, (list, tuple)) else params


def ravel_params(spec, params):
    """Flatten a parameter list to a flat [d] numpy vector by the spec's
    layout (the host-side twin of ``ParamSpec.flatten``)."""
    segs = []
    for p, shape in zip(params, spec.shapes):
        a = np.asarray(p, dtype=np.float64)
        segs.append(a.reshape(-1) if shape else a.reshape(1))
    return np.concatenate(segs)


def leaves(tree) -> list:
    """The arrays of a data pytree (an array, or nested lists, tuples and
    dicts of them; dicts in key order), as ``jax.tree.leaves`` lists
    them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def take(tree, i: int):
    """Entry ``i`` of every leaf's leading axis, in the tree's structure
    (replication ``i`` of a replicated run's datasets)."""
    if isinstance(tree, dict):
        return {k: take(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(take(t, i) for t in tree)
    return np.asarray(tree)[i]
