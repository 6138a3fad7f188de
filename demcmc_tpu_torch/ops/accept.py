"""Bounds, fitness and the Metropolis–Hastings accept (port of
``demcmc_tpu.ops.accept``; reference ``src/utilities.jl:70-99,201-210``).
"""

from __future__ import annotations

import math

import torch

from .. import rng


def in_bounds(spec, x):
    """``x [..., d]`` -> bool ``[...]``: every dimension within its finite
    bounds (an infinite bound is no check, so NaN passes it and is caught
    by the posterior's NaN mask, as in the TPU kernel)."""
    ok = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
    for i in range(spec.dim):
        if math.isfinite(spec.lo[i]):
            ok = ok & (x[..., i] >= float(spec.lo[i]))
        if math.isfinite(spec.hi[i]):
            ok = ok & (x[..., i] <= float(spec.hi[i]))
    return ok


def compute_posterior(model, spec, x):
    """Log posterior of ``x [..., d]``; out-of-bounds or NaN -> ``-inf``
    (``compute_posterior!``, reference ``src/utilities.jl:92-99``)."""
    cols = torch.movedim(x, -1, 0)
    lp = model.log_posterior_cols(spec, cols)
    ok = in_bounds(spec, x) & ~torch.isnan(lp)
    return torch.where(ok, lp, torch.full_like(lp, -math.inf))


def mh_accept(w_prop, w, u):
    """Log-space MH: accept when ``log max(u, tiny) <= w_prop - w``."""
    return torch.log(torch.clamp_min(u, rng.TINY)) <= w_prop - w
