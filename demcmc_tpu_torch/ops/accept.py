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


def mh_accept(w_prop, w, u, log_adj=None):
    """Log-space MH in the TPU kernel's operation order
    (``fused_step.py:2436-2441``): accept where ``log max(u, tiny) <= Δ``
    with ``Δ = (w_prop − w) [+ log_adj]`` (``log_adj``: the snooker
    correction).  Returns ``(accept, margin)``, ``margin = log max(u,
    tiny) − Δ``, whose size comparisons use to spot near-ties."""
    delta = w_prop - w
    if log_adj is not None:
        delta = delta + log_adj
    log_u = torch.log(torch.clamp_min(u, rng.TINY))
    return log_u <= delta, log_u - delta
