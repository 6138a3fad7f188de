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


def compute_posterior(model, spec, x, noise=None):
    """Log posterior of ``x [..., d]``; out-of-bounds or NaN -> ``-inf``
    (``compute_posterior!``, reference ``src/utilities.jl:92-99``).  A
    stochastic model evaluates on the uniform panel ``noise [n_noise,
    ...]`` (``fused_step.py:2422-2428``)."""
    cols = torch.movedim(x, -1, 0)
    lp = model.log_posterior_cols(spec, cols, noise)
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


# ------------------------------------------ the unfused step's pieces


def make_fitness(model, spec):
    """Batched fitness ``[G, Np, d] -> [G, Np]`` of the unfused step
    (``demcmc_tpu/ops/accept.py:57``): :func:`compute_posterior` over the
    population, the model's per-cell densities batched by ``vmap``
    (``DE`` refuses the optimization modes' ``evaluate_fun``, ROADMAP
    A5)."""

    def fitness(x):
        return compute_posterior(model, spec, x)
    return fitness


def mh_update(draws, w_cur, w_prop, log_adj):
    """Metropolis–Hastings accept mask in log space (``demcmc_tpu/ops/
    accept.py:91``): accept iff ``log max(u, tiny) <= (w′ − w) + log_adj``
    with ``u`` the pool's next ``w``-shaped uniform; a NaN difference
    rejects."""
    u = torch.clamp_min(draws.uniform(tuple(w_cur.shape)), rng.TINY)
    return torch.log(u) <= (w_prop - w_cur) + log_adj


def apply_accept(theta, weight, prop, w_prop, acc):
    """Masked population update: where accepted, take the proposal."""
    return (torch.where(acc[..., None], prop, theta),
            torch.where(acc, w_prop, weight))
