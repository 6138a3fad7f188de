"""Bounds, fitness and the accept rules (port of ``demcmc_tpu.ops.accept``;
reference ``src/utilities.jl:70-120,201-226``): the log posterior and the
Metropolis–Hastings accept for sampling, the objective (``evaluate_fun``)
and the greedy accepts (``maximize``, ``minimize``) for optimization.
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


def objective(model, spec, x, bad: float, noise=None):
    """The model's loglike of ``x [..., d]`` with no prior; out-of-bounds
    or NaN scores ``bad`` (the TPU kernel's greedy modes,
    ``fused_step.py:2429``)."""
    val = model.log_like_cols(spec, torch.movedim(x, -1, 0), noise)
    ok = in_bounds(spec, x) & ~torch.isnan(val)
    return torch.where(ok, val, torch.full_like(val, bad))


def evaluate_fun(model, spec, de, x, noise=None):
    """Objective-only fitness of ``x [..., d]`` for optimization: the
    model's loglike with no prior; out-of-bounds or NaN scores ``+inf``
    when minimizing and ``-inf`` when maximizing (``evaluate_fun!``,
    reference ``src/utilities.jl:113-120``; ``demcmc_tpu/ops/accept.py:
    41-49``)."""
    return objective(model, spec, x,
                     math.inf if de.is_minimize else -math.inf, noise)


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


def greedy_accept(w_prop, w, minimize: bool):
    """The kernels' greedy accept (``fused_step.py:2442-2445``): ``w_prop <
    w`` when minimizing, ``w_prop > w`` when maximizing; no correction.
    Returns ``(accept, margin)``, ``margin = ∓|w_prop − w|`` (negative
    where accepted; 0 a tie, rejected; equal infinities ``+inf``, no
    tie), whose size comparisons use to spot near-ties."""
    acc = w_prop < w if minimize else w_prop > w
    gap = torch.nan_to_num(torch.abs(w_prop - w), nan=math.inf,
                           posinf=math.inf)
    return acc, torch.where(acc, -gap, gap)


# ------------------------------------------ the unfused step's pieces


def make_fitness(model, spec, de):
    """Batched fitness ``fitness(x, noise=None)``, ``[G, Np, d] -> [G,
    Np]``, of the configuration's ``evaluate_fitness`` slot
    (``demcmc_tpu/ops/accept.py:51-88``): :func:`compute_posterior` or
    :func:`evaluate_fun` over the population, the model's per-cell
    densities batched by ``vmap``; ``noise`` is a stochastic model's
    panel."""
    if de.fun_fitness:
        return lambda x, noise=None: evaluate_fun(model, spec, de, x, noise)
    return lambda x, noise=None: compute_posterior(model, spec, x, noise)


def mh_update(draws, w_cur, w_prop, log_adj):
    """Metropolis–Hastings accept mask in log space (``demcmc_tpu/ops/
    accept.py:91``): accept iff ``log max(u, tiny) <= (w′ − w) + log_adj``
    with ``u`` the pool's next ``w``-shaped uniform in the weights' dtype
    (two words each in float64); a NaN difference rejects."""
    u = torch.clamp_min(draws.uniform(tuple(w_cur.shape), dtype=w_cur.dtype),
                        rng.tiny(w_cur.dtype))
    return torch.log(u) <= (w_prop - w_cur) + log_adj


def maximize(draws, w_cur, w_prop, log_adj):
    """Greedy replace-if-better (reference ``maximize!``,
    ``src/utilities.jl:212-218``): ``log_adj`` is ignored and nothing is
    drawn (the JAX XLA step's greedy update draws no uniform)."""
    return w_prop > w_cur


def minimize(draws, w_cur, w_prop, log_adj):
    """Greedy replace-if-smaller (reference ``minimize!``,
    ``src/utilities.jl:220-226``); draws nothing."""
    return w_prop < w_cur


# the reference's (stale) greedy_update! export is maximize!
# (demcmc_tpu/ops/accept.py:126)
greedy_update = maximize


def make_update(de):
    """The accept rule of the configuration's ``update_particle`` slot."""
    return {"mh": mh_update, "maximize": maximize,
            "minimize": minimize}[de.update_particle]


def apply_accept(theta, weight, prop, w_prop, acc):
    """Masked population update: where accepted, take the proposal."""
    return (torch.where(acc[..., None], prop, theta),
            torch.where(acc, w_prop, weight))
