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
    ok = None
    for i in range(spec.dim):
        for bound, inside in ((spec.lo[i], torch.ge), (spec.hi[i], torch.le)):
            if math.isfinite(bound):
                c = inside(x[..., i], float(bound))
                ok = c if ok is None else ok & c
    if ok is None:
        return torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
    return ok


def compute_posterior(model, spec, de, x, noise=None):
    """Log posterior of ``x [..., d]``; out-of-bounds or NaN -> ``-inf``
    (``compute_posterior!``, reference ``src/utilities.jl:92-99``; the JAX
    signature, ``de`` unused).  A stochastic model evaluates on the
    uniform panel ``noise [n_noise, ...]`` (``fused_step.py:2422-2428``)."""
    cols = torch.movedim(x, -1, 0)
    lp = model.log_posterior_cols(spec, cols, noise)
    ok = in_bounds(spec, x) & ~torch.isnan(lp)
    return torch.where(ok, lp, -math.inf)


def objective(model, spec, x, bad: float, noise=None):
    """The model's loglike of ``x [..., d]`` with no prior; out-of-bounds
    or NaN scores ``bad`` (the TPU kernel's greedy modes,
    ``fused_step.py:2429``)."""
    val = model.log_like_cols(spec, torch.movedim(x, -1, 0), noise)
    ok = in_bounds(spec, x) & ~torch.isnan(val)
    return torch.where(ok, val, bad)


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
    densities batched by ``vmap``; ``noise [n_noise, G·Np]`` is a
    stochastic model's panel.  A custom slot ``slot(model, spec, de, x)``
    runs per cell under ``torch.func.vmap``, as the JAX step vmaps it; for
    a stochastic model it also receives the cell's panel ``[n_noise]`` as
    a fifth argument, where the JAX step passes the cell's key."""
    slot = de.evaluate_fitness
    if not callable(slot):
        fn = evaluate_fun if de.fun_fitness else compute_posterior
        return lambda x, noise=None: fn(model, spec, de, x, noise)
    stochastic = model.stochastic

    def fitness(x, noise=None):
        if stochastic and noise is None:
            raise ValueError("a stochastic model's fitness needs its noise "
                             "panel")
        cells = x.reshape(-1, x.shape[-1])
        if stochastic:
            out = torch.func.vmap(
                lambda v, u: slot(model, spec, de, v, u),
                in_dims=(0, 1))(cells, noise)
        else:
            out = torch.func.vmap(lambda v: slot(model, spec, de, v))(cells)
        return out.reshape(x.shape[:-1])
    return fitness


def mh_update(draws, w_cur, w_prop, log_adj):
    """Metropolis–Hastings accept mask in log space (``demcmc_tpu/ops/
    accept.py:91``): accept iff ``log max(u, tiny) <= (w′ − w) + log_adj``
    with ``u`` the next ``w``-shaped uniform of ``draws`` (the pool, or a
    custom update's key) in the weights' dtype (two words each in
    float64); a NaN difference rejects."""
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
    """The accept rule of the configuration's ``update_particle`` slot: a
    built-in, or the custom ``slot(key, w_cur, w_prop, log_adj)``, which
    the step calls with a :class:`~demcmc_tpu_torch.rng.Key`."""
    if callable(de.update_particle):
        return de.update_particle
    return {"mh": mh_update, "maximize": maximize,
            "minimize": minimize}[de.update_particle]


def apply_accept(theta, weight, prop, w_prop, acc):
    """Masked population update: where accepted, take the proposal."""
    return (torch.where(acc[..., None], prop, theta),
            torch.where(acc, w_prop, weight))
