"""Lognormal race (LNR) choice-RT model (port of
``demcmc_tpu.models.lnr``).

Reference ``test/lognormal_race_tests.jl``: parameters (ν[4], τ), the
accumulators' sd σ = 1 fixed; priors ν ~ Normal(0, 3), τ ~ Uniform(0,
min_rt).  Accumulator i finishes at τ + LogNormal(ν_i, σ); the winner is
observed:

    log p(c, rt) = log f_LN(rt − τ; ν_c, σ) + Σ_{j≠c} log(1 − F_LN(rt − τ; ν_j, σ))

The densities are per cell, as the JAX model's, and the step batches
them with ``torch.func.vmap``: the user path of a model without a batched
density.  The data is ``(choice, rt)`` from numpy, or carried across.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import rng
from ..config import DE
from ..model import DEModel, DeviceArrays
from ..utils import dists

NAMES = ("nu", "tau")
N_ACC = 4
TRUE = dict(nu=(-2.0, -2.0, -3.0, -3.0), tau=0.5)


def lnr_logpdf(choice, rt, nu, tau, sigma: float = 1.0):
    """Per-trial log density of one parameter vector: ``choice [n]``
    int64, ``rt [n]``, ``nu [n_acc]``, ``tau`` 0-d (``lnr.py:24-37``);
    ``-inf`` where rt ≤ τ."""
    t = rt[:, None] - tau                                    # [n, 1]
    valid = t[:, 0] > 0
    tsafe = torch.where(t > 0, t, torch.ones_like(t))
    z = (torch.log(tsafe) - nu[None, :]) / sigma             # [n, n_acc]
    logpdf = (-torch.log(tsafe) - dists.f32_log(sigma) - dists.HALF_LOG_2PI
              - 0.5 * z * z)
    logsurv = dists.log_ndtr(-z)                             # log(1 − Φ(z))
    onehot = torch.nn.functional.one_hot(choice, nu.shape[0]).to(z.dtype)
    ll = torch.sum(onehot * logpdf + (1.0 - onehot) * logsurv, dim=1)
    return torch.where(valid, ll, torch.full_like(ll, -math.inf))


def simulate(rng_np, n: int, nu, tau: float, sigma: float = 1.0):
    """``n`` trials (choice int64, rt float32) with numpy: the winner of
    τ + exp(ν + σ z)."""
    z = rng_np.standard_normal((n, len(nu)))
    times = tau + np.exp(np.asarray(nu) + sigma * z)
    return (np.argmin(times, axis=1).astype(np.int64),
            times.min(axis=1).astype(np.float32))


def make_model(data) -> DEModel:
    """The model on ``data = (choice, rt)``."""
    choice, rt = data
    arrays = DeviceArrays(np.asarray(choice, np.int64),
                          np.asarray(rt, np.float32))
    min_rt = float(arrays.arrays[1].min())

    def loglike(data, nu, tau):
        choice, rt = arrays.on(nu.device)
        return torch.sum(lnr_logpdf(choice, rt, nu, tau))

    def prior_loglike(nu, tau):
        return (torch.sum(dists.normal_logpdf(nu, 0.0, 3.0))
                + dists.uniform_logpdf(tau, 0.0, min_rt))

    def sample_prior(uniform, n):
        """ν: four Box–Muller normals × 3 from eight uniform rows; τ:
        U(0, min_rt) from a ninth."""
        u = uniform(2 * N_ACC + 1)
        u1 = torch.clamp_min(u[0:2 * N_ACC:2], rng.TINY)
        z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
            rng.TWO_PI * u[1:2 * N_ACC:2])
        return [3.0 * z.T, min_rt * u[2 * N_ACC]]

    return DEModel(loglike=loglike, prior_loglike=prior_loglike,
                   sample_prior=sample_prior, names=NAMES,
                   data=arrays.arrays)


def bounds(min_rt: float):
    return ((-math.inf, math.inf), (0.0, min_rt))


def make(data=None, key=0, n_trials=100, Np=24, n_groups=4, burnin=2000,
         **de_kwargs):
    """Build (model, de) with the JAX ``make``'s defaults; without
    ``data``, ``n_trials`` trials simulated with numpy seed ``key`` at
    ν = (−2, −2, −3, −3), τ = 0.5."""
    if data is None:
        data = simulate(np.random.default_rng(key), n_trials, **TRUE)
    model = make_model(data)
    kw = dict(bounds=bounds(float(model.data[1].min())), burnin=burnin,
              Np=Np, n_groups=n_groups)
    kw.update(de_kwargs)
    return model, DE(**kw)
