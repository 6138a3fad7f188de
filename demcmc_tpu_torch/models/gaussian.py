"""Gaussian (μ, σ) model — the reference's flagship example (port of
``demcmc_tpu.models.gaussian``).

Priors μ ~ Normal(0, 1), σ ~ truncated(Cauchy(0, 1), 0, Inf); likelihood
Normal(μ, σ) over the data; bounds ((-Inf, Inf), (0, Inf)).  The batched
likelihood runs through the CENTERED sufficient statistics (n, x̄,
Σ(x − x̄)²) folded on the host in float64, with the float32 operation
order of ``gaussian.py:66-68``; ``csrc/densities/gaussian.cuh`` is the
same expression for the DE-step kernel.  The MLE (:func:`make_mle`)
maximizes the likelihood alone, the same ``loglike_batched``, whose
kernel twin is the header's ``like()``: a float32 configuration runs on
K1 with the greedy max accept.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import rng
from ..config import DE
from ..model import CudaDensity, DEModel
from ..parallel.mesh import ShardedData, host
from ..utils import dists

BOUNDS = ((-math.inf, math.inf), (0.0, math.inf))
NAMES = ("mu", "sigma")


def suff_stats(data):
    """(n, x̄, Σ(x − x̄)²) of f32 data, taken in float64 and rounded to
    float32 — the constants the JAX package folds at trace time."""
    x = np.asarray(data, dtype=np.float64)
    xbar = x.mean(axis=0)
    ss = ((x - xbar) ** 2).sum(axis=0)
    return (float(x.shape[0]), float(np.float32(xbar)),
            float(np.float32(ss)))


def loglike_batched(data, mu, sigma):
    """Chains-last Σᵢ log N(xᵢ; μ, σ) through the centered statistics."""
    return loglike_stats(suff_stats(data), mu, sigma)


def loglike_stats(stats, mu, sigma):
    """:func:`loglike_batched` from the data's :func:`suff_stats`."""
    n, xbar, ss = stats
    c0 = dists.f32(-0.5 * n * math.log(2.0 * math.pi))
    dm = mu - xbar
    return (c0 - n * torch.log(sigma)
            - 0.5 * (ss + n * dm * dm) / (sigma * sigma))


def prior_loglike_batched(mu, sigma):
    return dists.normal_logpdf(mu, 0.0, 1.0) + dists.halfcauchy_logpdf(sigma)


def sample_prior(uniform, n):
    """``n`` prior draws: μ by Box–Muller from two uniform rows, σ from a
    third as a half-Cauchy."""
    u = uniform(3)
    u1 = torch.clamp_min(u[0], rng.TINY)
    mu = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u[1])
    return [mu, dists.sample_halfcauchy(u[2])]


def density(data) -> CudaDensity:
    """The kernel density: ``csrc/densities/gaussian.cuh`` with its
    float32 constants (n, x̄, Σ(x−x̄)², −n/2·log 2π, log 2π, log π, log 2)."""
    n, xbar, ss = suff_stats(data)
    c0 = dists.f32(-0.5 * n * math.log(2.0 * math.pi))
    return CudaDensity("gaussian", (n, xbar, ss, c0, dists.LOG_2PI,
                                    dists.LOG_PI, dists.LOG2))


def make_model(data) -> DEModel:
    """The model on ``data``: an array, or data sharded over a mesh's
    ``data`` axis (``parallel.shard_data``), whose pieces' sufficient
    statistics are taken once here, piece by piece, and evaluated on each
    piece's device (no CUDA density: the kernels' step is not taken under
    a data axis)."""
    if isinstance(data, ShardedData):
        return DEModel(loglike_batched=loglike_stats,
                       prior_loglike_batched=prior_loglike_batched,
                       sample_prior=sample_prior, names=NAMES,
                       data=data.map(lambda p: suff_stats(host(p))))
    data = np.asarray(data, dtype=np.float32)
    return DEModel(loglike_batched=loglike_batched,
                   prior_loglike_batched=prior_loglike_batched,
                   sample_prior=sample_prior, names=NAMES, data=data,
                   cuda_density=density(data))


def make(data=None, key=0, n_obs=50, true_mu=0.0, true_sigma=1.0, Np=6,
         n_groups=4, burnin=1000, **de_kwargs):
    """Build (model, de) matching the reference example configuration;
    without ``data``, ``n_obs`` observations from numpy seed ``key``."""
    if data is None:
        data = true_mu + true_sigma * np.random.default_rng(
            key).standard_normal(n_obs)
    model = make_model(data)
    de = DE(bounds=BOUNDS, burnin=burnin, Np=Np, n_groups=n_groups,
            **de_kwargs)
    return model, de


def make_mle(data=None, key=0, n_obs=50, Np=16, n_groups=256, burnin=1000,
             **de_kwargs):
    """(model, de) of the Gaussian MLE: the bench Gaussian (without
    ``data``, ``n_obs`` standard normals from numpy seed ``key``)
    maximized with the objective alone (``update_particle='maximize'``,
    ``evaluate_fitness='fun'``), at the bench width by default."""
    kw = dict(Np=Np, n_groups=n_groups, burnin=burnin,
              update_particle="maximize", evaluate_fitness="fun")
    kw.update(de_kwargs)
    return make(data=data, key=key, n_obs=n_obs, **kw)


def posterior_grid(data, n_mu=301, n_sigma=301, mu_rng=None, sigma_rng=None):
    """Ground-truth posterior moments by 2-D quadrature (numpy, float64)."""
    data = np.asarray(data, dtype=np.float64)
    m, s = data.mean(), data.std()
    if mu_rng is None:
        mu_rng = (m - 6 * s / np.sqrt(len(data)),
                  m + 6 * s / np.sqrt(len(data)))
    if sigma_rng is None:
        sigma_rng = (max(1e-3, s * 0.4), s * 2.5)
    mu = np.linspace(*mu_rng, n_mu)
    sg = np.linspace(*sigma_rng, n_sigma)
    MU, SG = np.meshgrid(mu, sg, indexing="ij")
    logp = (-0.5 * MU ** 2 - 0.5 * np.log(2 * np.pi)            # N(0,1)
            + np.log(2 / np.pi) - np.log1p(SG ** 2)             # half-Cauchy
            - len(data) * np.log(SG)
            - len(data) / 2 * np.log(2 * np.pi)
            - ((data[None, None, :] - MU[..., None]) ** 2).sum(-1)
            / (2 * SG ** 2))
    w = np.exp(logp - logp.max())
    w /= w.sum()
    stats = {}
    for name, v in (("mu", MU), ("sigma", SG)):
        mean = (w * v).sum()
        stats[name] = {"mean": mean,
                       "std": np.sqrt((w * (v - mean) ** 2).sum())}
    return stats
