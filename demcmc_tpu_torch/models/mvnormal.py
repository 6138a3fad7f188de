"""High-dimensional MVN model — the snooker + resample stress test (port of
``demcmc_tpu.models.mvnormal``).

Reference ``test/multivariate_normal_tests.jl``: parameters (μ[d], σ);
priors μᵢ ~ Normal(0, 1), σ ~ truncated(Cauchy(0, 1), 0, Inf); likelihood
MvNormal(μ, σ²I) over ``[n_obs, d]`` data; sampler Np=3, n_groups=1,
θsnooker=0.1, sample=resample, n_initial=(d+1)·4.

The batched likelihood runs through the CENTERED sufficient statistics
(x̄ [d], Σ‖x − x̄‖²) folded on the host in float64 and rounded once, with the
float32 operation order of ``demcmc_tpu/models/mvnormal.py:54-65``; the
sums over d run in index order, as ``csrc/densities/mvnormal.cuh`` does.
The JAX model draws its default data with ``jax.random``; the port draws
it with numpy (``make``), so a comparison passes the data to both.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import rng
from ..config import DE
from ..model import CudaDensity, DEModel
from ..parallel.mesh import ShardedData, host
from ..ops import _build
from ..utils import dists

NAMES = ("mu", "sigma")
BOUNDS = ((-math.inf, math.inf), (0.0, math.inf))


def suff_stats(data):
    """(n, x̄ [d], Σ‖x − x̄‖²) of f32 data, taken in float64; x̄ and the
    sum rounded to float32 — the constants the JAX model folds."""
    x = np.asarray(data, dtype=np.float64)
    xbar = x.mean(axis=0)
    ss = float(((x - xbar) ** 2).sum())
    return (float(x.shape[0]), np.asarray(xbar, np.float32),
            float(np.float32(ss)))


def _consts(n: float, d: int):
    """The folded float32 constants −n·d/2·log 2π and n·d."""
    return dists.f32(-0.5 * n * d * float(np.log(2.0 * np.pi))), \
        dists.f32(n * d)


def _rowsum(rows):
    s = rows[0]
    for r in rows[1:]:
        s = s + r
    return s


def loglike_batched(data, mu, sigma):
    """Chains-last log likelihood: ``mu [d, *cs]``, ``sigma [*cs]``."""
    return loglike_stats(suff_stats(data), mu, sigma)


def loglike_stats(stats, mu, sigma):
    """:func:`loglike_batched` from the data's :func:`suff_stats`."""
    n, xbar, ss = stats
    d = mu.shape[0]
    c0, nd = _consts(n, d)
    dm = [mu[i] - float(xbar[i]) for i in range(d)]
    quad = ss + n * _rowsum([v * v for v in dm])
    return (c0 - nd * torch.log(sigma)) - 0.5 * quad / (sigma * sigma)


def prior_loglike_batched(mu, sigma):
    return (_rowsum([dists.normal_logpdf(mu[i], 0.0, 1.0)
                     for i in range(mu.shape[0])])
            + dists.halfcauchy_logpdf(sigma))


def make_sample_prior(d: int):
    """``n`` prior draws: μ by Box–Muller from 2d uniform rows, σ from one
    more as a half-Cauchy."""
    def sample_prior(uniform, n):
        u = uniform(2 * d + 1)
        u1 = torch.clamp_min(u[:d], rng.TINY)
        mu = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
            2.0 * math.pi * u[d:2 * d])
        return [mu.T, dists.sample_halfcauchy(u[2 * d])]
    return sample_prior


def density(data) -> CudaDensity:
    """The kernel density ``csrc/densities/mvnormal.cuh`` for the data's
    d, with its float32 constants (n, n·d, Σ‖x−x̄‖², −n·d/2·log 2π,
    log 2π, log π, log 2, x̄[d]); None where no kernel is built for d."""
    n, xbar, ss = suff_stats(data)
    d = xbar.shape[0]
    if f"mvnormal{d}" not in _build.KERNEL_DENSITIES["resample_step"]:
        return None
    c0, nd = _consts(n, d)
    return CudaDensity(f"mvnormal{d}", (n, nd, ss, c0, dists.LOG_2PI,
                                        dists.LOG_PI, dists.LOG2,
                                        *(float(v) for v in xbar)))


def make_model(data) -> DEModel:
    """The model on ``data [n, d]``, or on such data sharded over a
    mesh's ``data`` axis (``parallel.shard_data`` along the observations),
    whose pieces' sufficient statistics are taken once here, piece by
    piece, and evaluated on each piece's device (no CUDA density: the
    kernels' step is not taken under a data axis)."""
    if isinstance(data, ShardedData):
        return DEModel(loglike_batched=loglike_stats,
                       prior_loglike_batched=prior_loglike_batched,
                       sample_prior=make_sample_prior(
                           np.shape(data.pieces[0])[1]),
                       names=NAMES,
                       data=data.map(lambda p: suff_stats(host(p))))
    data = np.asarray(data, dtype=np.float32)
    return DEModel(loglike_batched=loglike_batched,
                   prior_loglike_batched=prior_loglike_batched,
                   sample_prior=make_sample_prior(data.shape[1]),
                   names=NAMES, data=data, cuda_density=density(data))


def make(d=30, n_obs=100, key=0, data=None, **de_kwargs):
    """Build (model, de) with the reference configuration; without
    ``data``, a standard normal ``[n_obs, d]`` from numpy seed ``key``."""
    if data is None:
        data = np.random.default_rng(key).standard_normal((n_obs, d))
    if not isinstance(data, ShardedData):
        data = np.asarray(data, dtype=np.float32)
    d = np.shape(data.pieces[0] if isinstance(data, ShardedData)
                 else data)[1]
    kw = dict(bounds=BOUNDS, Np=3, n_groups=1, alpha=0.0, theta_snooker=0.1,
              sample="resample", n_initial=(d + 1) * 4, burnin=1000)
    kw.update(de_kwargs)
    return make_model(data), DE(**kw)


def analytic_posterior(data, sigma=1.0):
    """Posterior of μ at fixed σ: N(0,1) prior × N(μ, σ²) likelihood."""
    data = np.asarray(data, dtype=np.float64)
    n = data.shape[0]
    prec = n / sigma ** 2 + 1.0
    mean = data.sum(axis=0) / sigma ** 2 / prec
    return {"mean": mean, "std": np.full(data.shape[1], prec ** -0.5)}
