"""Discrete-parameter model: a binomial count N (integer) and rate p (port
of ``demcmc_tpu.models.discrete_binomial``).

Reference ``Examples/Discrete_Example.jl``: N ~ DiscreteUniform(0, 40),
p ~ U(0, 1), bounds ((0, 40), (0, 1)).  N is an integer leaf: proposals are
computed in float and snapped to the nearest integer (half to even) before
the bounds and the density (``src/utilities.jl:360-369``), so chains stay
integral.

The batched likelihood folds the observations through their unique counts
(``demcmc_tpu/models/discrete_binomial.py:43-61``): the θ-free constant
−Σ_k c_k·lgamma(k + 1) taken on the host in float64, and c_k·lgamma(N − k +
1) subtracted in the order of ``np.unique``.  lgamma is
:func:`..utils.dists.lgamma32`, the JAX kernel's ``_lgamma32``, as in
``csrc/densities/discrete_binomial.cuh``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import DE
from ..model import CudaDensity, DEModel
from ..utils import dists

NAMES = ("N", "p")
BOUNDS = ((0, 40), (0.0, 1.0))
LOG_PRIOR = dists.f32(np.log(1.0 / 41.0))


def folded(data):
    """(unique counts, multiplicities, n, Σk, constant) of the data."""
    k = np.asarray(data)
    kvals, counts = np.unique(k, return_counts=True)
    lg = np.array([math.lgamma(v + 1.0) for v in kvals.astype(np.float64)])
    const = float(-np.sum(counts * lg))
    return kvals, counts, float(k.size), float(k.sum()), const


def loglike_batched(data, N, p):
    """Chains-last log likelihood: ``N [*cs]`` int32, ``p [*cs]``; −inf
    where N is below the largest observed count."""
    kvals, counts, n, Sk, const = folded(data)
    n, Sk, const = dists.f32(n), dists.f32(Sk), dists.f32(const)
    Nf = N.to(p.dtype)
    lp = (n * dists.lgamma32(Nf + 1.0) + const
          + Sk * torch.log(p) + (n * Nf - Sk) * torch.log1p(-p))
    for kv, c in zip(kvals, counts):
        lp = lp - float(c) * dists.lgamma32(Nf - float(kv) + 1.0)
    return torch.where(Nf >= float(kvals.max()), lp,
                       torch.full_like(lp, -math.inf))


def prior_loglike_batched(N, p):
    return torch.full_like(p, LOG_PRIOR)


def sample_prior(uniform, n):
    """``n`` draws: an integer N in 5..29 (``floor(5 + 25 u)``) and
    p ~ U(0.2, 0.9)."""
    u = uniform(2)
    N = torch.clamp_max(torch.floor(5.0 + 25.0 * u[0]), 29.0)
    return [N.to(torch.int64), 0.2 + 0.7 * u[1]]


def density(data) -> CudaDensity:
    """The kernel density ``csrc/densities/discrete_binomial.cuh``:
    (n, constant, Σk, max k, number of unique counts, log prior) and the
    ``[n_unique, 2]`` (count, multiplicity) table as its data buffer."""
    kvals, counts, n, Sk, const = folded(data)
    tab = np.stack([kvals, counts], 1).astype(np.float32)
    return CudaDensity("discrete_binomial",
                       (dists.f32(n), dists.f32(const), dists.f32(Sk),
                        float(kvals.max()), float(len(kvals)), LOG_PRIOR),
                       data=tab)


def make_model(data) -> DEModel:
    data = np.asarray(data)
    return DEModel(loglike_batched=loglike_batched,
                   prior_loglike_batched=prior_loglike_batched,
                   sample_prior=sample_prior, names=NAMES, data=data,
                   cuda_density=density(data))


def make(key=0, true_n=10, true_p=0.6, n_obs=50, data=None, **de_kwargs):
    """Build (model, de) as the JAX ``make``: without ``data``, ``n_obs``
    Binomial(true_n, true_p) counts from numpy seed ``key`` (the same
    generator, so the same data).  The default ``dtype=np.float64`` raises
    (float64 is ROADMAP A5); pass ``dtype=np.float32``."""
    if data is None:
        data = np.random.default_rng(key).binomial(true_n, true_p,
                                                   size=n_obs)
    kw = dict(bounds=BOUNDS, Np=12, n_groups=4, burnin=1000, sigma=1.0,
              dtype=np.float64)
    kw.update(de_kwargs)
    return make_model(data), DE(**kw)

