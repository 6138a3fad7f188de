"""Lotka–Volterra (predator–prey) ODE inference (port of
``demcmc_tpu.models.lotka_volterra``).

Reference ``Examples/Predator_Prey_Example.jl``: parameters (α, β, γ, δ,
σ) with truncated-normal priors on the rates and an InverseGamma(2, 3)
prior on the noise σ; the likelihood is iid Normal(σ) residuals around
the ODE solution from (1, 1) sampled every 0.1 on t ∈ [0, 10].

The solve is the JAX model's fixed-step RK4 (dt = 0.02, every fifth state
saved, 101 rows), each stage rounded as the JAX model's.  The density is
chains-last: one RK4 loop per evaluation advances every chain's ``[2,
C]`` state together (500 steps of 29 elementwise operations each), not
one solve per cell under ``vmap``.  It names no CUDA density, so it runs
the unfused step.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import DE
from ..model import DEModel, DeviceArrays
from ..utils import dists

NAMES = ("alpha", "beta", "gamma", "delta", "sigma")
BOUNDS = ((0.5, 2.5), (0.0, 2.0), (1.0, 4.0), (0.0, 2.0), (0.0, math.inf))
TRUE_P = (1.5, 1.0, 3.0, 1.0)
# (μ, sd, lo, hi) of each rate's truncated-normal prior
PRIORS = ((1.5, 0.5, 0.5, 2.5), (1.2, 0.5, 0.0, 2.0), (3.0, 0.5, 1.0, 4.0),
          (1.0, 0.5, 0.0, 2.0))


def solve(p, u0=(1.0, 1.0), t1=10.0, saveat=0.1, substeps=5):
    """RK4 solution sampled every ``saveat``: ``p`` the four rates (each a
    tensor of any shape ``[*cs]``, or a ``[4]`` sequence); returns ``[n_save
    + 1, 2, *cs]`` from t = 0.  The state is one ``[2, *cs]`` tensor (prey,
    predator), so each operation advances both: the vector field is ``(c₀
    + c₁ · swap(u)) · u`` with ``c₀ = (α, −γ)`` and ``c₁ = (−β, δ)``, which
    rounds as the JAX model's ``((α − β y) x, (δ x − γ) y)`` (a negation
    is exact, a sum commutes).  The step's constants fold as the JAX
    model's: ``0.5·dt``, ``dt`` and ``dt / 6`` rounded once to the state's
    dtype."""
    alpha, beta, gamma, delta = (torch.as_tensor(v) for v in p)
    dt = saveat / substeps
    n_save = int(round(t1 / saveat))
    dtype = torch.promote_types(alpha.dtype, torch.float32)
    shape = torch.broadcast_shapes(alpha.shape, beta.shape, gamma.shape,
                                   delta.shape)
    c0 = torch.stack([alpha.expand(shape), -gamma.expand(shape)]).to(dtype)
    c1 = torch.stack([-beta.expand(shape), delta.expand(shape)]).to(dtype)
    u = torch.stack([torch.full(shape, float(v), dtype=dtype,
                                device=alpha.device) for v in u0])
    h2, h, h6 = (dists.const(c, dtype) for c in (0.5 * dt, dt, dt / 6.0))

    def field(u):
        return (c0 + c1 * u.flip(0)) * u

    rows = [u]
    for _ in range(n_save):
        for _ in range(substeps):
            k1 = field(u)
            k2 = field(u + h2 * k1)
            k3 = field(u + h2 * k2)
            k4 = field(u + h * k3)
            u = u + h6 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        rows.append(u)
    return torch.stack(rows)


def prior_loglike_batched(alpha, beta, gamma, delta, sigma):
    """Chains-last log prior: the four truncated normals and the
    InverseGamma(2, 3) on σ, summed in the JAX model's order."""
    lp = None
    for v, (mu, sd, lo, hi) in zip((alpha, beta, gamma, delta), PRIORS):
        t = dists.truncated_normal_logpdf(v, mu, sd, lo, hi)
        lp = t if lp is None else lp + t
    return lp + dists.inverse_gamma_logpdf(sigma, 2.0, 3.0)


def sample_prior(uniform, n):
    """``n`` prior draws: each rate by the truncated normal's inverse CDF
    from one uniform row, σ = 3 / Gamma(2, 1) from two."""
    u = uniform(6)
    rates = [dists.sample_truncated_normal(u[i], *PRIORS[i])
             for i in range(4)]
    return rates + [dists.div_by(3.0, dists.sample_gamma2(u[4], u[5]))]


def make_model(data) -> DEModel:
    """The model on ``data [101, 2]`` (prey, predator)."""
    arrays = DeviceArrays(np.asarray(data, np.float32))

    def loglike_batched(data, alpha, beta, gamma, delta, sigma):
        (obs,) = arrays.on(alpha.device)
        pred = solve((alpha, beta, gamma, delta))
        cs = (1,) * alpha.dim()
        lp = dists.normal_logpdf(obs.reshape(obs.shape + cs).to(pred.dtype),
                                 pred, sigma)
        return lp.sum((0, 1))

    return DEModel(loglike_batched=loglike_batched,
                   prior_loglike_batched=prior_loglike_batched,
                   sample_prior=sample_prior, names=NAMES,
                   data=arrays.arrays[0])


def make(data=None, key=0, true_p=TRUE_P, noise=0.5, Np=12, n_groups=3,
         burnin=1000, **de_kwargs):
    """Build (model, de) with the JAX ``make``'s defaults; without
    ``data``, the solve at ``true_p`` plus ``noise`` times standard normals
    from numpy seed ``key`` (``make(data=)`` carries the JAX model's data
    across)."""
    if data is None:
        traj = solve(torch.tensor(true_p, dtype=torch.float32)).numpy()
        data = traj + noise * np.random.default_rng(key).standard_normal(
            traj.shape).astype(np.float32)
    kw = dict(bounds=BOUNDS, burnin=burnin, Np=Np, n_groups=n_groups)
    kw.update(de_kwargs)
    return make_model(data), DE(**kw)
