"""Hierarchical Gaussian with group-level priors and block updating (port
of ``demcmc_tpu.models.hierarchical``).

Reference ``Examples/Hierarchical_Example.jl``: parameters (μβ0, σβ0,
β0[1..S], σ); priors μβ0 ~ Normal(1, 1), σβ0 and σ ~ truncated(Cauchy(0,
1), 0, Inf), β0ᵢ ~ Normal(0, σβ0); data yᵢⱼ ~ Normal(μβ0 + β0ᵢ, σ) for S
subjects of n_data observations.  The sampler is DE-MCz with snooker, two
groups and two blocks updated in turn, (μβ0, σβ0, σ) and then β0.  The
density is chains-last and batched; the model names no CUDA density, so
it runs the unfused step, on the card as on the CPU.  The JAX model draws
its data with ``jax.random``; the port draws it with numpy (``make``), so
a comparison passes the data to both.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import rng
from ..config import DE
from ..model import DEModel, DeviceArrays
from ..utils import dists

NAMES = ("mu_b0", "sigma_b0", "b0", "sigma")
BOUNDS = ((-math.inf, math.inf), (0.0, math.inf), (-math.inf, math.inf),
          (0.0, math.inf))


def simulate(rng_np, n_subj: int, n_data: int) -> np.ndarray:
    """``[n_subj, n_data]`` float32 data as the JAX ``make`` draws it:
    β0ᵢ ~ N(0, 1), yᵢⱼ = 1 + β0ᵢ + 0.5 zᵢⱼ, here from numpy."""
    b0 = rng_np.standard_normal(n_subj)
    z = rng_np.standard_normal((n_subj, n_data))
    return (1.0 + b0[:, None] + 0.5 * z).astype(np.float32)


def _normals(u1, u2):
    """Box–Muller normals from two uniform rows."""
    u1 = torch.clamp_min(u1, rng.TINY)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(rng.TWO_PI * u2)


def make_model(data) -> DEModel:
    """The model on ``data [n_subj, n_data]``."""
    arrays = DeviceArrays(np.asarray(data, np.float32))
    n_subj = arrays.arrays[0].shape[0]

    def prior_loglike_batched(mu_b0, sigma_b0, b0, sigma):
        """``b0 [S, *cs]``, the others ``[*cs]``."""
        return (dists.normal_logpdf(mu_b0, 1.0, 1.0)
                + dists.halfcauchy_logpdf(sigma_b0)
                + torch.sum(dists.normal_logpdf(b0, 0.0, sigma_b0), 0)
                + dists.halfcauchy_logpdf(sigma))

    def loglike_batched(data, mu_b0, sigma_b0, b0, sigma):
        (y,) = arrays.on(b0.device)
        cs = b0.dim() - 1
        yy = y.reshape(y.shape + (1,) * cs)                # [S, n, *1]
        mu = (mu_b0 + b0)[:, None]                         # [S, 1, *cs]
        return torch.sum(dists.normal_logpdf(yy, mu, sigma), (0, 1))

    def sample_prior(uniform, n):
        """μβ0 = 1 + z, σβ0 and σ half-Cauchy, β0 = σβ0·z (S normals), the
        normals by Box–Muller from pairs of uniform rows."""
        u = uniform(2 * (n_subj + 1) + 2)
        z = _normals(u[0:2 * (n_subj + 1):2], u[1:2 * (n_subj + 1):2])
        sigma_b0 = dists.sample_halfcauchy(u[-2])
        sigma = dists.sample_halfcauchy(u[-1])
        return [1.0 + z[0], sigma_b0, (sigma_b0 * z[1:]).T, sigma]

    return DEModel(loglike_batched=loglike_batched,
                   prior_loglike_batched=prior_loglike_batched,
                   sample_prior=sample_prior, names=NAMES,
                   data=arrays.arrays[0])


def make(n_subj=20, n_data=50, key=0, data=None, blocking=True,
         **de_kwargs):
    """Build (model, de) with the JAX ``make``'s configuration: Np = 3,
    two groups, θsnooker = 0.1, DE-MCz with n_initial = 4 (S + 1), burn-in
    2,000 and, with ``blocking``, the blocks (μβ0, σβ0, σ) and β0 every
    iteration; without ``data``, ``simulate`` from numpy seed ``key``."""
    if data is None:
        data = simulate(np.random.default_rng(key), n_subj, n_data)
    data = np.asarray(data, np.float32)
    S = data.shape[0]
    blocks, blocking_on = None, False
    if blocking:
        blocks = [[True, True, np.zeros(S, bool), True],
                  [False, False, np.ones(S, bool), False]]
        blocking_on = True
    kw = dict(bounds=BOUNDS, Np=3, n_groups=2, theta_snooker=0.1,
              sample="resample", n_initial=(S + 1) * 4, burnin=2000,
              blocks=blocks, blocking_on=blocking_on)
    kw.update(de_kwargs)
    return make_model(data), DE(**kw)
