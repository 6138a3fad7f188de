"""ABC model with a synthetic KDE likelihood (port of
``demcmc_tpu.models.abc_kde``, its default fixed-panel form).

Reference ``Examples/KDE_Example.jl``: the Gaussian (μ, σ) model whose
likelihood is a kernel density estimate over ``n_sim`` forward
simulations, evaluated at the observed data.  The simulations are ``μ +
σ·noise`` for one fixed panel of standard normals (common random
numbers), so the synthetic likelihood is a deterministic function of θ.

The density is batched: ``[C, n_sim]`` simulations, Silverman's bandwidth
per chain, then :func:`demcmc_tpu_torch.ops.kde.kde_logpdf` (CUDA kernel
K4 on the card), summed over the observations.  ``make(data=, noise=)``
takes the JAX model's data and panel as numpy arrays (carried across);
without them both come from numpy seeds.  The fresh-noise form (a new
panel at every evaluation) is ROADMAP A6-rest.
"""

from __future__ import annotations

import numpy as np

from ..config import DE
from ..model import DEModel, DeviceArrays
from ..ops import kde as kde_ops
from ..utils import kde as kde_utils
from .gaussian import BOUNDS, NAMES, prior_loglike_batched, sample_prior

FLOOR = 1e-10              # the reference's density floor (KDE_Example.jl:10)


def make_model(data, noise) -> DEModel:
    """The fixed-panel model on ``data [n_obs]`` and ``noise [n_sim]``."""
    arrays = DeviceArrays(np.asarray(data, np.float32),
                          np.asarray(noise, np.float32))

    def loglike_batched(data, mu, sigma):
        x, panel = arrays.on(mu.device)
        sims = mu.reshape(-1, 1) + sigma.reshape(-1, 1) * panel
        h = kde_utils.silverman_bandwidth(sims)
        lp = kde_ops.kde_logpdf(x, sims, h, FLOOR)
        return lp.sum(-1).reshape(mu.shape)

    return DEModel(loglike_batched=loglike_batched,
                   prior_loglike_batched=prior_loglike_batched,
                   sample_prior=sample_prior, names=NAMES,
                   data=arrays.arrays[0])


def make(data=None, noise=None, key=0, n_obs=50, n_sim=10_000, sim_key=7,
         Np=6, n_groups=4, burnin=1000, **de_kwargs):
    """Build (model, de) with the JAX ``make``'s defaults; without
    ``data``, ``n_obs`` standard normals from numpy seed ``key``, without
    ``noise`` ``n_sim`` from numpy seed ``sim_key``."""
    if data is None:
        data = np.random.default_rng(key).standard_normal(n_obs)
    if noise is None:
        noise = np.random.default_rng(sim_key).standard_normal(n_sim)
    model = make_model(data, noise)
    de = DE(bounds=BOUNDS, burnin=burnin, Np=Np, n_groups=n_groups,
            **de_kwargs)
    return model, de
