"""ABC model with a synthetic KDE likelihood (port of
``demcmc_tpu.models.abc_kde``).

Reference ``Examples/KDE_Example.jl``: the Gaussian (μ, σ) model whose
likelihood is a kernel density estimate over ``n_sim`` forward
simulations, evaluated at the observed data.  By default the simulations
are ``μ + σ·noise`` for one fixed panel of standard normals (common
random numbers), so the synthetic likelihood is a deterministic function
of θ.  With ``fresh_noise=True`` (the reference example's own semantics,
pseudo-marginal) every evaluation simulates anew: the model is
stochastic, with a panel of ``n_sim`` uniforms per chain and evaluation
(``noise_shape = (n_sim,)``), which it maps to standard normals by the
inverse CDF, ``z = Φ⁻¹(u + 2⁻²⁴)`` (the uniforms are multiples of 2⁻²³,
so the shift keeps every z finite and the set of values symmetric; it
cuts the normal at |z| ≈ 5.3).

The density is batched: ``[C, n_sim]`` simulations, Silverman's bandwidth
per chain, then :func:`demcmc_tpu_torch.ops.kde.kde_logpdf` (CUDA kernel
K4 on the card), summed over the observations.  ``make(data=, noise=)``
takes the JAX model's data and panel as numpy arrays (carried across);
without them both come from numpy seeds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DE
from ..model import DEModel, DeviceArrays
from ..ops import kde as kde_ops
from ..utils import kde as kde_utils
from .gaussian import BOUNDS, NAMES, prior_loglike_batched, sample_prior

FLOOR = 1e-10              # the reference's density floor (KDE_Example.jl:10)
HALF_ULP = 2.0 ** -24      # half the step of the panel's uniforms


def _kde_loglike(x, mu, sims):
    """Σ over the observations of the log KDE density of ``x`` under each
    chain's simulations ``sims [C, n_sim]``, shaped like ``mu``."""
    h = kde_utils.silverman_bandwidth(sims)
    lp = kde_ops.kde_logpdf(x, sims, h, FLOOR)
    return lp.sum(-1).reshape(mu.shape)


def make_model(data, noise=None, fresh_noise: bool = False,
               n_sim: int = None) -> DEModel:
    """The fixed-panel model on ``data [n_obs]`` and ``noise [n_sim]``, or
    with ``fresh_noise`` the pseudo-marginal model of ``n_sim``
    simulations per evaluation (``noise`` unused)."""
    if fresh_noise:
        arrays = DeviceArrays(np.asarray(data, np.float32))

        def loglike_fresh(data, mu, sigma, noise):
            (x,) = arrays.on(mu.device)
            z = torch.special.ndtri(noise.reshape(noise.shape[0], -1)
                                    + HALF_ULP)
            sims = (mu.reshape(1, -1) + sigma.reshape(1, -1) * z).T
            return _kde_loglike(x, mu, sims.contiguous())

        return DEModel(loglike_batched=loglike_fresh,
                       prior_loglike_batched=prior_loglike_batched,
                       sample_prior=sample_prior, names=NAMES,
                       data=arrays.arrays[0], noise_shape=(int(n_sim),))
    arrays = DeviceArrays(np.asarray(data, np.float32),
                          np.asarray(noise, np.float32))

    def loglike_batched(data, mu, sigma):
        x, panel = arrays.on(mu.device)
        sims = mu.reshape(-1, 1) + sigma.reshape(-1, 1) * panel
        return _kde_loglike(x, mu, sims)

    return DEModel(loglike_batched=loglike_batched,
                   prior_loglike_batched=prior_loglike_batched,
                   sample_prior=sample_prior, names=NAMES,
                   data=arrays.arrays[0])


def make(data=None, noise=None, key=0, n_obs=50, n_sim=10_000, sim_key=7,
         Np=6, n_groups=4, burnin=1000, fresh_noise=False, **de_kwargs):
    """Build (model, de) with the JAX ``make``'s defaults; without
    ``data``, ``n_obs`` standard normals from numpy seed ``key``, without
    ``noise`` (the fixed panel) ``n_sim`` from numpy seed ``sim_key``.
    ``fresh_noise=True`` simulates anew at every evaluation."""
    if data is None:
        data = np.random.default_rng(key).standard_normal(n_obs)
    if noise is None and not fresh_noise:
        noise = np.random.default_rng(sim_key).standard_normal(n_sim)
    model = make_model(data, noise, fresh_noise, n_sim)
    de = DE(bounds=BOUNDS, burnin=burnin, Np=Np, n_groups=n_groups,
            **de_kwargs)
    return model, de
