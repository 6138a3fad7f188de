"""β-mutation: Gaussian jitter proposal (port of
``demcmc_tpu.ops.mutation``; reference ``src/mutation.jl:13-25``).

The TPU kernel draws one gate per group from the group leader's word and
the normals by Box–Muller (``fused_step.py:2386-2400``); so does
:func:`kernel_mutate`, the plain versions' form.  :func:`mutate` is the
unfused step's, with the normals from its pool.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import rng
from ..utils.dists import const

TWO_PI = float(np.float32(2.0 * math.pi))


def box_muller(u1, u2):
    """N(0, 1) from uniforms: ``sqrt(-2 log max(u1, tiny)) cos(2π u2)``."""
    u1 = torch.clamp_min(u1, rng.TINY)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * u2)


def kernel_mutate(theta, prop, gate, nrm, beta: float, sigma: float):
    """Where a group's gate ``<= beta`` its chains propose
    ``theta + sigma · nrm`` instead of ``prop``.  ``gate`` is ``[G]``."""
    mut = (gate <= float(np.float32(beta)))[:, None, None]
    return torch.where(mut, theta + float(np.float32(sigma)) * nrm, prop)


def mutate(draws, theta, sigma: float):
    """θ′ = θ + N(0, σ) per scalar over the population ``[G, Np, d]``,
    the normals of the state's dtype from the unfused step's pool
    (``demcmc_tpu/ops/mutation.py:16``)."""
    return theta + const(sigma, theta.dtype) * draws.normal(
        tuple(theta.shape), theta.dtype)
