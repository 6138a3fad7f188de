"""Log-density helpers in torch, op for op as ``demcmc_tpu.utils.dists``.

Each function keeps the operation order of the ``jax.scipy.stats`` routine
the JAX package calls, so float32 results agree with it to the last few
ulp.  Constants built only from Python floats are rounded to float32 once
on the host (from a float64 evaluation), as JAX folds them at trace time;
the CUDA densities (``csrc/densities/*.cuh``) receive the same constants.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def f32_log(x: float) -> float:
    """float32 log of a float32-rounded Python constant, correctly
    rounded (what a folded ``jnp.log`` of a weak float constant gives)."""
    return float(np.float32(math.log(float(np.float32(x)))))


def f32(x: float) -> float:
    return float(np.float32(x))


LOG2 = f32(math.log(2.0))
LOG_2PI = f32_log(2.0 * math.pi)
LOG_PI = f32_log(math.pi)


def normal_logpdf(x, mu=0.0, sigma=1.0):
    """``jax.scipy.stats.norm.logpdf``: ``(log(2π σ²) + (x-μ)²/σ²) / -2``."""
    if isinstance(sigma, (int, float)):
        scale_sqrd = f32(float(sigma) * float(sigma))
        log_normalizer = f32_log(f32(2.0 * math.pi) * scale_sqrd)
    else:
        scale_sqrd = sigma * sigma
        log_normalizer = torch.log(f32(2.0 * math.pi) * scale_sqrd)
    quadratic = (x - mu) * (x - mu) / scale_sqrd
    return (log_normalizer + quadratic) / -2.0


def halfcauchy_logpdf(x, scale=1.0):
    """truncated(Cauchy(0, scale), 0, Inf): log 2 + Cauchy logpdf for
    x >= 0, -inf below (``jax.scipy.stats.cauchy.logpdf`` order)."""
    scaled = (x - 0.0) / scale
    normalize_term = f32_log(math.pi * scale)
    lp = LOG2 + -(normalize_term + torch.log1p(scaled * scaled))
    return torch.where(x >= 0, lp, torch.full_like(lp, -math.inf))


def sample_halfcauchy(u, scale=1.0):
    """|Cauchy(0, scale)| from uniforms ``u`` in [0, 1): the JAX
    package's ``scale * tan(π (u' - 0.5))`` with ``u'`` on [0.5, 1)."""
    u = 0.5 + 0.5 * u
    return scale * torch.tan(math.pi * (u - 0.5))
