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


def div(x, c: float):
    """``x / c`` for a Python constant ``c``, rounded as a true division on
    every device: on CUDA, PyTorch divides by a host scalar as ``x · (1/c)``,
    which differs from ``x / c`` (and from the kernels' and XLA's division)
    by an ulp unless c is a power of two."""
    return x / torch.full_like(x, c)


LOG2 = f32(math.log(2.0))
LOG_2PI = f32_log(2.0 * math.pi)
LOG_PI = f32_log(math.pi)


def normal_consts(sigma: float):
    """The float32 ``(σ², log(2π σ²))`` that ``norm.logpdf`` folds for a
    constant σ: both products in float32, as XLA folds them."""
    scale_sqrd = float(np.float32(sigma) * np.float32(sigma))
    return scale_sqrd, f32_log(float(np.float32(2.0 * math.pi)
                                     * np.float32(scale_sqrd)))


def normal_logpdf(x, mu=0.0, sigma=1.0):
    """``jax.scipy.stats.norm.logpdf``: ``(log(2π σ²) + (x-μ)²/σ²) / -2``."""
    if isinstance(sigma, (int, float)):
        scale_sqrd, log_normalizer = normal_consts(sigma)
        quadratic = div((x - f32(mu)) * (x - f32(mu)), scale_sqrd)
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


def uniform_logpdf(x, lo=0.0, hi=1.0):
    """``-log(hi - lo)`` inside ``[lo, hi]``, ``-inf`` outside (the JAX
    package's form; the constant folded as a float32 log)."""
    inside = (x >= f32(lo)) & (x <= f32(hi))
    c = -f32_log(float(hi) - float(lo))
    return torch.where(inside, torch.full_like(x, c),
                       torch.full_like(x, -math.inf))


# Abramowitz & Stegun 7.1.26: erfc(x) ≈ exp(-x²) · t · poly(t), t = 1 / (1 +
# AS_ERFC_P · x), x ≥ 0 (|abs err| < 1.5e-7) — the JAX package's constants.
AS_ERFC_P = 0.3275911
AS_ERFC_COEFFS = (0.254829592, -0.284496736, 1.421413741,
                  -1.453152027, 1.061405429)


def as_erfc_poly(t):
    """The Horner polynomial ``t·(a1 + t·(a2 + t·(a3 + t·(a4 + t·a5))))``
    with float32 coefficients (``csrc/special.cuh`` twin)."""
    a1, a2, a3, a4, a5 = (f32(a) for a in AS_ERFC_COEFFS)
    return t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))


LGAMMA_HALF_LOG_2PI = f32(0.5 * math.log(2.0 * math.pi))


def lgamma32(x):
    """float32 log-gamma, operation for operation the JAX kernel's
    ``_lgamma32`` (``demcmc_tpu/ops/fused_step.py:1261-1286``): shift x up
    to z = x + n, n = ⌈max(8 − x, 0)⌉, with the product of the shifted
    terms, then a 3-term Stirling series.  Not ``torch.lgamma``.  Valid
    for x > 0; the densities mask the poles."""
    n = torch.ceil(torch.maximum(8.0 - x, torch.zeros_like(x)))
    one = torch.ones_like(x)
    prod = torch.where(n > 0, x, one)
    for i in range(1, 8):
        prod = prod * torch.where(float(i) < n, x + float(i), one)
    z = x + n
    zi = 1.0 / z
    zi2 = zi * zi
    series = zi * (f32(1.0 / 12.0) + zi2 * (f32(-1.0 / 360.0)
                                             + zi2 * f32(1.0 / 1260.0)))
    lg = ((z - 0.5) * torch.log(z) - z + LGAMMA_HALF_LOG_2PI + series)
    return lg - torch.log(prod)


def sample_halfcauchy(u, scale=1.0):
    """|Cauchy(0, scale)| from uniforms ``u`` in [0, 1): the JAX
    package's ``scale * tan(π (u' - 0.5))`` with ``u'`` on [0.5, 1)."""
    u = 0.5 + 0.5 * u
    return scale * torch.tan(math.pi * (u - 0.5))
