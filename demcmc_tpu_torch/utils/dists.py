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


def const(x: float, dtype) -> float:
    """A Python constant as JAX folds a weak-typed one into an array of
    torch ``dtype``: rounded to float32 for a float32 array, kept for a
    float64 one."""
    return f32(x) if dtype == torch.float32 else float(x)


def div(x, c: float):
    """``x / c`` for a Python constant ``c``, rounded as a true division on
    every device: on CUDA, PyTorch divides by a host scalar as ``x · (1/c)``,
    which differs from ``x / c`` (and from the kernels' and XLA's division)
    by an ulp unless c is a power of two."""
    return x / torch.full_like(x, c)


LOG2 = f32(math.log(2.0))
HALF_LOG_2PI = f32(0.5 * math.log(2.0 * math.pi))
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
        dx = x - f32(mu)
        quadratic = dx * dx
        if scale_sqrd != 1.0:           # x / 1 is x: no launch for it
            quadratic = div(quadratic, scale_sqrd)
    else:
        scale_sqrd = sigma * sigma
        log_normalizer = torch.log(f32(2.0 * math.pi) * scale_sqrd)
        dx = x - mu
        quadratic = dx * dx / scale_sqrd
    return (log_normalizer + quadratic) / -2.0


def halfcauchy_logpdf(x, scale=1.0):
    """truncated(Cauchy(0, scale), 0, Inf): log 2 + Cauchy logpdf for
    x >= 0, -inf below (``jax.scipy.stats.cauchy.logpdf`` order)."""
    # x − 0 and x / 1 are x, and c + −y is c − y: the same bits in fewer
    # launches (the unfused step is host-bound)
    scaled = x if scale == 1.0 else (x - 0.0) / scale
    normalize_term = f32_log(math.pi * scale)
    lp = LOG2 - (normalize_term + torch.log1p(scaled * scaled))
    return torch.where(x >= 0, lp, -math.inf)


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
    lg = ((z - 0.5) * torch.log(z) - z + HALF_LOG_2PI + series)
    return lg - torch.log(prod)


def sample_halfcauchy(u, scale=1.0):
    """|Cauchy(0, scale)| from uniforms ``u`` in [0, 1): the JAX
    package's ``scale * tan(π (u' - 0.5))`` with ``u'`` on [0.5, 1)."""
    u = 0.5 + 0.5 * u
    return scale * torch.tan(math.pi * (u - 0.5))


# log Φ's float32 segments and the asymptotic series' order
# (jax/_src/scipy/special.py: _LOGNDTR_FLOAT32_LOWER/UPPER, series_order)
LOGNDTR_LOWER, LOGNDTR_UPPER, LOGNDTR_ORDER = -10.0, 5.0, 3
HALF_SQRT2 = float(np.float32(0.5) * np.sqrt(np.float32(2.0)))


def ndtr(x):
    """Φ(x) through erf and erfc, as ``jax.scipy.special.ndtr``."""
    w = x * HALF_SQRT2
    z = torch.abs(w)
    y = torch.where(z < HALF_SQRT2, 1.0 + torch.special.erf(w),
                    torch.where(w > 0.0, 2.0 - torch.special.erfc(z),
                                torch.special.erfc(z)))
    return 0.5 * y


def log_ndtr(x):
    """log Φ(x), ``jax.scipy.special.log_ndtr`` (which
    ``jax.scipy.stats.norm.logcdf`` is) in its float32 form: −Φ(−x) above
    5, log Φ(x) down to −10, below that the asymptotic series of order 3.
    Plain elementwise torch, so ``vmap`` batches it (torch's
    ``special.log_ndtr`` has no batching rule)."""
    lo = torch.full_like(x, LOGNDTR_LOWER)
    xl = torch.minimum(x, lo)
    x2 = xl * xl
    series = torch.ones_like(x)
    x2n = x2
    for n in range(1, LOGNDTR_ORDER + 1):
        term = float(np.prod(np.arange(2 * n - 1, 1, -2))) / x2n
        series = series - term if n % 2 else series + term
        x2n = x2n * x2
    lower = (-0.5 * x2 - torch.log(-xl) - HALF_LOG_2PI
             + torch.log(series))
    return torch.where(
        x > LOGNDTR_UPPER, -ndtr(-x),
        torch.where(x > LOGNDTR_LOWER,
                    torch.log(ndtr(torch.maximum(x, lo))), lower))


def normal_cdf(x, mu=0.0, sigma=1.0):
    """Φ((x − μ) / σ), ``jax.scipy.stats.norm.cdf``: :func:`ndtr` of the
    standardized value; a Python ``x`` gives a float32 scalar tensor, as
    JAX folds a constant bound."""
    if not torch.is_tensor(x):
        x = torch.tensor(float(x), dtype=torch.float32)
    return ndtr((x - f32(mu)) / f32(sigma))


def truncated_logpdf(logpdf_fn, cdf_fn, x, lo=-math.inf, hi=math.inf):
    """Generic truncation (``demcmc_tpu/utils/dists.py:52-57``, Distributions.jl
    ``truncated``): ``logpdf(x) − log(cdf(hi) − cdf(lo))`` inside ``[lo,
    hi]``, ``-inf`` outside; the normalizer of constant bounds in float32,
    as JAX folds it."""
    z = cdf_fn(hi) - cdf_fn(lo)
    lp = logpdf_fn(x) - torch.log(z).to(x.dtype)
    inside = (x >= lo) & (x <= hi)
    return torch.where(inside, lp, torch.full_like(lp, -math.inf))


def truncated_normal_logpdf(x, mu, sigma, lo, hi):
    """Normal(μ, σ) truncated to ``[lo, hi]`` (the Lotka–Volterra priors,
    ``demcmc_tpu/models/lotka_volterra.py:70-73``)."""
    return truncated_logpdf(lambda v: normal_logpdf(v, mu, sigma),
                            lambda v: normal_cdf(v, mu, sigma), x, lo, hi)


def inverse_gamma_logpdf(x, a=2.0, b=3.0):
    """InverseGamma(a, b) log density, ``a log b − lgamma(a) − (a + 1) log
    x − b / x`` for x > 0, ``-inf`` else (``demcmc_tpu/models/
    lotka_volterra.py:64-67``), the constants folded in float32 and ``b /
    x`` a true division."""
    c = f32(f32(a) * f32_log(b) - math.lgamma(a))
    lp = c - f32(a + 1.0) * torch.log(x) - div_by(b, x)
    return torch.where(x > 0, lp, torch.full_like(lp, -math.inf))


def div_by(c: float, x):
    """``c / x`` for a Python constant ``c``, a true division on every
    device (``c / x`` in torch is ``c · (1 / x)``)."""
    return torch.full_like(x, c) / x


def sample_truncated_normal(u, mu, sigma, lo, hi):
    """Normal(μ, σ) truncated to ``[lo, hi]`` from uniforms ``u`` in [0,
    1) by the inverse CDF (``demcmc_tpu/utils/dists.py:97-104``, there
    through ``erf_inv``; here ``ndtri``): μ + σ Φ⁻¹(a + u (b − a)), a and
    b the bounds' CDFs."""
    a = float(normal_cdf(lo, mu, sigma))
    b = float(normal_cdf(hi, mu, sigma))
    return f32(mu) + f32(sigma) * torch.special.ndtri(a + u * (b - a))


def sample_gamma2(u1, u2):
    """Gamma(2, 1) draws from two uniform rows: −log u₁ − log u₂ (the sum
    of two Exp(1) draws), each u clamped to the smallest normal."""
    t = torch.finfo(u1.dtype).tiny
    return -torch.log(torch.clamp_min(u1, t)) - torch.log(
        torch.clamp_min(u2, t))
