"""Epanechnikov kernel density estimation in torch (port of
``demcmc_tpu.utils.kde``), batched over leading axes.

Reference ``Examples/KDE.jl`` (KernelDensity.jl with an Epanechnikov
kernel) behind the synthetic likelihood of ``Examples/KDE_Example.jl``.
Each function keeps the JAX package's operations: ``jnp.std`` is the
population sd (``correction=0`` here) and ``jnp.quantile`` interpolates
linearly as ``low·(1 − w) + high·w`` (not torch's ``lerp``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import dists


def _quantile(sorted_x, q: float):
    """``jnp.quantile(x, q)`` (method "linear") of ascending ``sorted_x``
    along its last axis: position ``q·(n − 1)`` in float32, the two
    neighbours weighted ``1 − w`` and ``w``."""
    n = sorted_x.shape[-1]
    pos = np.float32(q) * np.float32(n - 1)
    lo, hi = int(math.floor(pos)), int(math.ceil(pos))
    w_hi = np.float32(pos - np.float32(lo))
    w_lo = np.float32(1.0) - w_hi
    return (sorted_x[..., lo] * float(w_lo)
            + sorted_x[..., hi] * float(w_hi))


def silverman_bandwidth(samples, alpha: float = 0.9):
    """Silverman's rule of thumb over the last axis of ``samples``:
    0.9 · min(sd, IQR / 1.34) · n^(−1/5), with the sd where the IQR is 0
    (``demcmc_tpu/utils/kde.py:16``)."""
    n = samples.shape[-1]
    std = torch.std(samples, dim=-1, correction=0)
    s = torch.sort(samples, dim=-1).values
    iqr = _quantile(s, 0.75) - _quantile(s, 0.25)
    width = torch.minimum(std, dists.div(iqr, 1.34))
    width = torch.where(width <= 0, torch.clamp_min(std, 1e-6), width)
    return alpha * width * n ** (-0.2)


def epanechnikov_pdf(x, samples, bandwidth=None):
    """KDE density of ``x [E]`` under ``samples [..., S]`` with K(u) =
    0.75 (1 − u²) 1[|u| ≤ 1], bandwidth ``[...]`` (Silverman's by
    default); returns ``[..., E]``."""
    if bandwidth is None:
        bandwidth = silverman_bandwidth(samples)
    h = bandwidth[..., None, None]
    u = (x[:, None] - samples[..., None, :]) / h
    k = torch.where(torch.abs(u) <= 1.0, 0.75 * (1.0 - u * u),
                    torch.zeros_like(u))
    return torch.mean(k, dim=-1) / h[..., 0]


def epanechnikov_logpdf(x, samples, bandwidth=None, floor: float = 1e-10):
    """log KDE density with the reference's 1e-10 floor
    (``Examples/KDE_Example.jl:10``)."""
    return torch.log(torch.clamp_min(epanechnikov_pdf(x, samples, bandwidth),
                                     floor))
