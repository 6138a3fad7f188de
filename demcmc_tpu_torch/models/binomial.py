"""Binomial θ model with its conjugate oracle, in the pseudo-marginal ABC
form (port of ``demcmc_tpu.models.binomial``).

Reference ``Examples/Binomial_ABC.jl``: the likelihood of k successes in N
trials is estimated by the fraction of n_sim simulated Binomial(N, θ)
counts that hit k, re-simulated on every evaluation; θ ~ Beta(1, 1) on
[0, 1].  The pseudo-marginal chain targets the exact posterior
Beta(k + 1, N − k + 1) (Andrieu and Roberts 2009).

The batched density is the JAX model's inverse-CDF form
(``demcmc_tpu/models/binomial.py:50-86``): one uniform per simulation from
the step's noise panel, the count Σ_j 1{u > CDF_j}.  The exact variant
(``abc=False``, ``binomial.py:29``) has a per-cell likelihood and no CUDA
density, so it runs the unfused step.  The fixed-noise ABC variant
(``abc=True, fresh_noise=False``) is deterministic: the JAX model draws
``bernoulli(PRNGKey(123), θ, (n_sim, N))``, which is ``uniform(PRNGKey(123),
(n_sim, N)) < θ`` (``binomial.py:32-45``); the port takes that uniform
panel as data (``make(..., panel=)``, the JAX panel carried across; numpy
seed 123 without it) and counts Σ_j 1{u_j < θ}, equal to the JAX model
on the same panel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import DE
from ..model import CudaDensity, DEModel, DeviceArrays
from ..utils import dists

BOUNDS = ((0.0, 1.0),)
NAMES = ("theta",)
MAX_N = 64          # largest N of csrc/densities/binomial_abc.cuh


def comb_f32(N: int):
    """``float32(comb(N, j))`` for j = 0..N−1, exact binomial coefficients
    rounded once (what ``float(scipy.special.comb(N, j))`` gives after the
    JAX model's float32 cast)."""
    return [float(np.float32(math.comb(N, j))) for j in range(N)]


def integer_pow(x, n: int):
    """``x ** n`` for an integer n ≥ 0 by square-and-multiply, the order of
    JAX's ``integer_pow`` lowering (``acc·x`` on set bits, ``x·x`` between
    them); ``x ** 0`` is 1."""
    if n == 0:
        return torch.ones_like(x)
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def cdf_table(N: int, theta):
    """``[CDF_0 .. CDF_{N−1}]`` of Binomial(N, θ), each ``C(N, j) θ^j
    (1−θ)^(N−j)`` added in j order (``binomial.py:63-72``)."""
    one_m = 1.0 - theta
    cdfs, cdf = [], None
    for j, c in enumerate(comb_f32(N)):
        pmf = c * integer_pow(theta, j) * integer_pow(one_m, N - j)
        cdf = pmf if cdf is None else cdf + pmf
        cdfs.append(cdf)
    return cdfs


def loglike_abc_batched(data, theta, *, noise):
    """Chains-last pseudo-marginal ABC log likelihood: ``theta [*cs]``,
    ``noise [n_sim, *cs]`` uniforms; ``log(hits / n_sim)`` with hits the
    simulations whose count Σ_j 1{u > CDF_j} equals k.  Counts and hits
    are small integers, exact in any summation order."""
    N, k = int(data["N"]), int(data["k"])
    hits = torch.zeros_like(theta, dtype=torch.int64)
    for s0 in range(0, noise.shape[0], 1024):        # bounded memory
        u = noise[s0:s0 + 1024]
        cnt = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
        for cj in cdf_table(N, theta):
            cnt += u > cj
        hits += (cnt == k).sum(0)
    return torch.log(dists.div(hits.to(theta.dtype), float(noise.shape[0])))


def abc_hits(panel, N: int, k: int, theta):
    """How many of the fixed panel's simulations hit ``k``: ``panel
    [n_sim, N]`` uniforms, ``theta [*cs]``; a simulation's count is
    Σ_j 1{u_j < θ} (``binomial.py:32-45``).  Exact integers, ``[*cs]``."""
    n_sim = panel.shape[0]
    t = theta.reshape(-1)
    hits = torch.zeros(t.shape, dtype=torch.int64, device=t.device)
    for s0 in range(0, n_sim, 1024):                 # bounded memory
        cnt = (panel[s0:s0 + 1024, :, None] < t).sum(1)
        hits = hits + (cnt == k).sum(0)
    return hits.reshape(theta.shape)


def abc_fraction(panel, N: int, k: int, theta):
    """The fraction of the fixed panel's simulations that hit ``k``
    (:func:`abc_hits`), taken as ``hits · (1 / n_sim)``, as XLA lowers the
    JAX model's ``jnp.mean``."""
    return abc_hits(panel, N, k, theta).to(theta.dtype) * dists.const(
        1.0 / panel.shape[0], theta.dtype)


def loglike_abc_fixed(panel, N: int, k: int, theta):
    """Fixed-panel ABC log likelihood: the log of :func:`abc_fraction`."""
    return torch.log(abc_fraction(panel, N, k, theta))


def abc_panel(n_sim: int, N: int, seed: int = 123) -> np.ndarray:
    """The fixed model's ``[n_sim, N]`` float32 uniform panel from numpy
    seed ``seed`` (the JAX model's is ``jax.random.uniform(PRNGKey(123),
    (n_sim, N))``; pass it to :func:`make` to hold the port to it)."""
    return np.random.default_rng(seed).random((n_sim, N), dtype=np.float32)


def prior_loglike_batched(theta):
    return torch.zeros_like(theta)            # Beta(1, 1)


def sample_prior(uniform, n):
    """``n`` draws of θ ~ U(0, 1) = Beta(1, 1)."""
    return [uniform(1)[0]]


def density(N: int, k: int, n_sim: int) -> CudaDensity:
    """The kernel density ``csrc/densities/binomial_abc.cuh``: (N, k,
    n_sim) and the float32 coefficients C(N, j) as its data buffer."""
    if not 1 <= N <= MAX_N:
        raise ValueError(f"the CUDA ABC density takes 1 <= N <= {MAX_N}")
    return CudaDensity("binomial_abc", (float(N), float(k), float(n_sim)),
                       data=np.asarray(comb_f32(N), np.float32))


def loglike(data, theta):
    """Exact per-cell log likelihood ``log Binomial(k; N, θ)``
    (``jax.scipy.stats.binom.logpmf``): the log binomial coefficient,
    folded in float64 and rounded once, then ``xlogy(k, θ) +
    xlog1py(N − k, −θ)``."""
    N, k = int(data["N"]), int(data["k"])
    comb = dists.f32(math.lgamma(N + 1.0) - math.lgamma(k + 1.0)
                     - math.lgamma(N - k + 1.0))
    return comb + (torch.special.xlogy(float(k), theta)
                   + torch.special.xlog1py(float(N - k), -theta))


def make_model(N: int, k: int, abc: bool = False, fresh_noise: bool = False,
               n_sim: int = 10_000, panel=None) -> DEModel:
    """The exact model (``abc=False``), the fixed-panel ABC model (``abc=True,
    fresh_noise=False``: the ``[n_sim, N]`` uniform ``panel``, by default
    :func:`abc_panel`) or the pseudo-marginal ABC model (``abc=True,
    fresh_noise=True``: a fresh panel of ``n_sim`` uniforms per
    evaluation)."""
    data = {"N": int(N), "k": int(k)}
    if not abc:
        return DEModel(loglike=loglike,
                       prior_loglike_batched=prior_loglike_batched,
                       sample_prior=sample_prior, names=NAMES, data=data)
    if not fresh_noise:
        if panel is None:
            panel = abc_panel(int(n_sim), int(N))
        arrays = DeviceArrays(np.asarray(panel, np.float32))
        if arrays.arrays[0].shape != (int(n_sim), int(N)):
            raise ValueError(f"panel: need [{n_sim}, {N}] uniforms, got "
                             f"{arrays.arrays[0].shape}")

        def loglike_fixed(data, theta):
            (u,) = arrays.on(theta.device)
            return loglike_abc_fixed(u, data["N"], data["k"], theta)

        return DEModel(loglike_batched=loglike_fixed,
                       prior_loglike_batched=prior_loglike_batched,
                       sample_prior=sample_prior, names=NAMES, data=data)
    return DEModel(loglike_batched=loglike_abc_batched,
                   prior_loglike_batched=prior_loglike_batched,
                   sample_prior=sample_prior, names=NAMES, data=data,
                   cuda_density=density(int(N), int(k), int(n_sim)),
                   noise_shape=(int(n_sim),))


def make(N=10, k=None, key=0, abc=False, fresh_noise=False, Np=4,
         burnin=1000, n_sim=10_000, panel=None, **de_kwargs):
    """Build (model, de) with the JAX ``make``'s defaults; without ``k``,
    a Binomial(N, 0.5) draw from numpy seed ``key``; ``panel`` the fixed
    ABC model's uniforms."""
    if k is None:
        k = int(np.random.default_rng(key).binomial(N, 0.5))
    model = make_model(N, k, abc=abc, fresh_noise=fresh_noise, n_sim=n_sim,
                       panel=panel)
    return model, DE(bounds=BOUNDS, burnin=burnin, Np=Np, **de_kwargs)


def conjugate_posterior(N: int, k: int):
    """Beta(k+1, N-k+1) moments — the closed-form oracle."""
    a, b = k + 1.0, N - k + 1.0
    mean = a / (a + b)
    var = a * b / ((a + b) ** 2 * (a + b + 1.0))
    return {"mean": mean, "std": var ** 0.5}
