"""Binomial θ model with its conjugate oracle, in the pseudo-marginal ABC
form (port of ``demcmc_tpu.models.binomial``).

Reference ``Examples/Binomial_ABC.jl``: the likelihood of k successes in N
trials is estimated by the fraction of n_sim simulated Binomial(N, θ)
counts that hit k, re-simulated on every evaluation; θ ~ Beta(1, 1) on
[0, 1].  The pseudo-marginal chain targets the exact posterior
Beta(k + 1, N − k + 1) (Andrieu and Roberts 2009).

The batched density is the JAX model's inverse-CDF form
(``demcmc_tpu/models/binomial.py:50-86``): one uniform per simulation from
the step's noise panel, the count Σ_j 1{u > CDF_j}.  The exact-likelihood
variant has no batched density in the JAX package (it runs the unfused
step only) and is not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import DE
from ..model import CudaDensity, DEModel
from ..utils import dists

BOUNDS = ((0.0, 1.0),)
NAMES = ("theta",)
MAX_N = 64          # CDF table size of csrc/densities/binomial_abc.cuh


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


def make_model(N: int, k: int, abc: bool = False, fresh_noise: bool = False,
               n_sim: int = 10_000) -> DEModel:
    """The pseudo-marginal ABC model (``abc=True, fresh_noise=True``):
    a fresh panel of ``n_sim`` uniforms per evaluation."""
    if not (abc and fresh_noise):
        raise NotImplementedError(
            "only the pseudo-marginal ABC binomial (abc=True, "
            "fresh_noise=True) is ported: the exact and the fixed-noise "
            "likelihoods run the JAX package's unfused step, which "
            "demcmc_tpu_torch does not have yet (ROADMAP.md A6)")
    return DEModel(loglike_batched=loglike_abc_batched,
                   prior_loglike_batched=prior_loglike_batched,
                   sample_prior=sample_prior, names=NAMES,
                   data={"N": int(N), "k": int(k)},
                   cuda_density=density(int(N), int(k), int(n_sim)),
                   noise_shape=(int(n_sim),))


def make(N=10, k=None, key=0, abc=False, fresh_noise=False, Np=4,
         burnin=1000, n_sim=10_000, **de_kwargs):
    """Build (model, de) with the JAX ``make``'s defaults; without ``k``,
    a Binomial(N, 0.5) draw from numpy seed ``key``."""
    if k is None:
        k = int(np.random.default_rng(key).binomial(N, 0.5))
    model = make_model(N, k, abc=abc, fresh_noise=fresh_noise, n_sim=n_sim)
    return model, DE(bounds=BOUNDS, burnin=burnin, Np=Np, **de_kwargs)


def conjugate_posterior(N: int, k: int):
    """Beta(k+1, N-k+1) moments — the closed-form oracle."""
    a, b = k + 1.0, N - k + 1.0
    mean = a / (a + b)
    var = a * b / ((a + b) ** 2 * (a + b + 1.0))
    return {"mean": mean, "std": var ** 0.5}
