"""Linear Ballistic Accumulator choice-RT model (port of
``demcmc_tpu.models.lba``).

Reference ``Examples/Run_LBA.jl``: parameters (ν[2], A, k, τ), priors
ν ~ Normal(1, 5), A ~ Normal(0.8, 0.2), k ~ Normal(0.2, 0.1), τ ~ Uniform(0,
min_rt); bounds all positive with τ ≤ min_rt.  The density (Brown &
Heathcote 2008, drift sd s = 1) shares one exp between Φ and φ (A&S
7.1.26 erfc), as the JAX model does.

The batched likelihood is the JAX model's chains-last, accumulator-unrolled
form (``demcmc_tpu/models/lba.py:143-174``) with the trials summed in index
order (a loop), which is the order ``csrc/densities/lba.cuh`` sums them in;
the JAX kernel sums them in chunks (its ``chunk_obs``), so the two agree
to a tolerance, not bitwise.  The JAX model simulates its default data with
``jax.random``; the port simulates with numpy (``make``), so a comparison
passes the data to both.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import rng
from ..config import DE
from ..model import CudaDensity, DEModel
from ..utils import dists

NAMES = ("nu", "A", "k", "tau")
N_ACC = 2
TRUE = dict(nu=(3.0, 2.0), A=0.8, k=0.2, tau=0.3)   # the JAX make()'s
PRIOR = ((1.0, 5.0), (0.8, 0.2), (0.2, 0.1))       # (μ, σ) of ν, A, k
INV_SQRT2 = dists.f32(0.7071067811865476)
INV_SQRT_2PI = dists.f32(0.3989422804014327)
CLIP = dists.f32(1e-30)


def _Phi_phi(x):
    """Φ(x) and φ(x) sharing one exp(−x²/2) (``lba.py:37-54``, operation
    for operation): Φ = 1 − erfc(|x|/√2)/2 for x ≥ 0, erfc(|x|/√2)/2
    below, erfc by A&S 7.1.26."""
    e = torch.exp(-0.5 * x * x)
    t = 1.0 / (1.0 + dists.f32(dists.AS_ERFC_P) * (torch.abs(x) * INV_SQRT2))
    half_erfc = 0.5 * e * dists.as_erfc_poly(t)
    Phi = torch.where(x >= 0, 1.0 - half_erfc, half_erfc)
    return Phi, INV_SQRT_2PI * e


def lba_pdf_cdf(t, nu, b, A, s=1.0):
    """Defective first-passage density f(t) and CDF F(t) of one LBA
    accumulator at decision time t (``lba.py:57-70``)."""
    ts = t * s
    z1 = (b - A - t * nu) / ts
    z2 = (b - t * nu) / ts
    P1, p1 = _Phi_phi(z1)
    P2, p2 = _Phi_phi(z2)
    pdf = (1.0 / A) * (-nu * P1 + s * p1 + nu * P2 - s * p2)
    cdf = (1.0 + ((b - A - t * nu) / A) * P1
           - ((b - t * nu) / A) * P2
           + (ts / A) * p1 - (ts / A) * p2)
    return pdf, cdf


def lba_logpdf(choice, rt, nu, A, k, tau, s=1.0):
    """Per-trial log density of (choice, rt) pairs for one parameter set
    (``lba.py:73-86``): ``choice [n]`` int, ``rt [n]``, ``nu [n_acc]``."""
    b = A + k
    t = rt[:, None] - tau
    valid = t[:, 0] > 0
    tsafe = torch.where(t > 0, t, torch.ones_like(t))
    pdf, cdf = lba_pdf_cdf(tsafe, nu[None, :], b, A, s)
    pdf = torch.clamp(pdf, min=CLIP)
    surv = torch.clamp(1.0 - cdf, CLIP, 1.0)
    onehot = torch.nn.functional.one_hot(
        torch.as_tensor(choice, dtype=torch.int64), nu.shape[0]).to(pdf.dtype)
    ll = (onehot * torch.log(pdf) + (1.0 - onehot) * torch.log(surv)).sum(1)
    return torch.where(valid, ll, torch.full_like(ll, -math.inf))


def trials(data) -> np.ndarray:
    """The ``[n_trials, 2]`` float32 (choice, rt) table of ``(choice, rt)``
    — the density's data, and the kernel's device buffer."""
    choice, rt = data
    return np.stack([np.asarray(choice, np.float32),
                     np.asarray(rt, np.float32)], 1)


def trial_terms(data, nu, A, k, tau):
    """``[n_trials, *cs]`` per-trial log likelihoods in the JAX batched
    form: ``nu [2, *cs]``, ``A, k, tau [*cs]``; −inf where rt ≤ τ."""
    tab = torch.as_tensor(trials(data), device=A.device)
    exp = (slice(None),) + (None,) * A.dim()
    choice, rt = tab[:, 0][exp], tab[:, 1][exp]
    b = A + k
    t = rt - tau[None]
    valid = t > 0
    ts = torch.where(valid, t, torch.ones_like(t))
    inv_ts = 1.0 / ts
    inv_A = 1.0 / A[None]
    ll = torch.zeros_like(ts)
    for i in range(N_ACC):
        nui = nu[i][None]
        z1 = (k[None] - ts * nui) * inv_ts
        z2 = (b[None] - ts * nui) * inv_ts
        P1, p1 = _Phi_phi(z1)
        P2, p2 = _Phi_phi(z2)
        pdf = inv_A * (-nui * P1 + p1 + nui * P2 - p2)
        cdf = (1.0 + (k[None] - ts * nui) * inv_A * P1
               - (b[None] - ts * nui) * inv_A * P2
               + ts * inv_A * (p1 - p2))
        ll = ll + torch.where(choice == float(i),
                              torch.log(torch.clamp(pdf, min=CLIP)),
                              torch.log(torch.clamp(1.0 - cdf, CLIP, 1.0)))
    return torch.where(valid, ll, torch.full_like(ll, -math.inf))


def loglike_batched(data, nu, A, k, tau):
    """Chains-last LBA log likelihood, the trials summed in index order."""
    ll = trial_terms(data, nu, A, k, tau)
    s = ll[0]
    for j in range(1, ll.shape[0]):
        s = s + ll[j]
    return s


def make_prior(min_rt: float):
    def prior_loglike_batched(nu, A, k, tau):
        """``nu [2, *cs]``; A, k, tau ``[*cs]`` (``lba.py:136-141``)."""
        (mn, sn), (ma, sa), (mk, sk) = PRIOR
        lp_nu = dists.normal_logpdf(nu, mn, sn)
        return (lp_nu[0] + lp_nu[1] + dists.normal_logpdf(A, ma, sa)
                + dists.normal_logpdf(k, mk, sk)
                + dists.uniform_logpdf(tau, 0.0, min_rt))
    return prior_loglike_batched


def make_sample_prior(min_rt: float):
    def sample_prior(uniform, n):
        """``n`` prior draws, |·| of the normals so the initial weights are
        finite (``lba.py:123-130``): four normals by Box–Muller from eight
        uniform rows, τ uniform on [0, min_rt) from a ninth."""
        u = uniform(9)
        z = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u[:4], rng.TINY))) \
            * torch.cos(2.0 * math.pi * u[4:8])
        (mn, sn), (ma, sa), (mk, sk) = PRIOR
        nu = torch.abs(mn + sn * z[:2]).T
        A = torch.abs(ma + sa * z[2])
        k = torch.abs(mk + sk * z[3])
        return [nu, A, k, u[8] * dists.f32(min_rt)]
    return sample_prior


def simulate(rng_np, n, nu, A, k, tau, s=1.0):
    """Forward-simulate LBA trials with a numpy Generator (the algorithm of
    ``lba.py:89-101``): start points U(0, A), drifts N(ν, s); a trial
    whose drifts are all ≤ 0 never finishes and is dropped."""
    n_acc = len(nu)
    start = rng_np.uniform(0.0, A, (n, n_acc))
    drift = np.asarray(nu) + s * rng_np.standard_normal((n, n_acc))
    with np.errstate(divide="ignore", invalid="ignore"):
        ttf = np.where(drift > 0, (A + k - start) / drift, np.inf)
    ttf = np.where(np.isnan(ttf) | (ttf < 0), np.inf, ttf)
    choice = np.argmin(ttf, axis=1)
    rt = tau + np.min(ttf, axis=1)
    ok = np.isfinite(rt)
    return choice[ok].astype(np.int32), rt[ok].astype(np.float32)


def density(data) -> CudaDensity:
    """The kernel density ``csrc/densities/lba.cuh``: the prior constants
    (μ, σ², log 2πσ² of ν, A and k; min_rt and −log min_rt), the trial
    count, and the ``[n_trials, 2]`` table as its data buffer."""
    tab = trials(data)
    min_rt = float(tab[:, 1].min())
    consts = []
    for mu, sigma in PRIOR:
        consts += [dists.f32(mu), *dists.normal_consts(sigma)]
    return CudaDensity("lba", (*consts, dists.f32(min_rt),
                               -dists.f32_log(min_rt), float(len(tab))),
                       data=tab)


def make_model(data) -> DEModel:
    choice, rt = data
    data = (np.asarray(choice, np.int32), np.asarray(rt, np.float32))
    min_rt = float(data[1].min())
    return DEModel(loglike_batched=loglike_batched,
                   prior_loglike_batched=make_prior(min_rt),
                   sample_prior=make_sample_prior(min_rt), names=NAMES,
                   data=data, cuda_density=density(data))


def bounds(min_rt: float):
    return ((0.0, math.inf), (0.0, math.inf), (0.0, math.inf),
            (0.0, min_rt))


def make(data=None, key=0, n_trials=100, Np=15, n_groups=3, burnin=1500,
         **de_kwargs):
    """Build (model, de) with the JAX ``make``'s defaults; without ``data``,
    ``n_trials`` trials simulated at ν = (3, 2), A = 0.8, k = 0.2, τ = 0.3
    from numpy seed ``key``."""
    if data is None:
        data = simulate(np.random.default_rng(key), n_trials, **TRUE)
    model = make_model(data)
    kw = dict(bounds=bounds(float(model.data[1].min())), burnin=burnin,
              Np=Np, n_groups=n_groups)
    kw.update(de_kwargs)
    return model, DE(**kw)
