"""The hit test of the ABC binomial's CUDA density
(``demcmc_tpu_torch/csrc/densities/binomial_abc.cuh``) against the JAX
model's count rule (``demcmc_tpu/models/binomial.py::loglike_abc_batched``).

For θ in [0, 1] the kernel tests a simulation's uniform against two CDF
values, ``(k == 0 or u > CDF_{k−1}) and (k == N or not u > CDF_k)``,
instead of counting ``Σ_j 1{u > CDF_j}``; any other θ takes the count.
The two agree only because every pmf term is ≥ 0 there, so the float32
CDF, summed in j order as the kernel sums it, is nondecreasing.  Here
the kernel's rule is written in torch (the CDF from the port's
``cdf_table``, whose operations and order are the kernel's) and held to
the JAX count, hit for hit, on panels that include the uniforms next to
every CDF value.  The kernel's uniforms are multiples of 2^-23, never
subnormal, so the panels are too (XLA on the CPU compares subnormals as
zero).

The hits are held to JAX's exactly.  The log likelihood is held bit for
bit to the port's plain version and within one ulp of JAX's: XLA's
float32 log on the CPU differs from torch's by one ulp on some arguments
(67 of the 501 values ``log(h / 500)``), whatever the hits.  This test
restates the kernel's rule; what binds the CUDA loop itself (its CDF
summed only up to ``j = k``, its lanes) to the plain count is
``chip_smoke.py``'s ``phase_k1_zoo``, which holds K1 on this density bit
for bit against ``de_step_plain`` on the card, θ outside [0, 1] included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from demcmc_tpu.models import binomial as jbin

from demcmc_tpu_torch import rng as trng
from demcmc_tpu_torch.models import binomial as tbin
from demcmc_tpu_torch.utils import dists

torch.set_num_threads(1)


def kernel_hits(N, k, theta, noise):
    """Hits per chain by the kernel's rule: ``theta [C]``, ``noise
    [n_sim, C]`` float32 uniforms."""
    if k < 0 or k > N:
        return torch.zeros_like(theta, dtype=torch.int64)
    cdfs = tbin.cdf_table(N, theta)
    lo = cdfs[k - 1] if k > 0 else torch.full_like(theta, -np.inf)
    hi = cdfs[k] if k < N else torch.full_like(theta, np.inf)
    two = ((noise > lo) & ~(noise > hi)).sum(0)
    count = torch.zeros(noise.shape, dtype=torch.int32)
    for c in cdfs:
        count += noise > c
    inside = (theta >= 0.0) & (theta <= 1.0)
    return torch.where(inside, two, (count == k).sum(0))


def jax_hits(N, k, theta, noise):
    """Hits per chain of the JAX model's count, read back from its
    ``log(hits / n_sim)``."""
    with jax.enable_x64(False):
        lp = jbin.loglike_abc_batched({"N": N, "k": k},
                                      jnp.asarray(theta.numpy()),
                                      noise=jnp.asarray(noise.numpy()))
    lp = np.asarray(lp).astype(np.float64)
    return np.rint(np.exp(lp) * noise.shape[0]).astype(np.int64), lp


def panel(N, theta, n_sim, seed):
    """``[n_sim, C]`` uniforms of the kernel's bit map (multiples of
    2^-23 in [0, 1)) from numpy words, each chain's first rows the
    uniforms next to its own CDF values: the one at or below each and the
    ones a step either side."""
    g = np.random.default_rng(seed)
    words = g.integers(0, 2 ** 32, (n_sim, theta.shape[0]), dtype=np.uint64)
    u = trng.to_uni(torch.from_numpy(words.astype(np.uint32))).clone()
    cdf = torch.stack(tbin.cdf_table(N, theta)).numpy().astype(np.float64)
    at = np.floor(np.nan_to_num(cdf, nan=0.5) * 2.0 ** 23)
    edges = np.concatenate([at - 1, at, at + 1])
    edges = np.clip(edges, 0, 2 ** 23 - 1) / 2.0 ** 23         # [3N, C]
    u[:edges.shape[0]] = torch.from_numpy(edges.astype(np.float32))
    return u


def theta_grid():
    """0, 1 and their float32 neighbours (both signs of 0), and points in
    between."""
    f = np.float32
    pts = [f(0), f(-0.0), np.nextafter(f(0), f(1)), np.nextafter(f(0), f(-1)),
           f(1), np.nextafter(f(1), f(0)), np.nextafter(f(1), f(2)),
           f(0.5), f(0.6), f(1e-3), f(0.999), f(0.25), f(1e-30)]
    return torch.tensor(np.array(pts, np.float32))


@pytest.mark.parametrize("N", [1, 10, 64])
@pytest.mark.parametrize("kk", ["0", "N//2", "N"])
def test_two_threshold_rule_matches_the_jax_count(N, kk):
    k = {"0": 0, "N//2": N // 2, "N": N}[kk]
    theta = theta_grid()
    noise = panel(N, theta, 4 * N + 500, seed=N * 100 + k)
    hits = kernel_hits(N, k, theta, noise)
    want, lp_jax = jax_hits(N, k, theta, noise)
    np.testing.assert_array_equal(hits.numpy(), want)
    # the port's plain version (the count) gives the same log likelihood
    lp = tbin.loglike_abc_batched({"N": N, "k": k}, theta, noise=noise)
    lp_rule = torch.log(dists.div(hits.to(torch.float32),
                                  float(noise.shape[0])))
    assert torch.equal(lp_rule, lp)
    np.testing.assert_array_max_ulp(lp.numpy(), lp_jax.astype(np.float32),
                                    maxulp=1)


@settings(max_examples=60, deadline=None)
@given(theta=st.floats(0.0, 1.0, width=32),
       N=st.integers(1, 64), k_frac=st.floats(0.0, 1.0),
       seed=st.integers(0, 2 ** 32 - 1))
def test_two_threshold_rule_over_theta_in_unit_interval(theta, N, k_frac,
                                                        seed):
    k = int(round(k_frac * N))
    th = torch.tensor([theta, np.float32(1.0) - np.float32(theta)],
                      dtype=torch.float32)
    noise = panel(N, th, 3 * N + 200, seed)
    hits = kernel_hits(N, k, th, noise)
    want, _ = jax_hits(N, k, th, noise)
    np.testing.assert_array_equal(hits.numpy(), want)
    # the property the rule rests on: the float32 CDF is nondecreasing
    cdf = torch.stack(tbin.cdf_table(N, th))
    assert bool((cdf[1:] >= cdf[:-1]).all())
