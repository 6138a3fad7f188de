"""The Lotka–Volterra model of the port against the JAX package's (and
scipy), on the CPU.

Tolerances.  The solve: within 5e-5 of the JAX solve (500 float32 RK4
steps; XLA on the CPU contracts a·b + c into one fused multiply-add, which
torch does not, and the ulps it leaves grow along the orbit to ~1e-5 on
values up to 7) and within 5e-3 of scipy's float64 solution (the JAX
test's bound, ``tests/test_aux_utils.py:13-32``).  The log posterior:
within 1e-5 relative and 1e-4 absolute of the JAX per-cell density (202
residuals summed in another order, on the solves above).  The unfused
step fed the JAX pool: θ within 1e-6 + 1e-6·|θ| (``test_torch_unfused_
step.py``), w within the density's tolerance, the accept flags exactly
away from near-ties (|log u − Δ| > 0.05: a weight of order 10³ carries an
absolute error of order 10⁻³).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import demcmc_tpu as jdm
from demcmc_tpu.models import lotka_volterra as jlv
from demcmc_tpu.sampler import make_spec as jmake_spec

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch.models import lotka_volterra as tlv
from demcmc_tpu_torch.ops import accept as taccept
from demcmc_tpu_torch.utils import dists
from test_torch_unfused_step import _check, fed_pool, jax_run

W_TOL = (1e-5, 1e-4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test (many small torch operations)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_model():
    """The JAX model (its default data, key 0), x64 off, and its data."""
    with jax.enable_x64(False):
        jm, jde = jlv.make()
        return jm, jde, np.asarray(jm.data)


def _params(n, seed):
    """``n`` parameter vectors inside the priors' bounds, near the data's."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.normal(1.5, 0.2, n), rng.normal(1.0, 0.1, n),
                     rng.normal(3.0, 0.3, n), rng.normal(1.0, 0.1, n),
                     rng.uniform(0.3, 1.0, n)], 1).astype(np.float32)


def test_rk4_matches_jax_and_scipy():
    """The port's solve at the true rates against the JAX solve and
    scipy's; batched over chains, each column is that chain's solve."""
    from scipy.integrate import solve_ivp
    p = np.asarray(tlv.TRUE_P, np.float32)

    def f(t, u):
        x, y = u
        a, b, g, d = p.astype(np.float64)
        return [(a - b * y) * x, (d * x - g) * y]

    ref = solve_ivp(f, (0.0, 10.0), [1.0, 1.0], rtol=1e-10, atol=1e-10,
                    dense_output=True)
    truth = ref.sol(np.arange(0, 10.0 + 1e-9, 0.1)).T
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(jlv.solve)(jnp.asarray(p)))
    got = tlv.solve(torch.tensor(p)).numpy()
    assert got.shape == truth.shape == (101, 2)
    np.testing.assert_allclose(got, want, atol=5e-5)
    np.testing.assert_allclose(got, truth, atol=5e-3)
    ps = _params(5, 1)[:, :4]
    cols = tlv.solve(torch.tensor(ps.T))
    assert cols.shape == (101, 2, 5)
    for c in range(5):
        np.testing.assert_array_equal(cols[..., c].numpy(),
                                      tlv.solve(torch.tensor(ps[c])).numpy())


def test_inverse_gamma_logpdf():
    """InverseGamma(2, 3) against scipy and the JAX model's; ``-inf`` at
    x ≤ 0."""
    from scipy.stats import invgamma
    x = np.array([0.5, 1.0, 3.0, 7.5], np.float32)
    got = dists.inverse_gamma_logpdf(torch.tensor(x), 2.0, 3.0).numpy()
    np.testing.assert_allclose(got, invgamma.logpdf(x, 2.0, scale=3.0),
                               rtol=1e-5)
    with jax.enable_x64(False):
        want = np.asarray(jlv.inverse_gamma_logpdf(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    edge = dists.inverse_gamma_logpdf(torch.tensor([-1.0, 0.0]))
    assert torch.isneginf(edge).all()


def test_truncated_normal_prior_and_draws():
    """The truncated-normal log density against scipy's, ``-inf`` outside
    its bounds; the inverse-CDF draws inside the bounds with scipy's
    moments, and the Gamma(2, 1) draws with mean and variance 2 (200,000
    draws: standard errors near 1e-3 and 0.01)."""
    from scipy.stats import truncnorm
    mu, sd, lo, hi = tlv.PRIORS[1]
    law = truncnorm((lo - mu) / sd, (hi - mu) / sd, loc=mu, scale=sd)
    x = np.linspace(-0.5, 2.5, 61).astype(np.float32)
    got = dists.truncated_normal_logpdf(torch.tensor(x), mu, sd, lo,
                                        hi).numpy()
    inside = (x >= lo) & (x <= hi)
    np.testing.assert_allclose(got[inside], law.logpdf(x[inside]),
                               rtol=1e-5, atol=1e-5)
    assert np.isneginf(got[~inside]).all()
    u = torch.rand(200_000, generator=torch.Generator().manual_seed(0))
    draws = dists.sample_truncated_normal(u, mu, sd, lo, hi).numpy()
    assert lo <= draws.min() and draws.max() <= hi
    assert abs(draws.mean() - law.mean()) < 5e-3
    assert abs(draws.std() - law.std()) < 5e-3
    u2 = torch.rand(200_000, generator=torch.Generator().manual_seed(1))
    g = dists.sample_gamma2(u, u2).numpy()
    assert abs(g.mean() - 2.0) < 0.02 and abs(g.var() - 2.0) < 0.05


def test_density_matches_jax(jax_model):
    """The chains-last log posterior on the JAX model's data (carried
    across with ``make(data=)``) against the JAX per-cell density, out of
    bounds included."""
    jm, jde, data = jax_model
    theta = _params(48, 2)
    theta[:3, 4] = -0.1                   # σ out of bounds
    theta[3, 0] = 2.6                     # α out of bounds
    with jax.enable_x64(False):
        spec = jmake_spec(jm, jde)
        want = np.asarray(jax.jit(jax.vmap(lambda t: jdm.compute_posterior(
            jm, spec, jde, t)))(jnp.asarray(theta)))
    model, de = tlv.make(data=data)
    np.testing.assert_array_equal(model.data, data)
    got = tdm.compute_posterior(model, tdm.make_spec(model, de), de,
                                torch.tensor(theta)).numpy()
    fin = np.isfinite(want)
    assert (~fin).sum() == 4
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=W_TOL[0],
                               atol=W_TOL[1])


def test_unfused_step_matches_jax_xla_step(jax_model):
    """Four iterations (G = 4, Np = 8, across burn-in, α = 0.1) of the
    port's unfused step fed the JAX pool and scalars against the JAX XLA
    step on the same data: θ, w and the accept flags after each."""
    _, _, data = jax_model
    G, Np, key = 4, 8, 41
    kw = dict(Np=Np, n_groups=G, burnin=2, alpha=0.1)
    with jax.enable_x64(False):
        jm, jde = jlv.make(data=jnp.asarray(data), **kw)
    model, de = tlv.make(data=data, **kw)
    C = G * Np
    theta0 = _params(C, key)
    spec = tdm.make_spec(model, de)
    w0 = taccept.make_fitness(model, spec, de)(torch.tensor(theta0)).numpy()
    n_words, pools, scalars, outs = jax_run(jm, jde, theta0, w0, key, 1, 4)
    margins = []
    orig = taccept.mh_update

    def rec(draws, w_cur, w_prop, log_adj):
        off = draws.offset
        acc = orig(draws, w_cur, w_prop, log_adj)
        u = torch.clamp_min(tdm.rng._uniform24(draws.bits[:, off:
                                                          draws.offset]),
                            tdm.rng.TINY).reshape(w_cur.shape)
        margins.append(torch.log(u) - ((w_prop - w_cur) + log_adj))
        return acc

    step = tdm.build_step(model, de, spec, device="cpu")
    assert isinstance(step, tdm.UnfusedStep) and step.pool_words == n_words
    step.update = rec
    th = torch.tensor(theta0).view(G, Np, -1)
    w = torch.tensor(w0).view(G, Np)
    accepted = 0
    for k in range(4):
        draws = fed_pool(pools[k], scalars[k])
        th, w, acc = step.step_core(draws, th, w, 1 + k, step.fitness)
        _check(th.reshape(C, -1).numpy(), w.reshape(C).numpy(),
               acc.reshape(C).numpy(), outs[k], W_TOL)
        accepted += int(acc.sum())
    assert all((m.abs() > 0.05).all() for m in margins), "near-tie"
    assert 0 < accepted < 4 * C


def test_default_data_and_sample_on_cpu():
    """Without data, the solve at the true rates plus 0.5 times standard
    normals from numpy seed 0; ``sample()`` at the reference example's
    width (Np = 12, 3 groups) runs through the unfused step on the CPU,
    every draw finite and in bounds."""
    model, de = tlv.make(burnin=10)
    truth = tlv.solve(torch.tensor(tlv.TRUE_P, dtype=torch.float32))
    resid = model.data - truth.numpy()
    assert model.data.shape == (101, 2) and abs(resid.std() - 0.5) < 0.05
    assert (de.Np, de.n_groups) == (12, 3) and model.cuda_density is None
    chains = tdm.sample(model, de, 20, key=1, device="cpu")
    assert chains.data.shape == (10, 5, 36)
    assert np.isfinite(chains.data).all() and np.isfinite(chains.lp).all()
    lo = np.array([b[0] for b in tlv.BOUNDS])[:, None]
    hi = np.array([b[1] for b in tlv.BOUNDS])[:, None]
    assert ((chains.data >= lo) & (chains.data <= hi)).all()
    assert chains.acceptance.mean() > 0
