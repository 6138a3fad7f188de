"""The models that only the unfused step runs — ``abc_kde`` (fixed
panel), ``lnr`` (per-cell, through ``torch.func.vmap``) and the exact
binomial — against the JAX package's models on the same numpy inputs
(data and panel carried across), with x64 off on the JAX side; and short
CPU runs of ``sample()`` through the unfused step.

Tolerances: the log posterior within 1e-5 relative and 1e-4 absolute
(float32 sums of 50 to 400 terms in XLA's order against torch's; LNR's
erf and erfc, and XLA's fused multiply-adds, differ by an ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import demcmc_tpu as jdm
from demcmc_tpu.models import abc_kde as jabc
from demcmc_tpu.models import binomial as jbin
from demcmc_tpu.models import lnr as jlnr
from demcmc_tpu.sampler import make_spec as jmake_spec

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch.models import abc_kde as tabc
from demcmc_tpu_torch.models import binomial as tbin
from demcmc_tpu_torch.models import lnr as tlnr
from demcmc_tpu_torch.ops import accept as taccept
from demcmc_tpu_torch.ops import kde as tkde_ops

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU path runs many small torch operations, which thread
    pools only slow down (most where the test runner's other workers hold
    the cores); one intra-op thread per test, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_posterior(jm, jde, theta):
    """The JAX fitness (``compute_posterior`` per cell) of ``theta
    [n, d]``, x64 off."""
    with jax.enable_x64(False):
        spec = jmake_spec(jm, jde)
        f = jax.vmap(lambda x: jdm.compute_posterior(jm, spec, jde, x))
        return np.asarray(f(jnp.asarray(theta)))


def _port_posterior(model, de, theta):
    spec = tdm.make_spec(model, de)
    return taccept.compute_posterior(model, spec, de,
                                     torch.tensor(theta)).numpy()


def _agree(got, want):
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def test_abc_kde_density_matches_jax():
    """The fixed-panel synthetic likelihood with the JAX model's data and
    panel (``make(key=3, n_sim=1537)``) carried across: the port's batched
    density through the plain version of K4 against the JAX per-cell one,
    out of bounds (σ ≤ 0) included."""
    with jax.enable_x64(False):
        jm, jde = jabc.make(key=3, n_sim=1537, use_pallas=False)
        noise = np.asarray(jax.random.normal(jax.random.PRNGKey(7),
                                             (1537,)))
        data = np.asarray(jm.data)
    model, de = tabc.make(data=data, noise=noise)
    rng = np.random.default_rng(1)
    theta = np.stack([rng.normal(0.0, 0.4, 24), rng.uniform(-0.1, 2.0, 24)],
                     1).astype(np.float32)
    before = tkde_ops.kde_logpdf.launches
    _agree(_port_posterior(model, de, theta), _jax_posterior(jm, jde, theta))
    assert tkde_ops.kde_logpdf.launches == before        # CPU: plain


def test_abc_kde_default_data_from_numpy_seeds():
    model, _ = tabc.make(key=3, n_obs=20, n_sim=300, sim_key=4)
    np.testing.assert_array_equal(
        model.data, np.random.default_rng(3).standard_normal(20)
        .astype(np.float32))
    assert model.cuda_density is None and model.loglike is None


@pytest.mark.parametrize("seed", [0, 1])
def test_lnr_per_cell_density_matches_jax(seed):
    """LNR with the JAX model's simulated data carried across: the per-cell
    density batched by ``vmap`` against the JAX per-cell density, points
    past the shortest rt (−inf) included."""
    with jax.enable_x64(False):
        jm, jde = jlnr.make(key=seed, n_trials=100)
        choice, rt = (np.asarray(a) for a in jm.data)
    model, de = tlnr.make(data=(choice, rt))
    assert model.loglike_batched is None and model.loglike is not None
    rng = np.random.default_rng(seed)
    C = 32
    tau = rng.uniform(0.0, 1.2 * rt.min(), C)
    theta = np.column_stack([rng.normal(-2.5, 0.8, (C, 4)), tau]).astype(
        np.float32)
    _agree(_port_posterior(model, de, theta), _jax_posterior(jm, jde, theta))


def test_lnr_vmapped_density_equals_a_loop():
    """``vmap`` over the per-cell density gives what a loop of per-cell
    calls gives, bit for bit."""
    model, de = tlnr.make(key=2, n_trials=40)
    spec = tdm.make_spec(model, de)
    x = torch.tensor(np.random.default_rng(2).normal(
        [-2, -2, -3, -3, 0.1], 0.3, (6, 5)).astype(np.float32))
    batched = model.log_posterior_cols(spec, x.T)
    loop = torch.stack([model.log_prior_flat(spec, v)
                        + model.log_like_flat(spec, v) for v in x])
    assert torch.equal(batched, loop)


def test_lnr_simulated_data():
    choice, rt = tlnr.simulate(np.random.default_rng(0), 500, **tlnr.TRUE)
    assert choice.dtype == np.int64 and rt.dtype == np.float32
    assert set(np.unique(choice)) == {0, 1, 2, 3}
    assert (rt > 0.5).all()
    # the ν = −3 accumulators finish first more often
    assert np.bincount(choice)[2:].sum() > np.bincount(choice)[:2].sum()


def test_exact_binomial_density_matches_jax():
    jm, jde = jbin.make(N=10, k=6)
    model, de = tbin.make(N=10, k=6)
    assert model.cuda_density is None and not model.stochastic
    theta = np.linspace(-0.05, 1.05, 23, dtype=np.float32)[:, None]
    _agree(_port_posterior(model, de, theta), _jax_posterior(jm, jde, theta))
    edge = _port_posterior(model, de, np.array([[0.0], [1.0]], np.float32))
    assert np.isneginf(edge).all()                        # k = 6 of 10


def test_exact_binomial_sample_matches_conjugate():
    """A short CPU ``sample()`` of the exact binomial (N = 10, k = 6; 32
    groups of 8, 400 iterations, burn-in 100) through the unfused step:
    θ's mean and sd within 0.03 of Beta(7, 5)."""
    model, de = tbin.make(N=10, k=6, Np=8, n_groups=32, burnin=100)
    step = tdm.build_step(model, de, tdm.make_spec(model, de), device="cpu")
    assert isinstance(step, tdm.UnfusedStep)
    ch = tdm.sample(model, de, 400, key=1, device="cpu")
    truth = tbin.conjugate_posterior(10, 6)
    assert abs(ch.mean("theta") - truth["mean"]) < 0.03
    assert abs(ch.std("theta") - truth["std"]) < 0.03


def test_unfused_models_sample_on_cpu():
    """``sample()`` of LNR and ``abc_kde`` through the unfused step on the
    CPU (small populations, short runs): finite draws of the right shape,
    every τ below the shortest rt."""
    model, de = tlnr.make(key=0, n_trials=50, n_groups=2, burnin=10)
    ch = tdm.sample(model, de, 20, key=3, device="cpu")
    assert ch.data.shape == (10, 5, 48) and np.isfinite(ch.data).all()
    assert (ch.group("tau") < model.data[1].min()).all()
    model, de = tabc.make(n_sim=200, n_groups=2, burnin=10)
    ch = tdm.sample(model, de, 20, key=3, device="cpu")
    assert ch.data.shape == (10, 2, 12) and np.isfinite(ch.data).all()
