"""DE optimization in the port (``demcmc_tpu_torch.optimize``) on the CPU:
the cases of ``tests/test_optimization.py`` (the reference's
``test/optimization_tests.jl``) through the port, with run lengths from
the JAX CPU run (the JAX package meets both gates by 1,000 Rastrigin
iterations and by 500 MLE iterations at these keys, and is unchanged
after: its population has collapsed on the optimum); the float32 path
through K1's greedy plain version, with no trajectory; and the faults
the optimization slice repaired: the initial weights scored by the
fitness slot (F1), a model with no prior (F2).  The float64 state's
carry-over (F3) is in ``test_torch_float64.py``.
"""

import math

import numpy as np
import pytest
import torch

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch import sampler
from demcmc_tpu_torch.models import discrete_binomial as tdisc
from demcmc_tpu_torch.models import gaussian as tgauss
from demcmc_tpu_torch.models import rastrigin
from demcmc_tpu_torch.ops import accept as taccept
from demcmc_tpu_torch.ops import fused_step as tfused

DATA = np.random.default_rng(0).standard_normal(50).astype(np.float32)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test (many small torch operations)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mle_model(data):
    """The reference's Gaussian MLE model (``tests/test_optimization.py``)
    with a per-cell float64 loglike in ``jax.scipy.stats.norm.logpdf``'s
    order."""
    def loglike(data, mu, sigma):
        x = torch.as_tensor(data, dtype=mu.dtype)
        s2 = sigma * sigma
        return torch.sum((torch.log(2.0 * math.pi * s2)
                          + (x - mu) * (x - mu) / s2) / -2.0)

    def sample_prior(uniform, n):
        u = uniform(2)
        return [-5.0 + 10.0 * u[0], 0.1 + 4.9 * u[1]]

    return tdm.DEModel(loglike=loglike, sample_prior=sample_prior,
                       names=("mu", "sigma"), data=data)


def test_rastrigin_minimum():
    """The 2-d Rastrigin in float64 (``examples/optimize.py``): Np = 10 ×
    4 groups, key 0, 1,000 iterations through the unfused step; the
    optimum within 1e-8 of 0 at x within 1e-5 of 0."""
    model, de = rastrigin.make(n_dim=2, Np=10, n_groups=4)
    assert isinstance(tdm.build_step(model, de, tdm.make_spec(model, de),
                                     "cpu"), tdm.UnfusedStep)
    pop = tdm.optimize(model, de, 1000, key=0, device="cpu")
    theta, best = tdm.get_optimal(de, model, pop)
    assert pop.theta.dtype == np.float64
    assert best == pytest.approx(0.0, abs=1e-8)
    np.testing.assert_allclose(theta["x"], np.zeros(2), atol=1e-5)


def test_gaussian_mle():
    """The Gaussian MLE in float64: 100 draws of N(2, 1.5) from numpy
    seed 3, Np = 12 × 4, key 1, 500 iterations, ``MCMCThreads()``
    accepted; μ̂ and σ̂ (ddof = 0) within 1e-4 of the closed form."""
    data = np.random.default_rng(3).normal(2.0, 1.5, size=100)
    de = tdm.DE(bounds=((-np.inf, np.inf), (1e-6, np.inf)), Np=12,
                n_groups=4, update_particle="maximize",
                evaluate_fitness="fun", dtype=np.float64)
    model = _mle_model(data)
    pop = tdm.optimize(model, de, tdm.MCMCThreads(), 500, key=1,
                       device="cpu")
    theta, best = tdm.get_optimal(de, model, pop)
    assert theta["mu"] == pytest.approx(data.mean(), abs=1e-4)
    assert theta["sigma"] == pytest.approx(data.std(), abs=1e-4)
    assert best == pytest.approx(float(pop.weight.max()))


def test_optimize_rejects_mh_config():
    """An MH configuration, and minimizing the posterior, raise
    ``ValueError`` (``demcmc_tpu/optimize.py:86-98``); ``progress=True``,
    which raised until the chunked run was ported, runs and returns the
    same population."""
    model, de = rastrigin.make()
    with pytest.raises(ValueError, match="maximize"):
        tdm.optimize(model, de.replace(update_particle="mh",
                                       evaluate_fitness="posterior"), 10,
                     device="cpu")
    with pytest.raises(ValueError, match="ill-posed"):
        tdm.optimize(model, de.replace(evaluate_fitness="posterior"), 10,
                     device="cpu")
    quiet = tdm.optimize(model, de, 10, device="cpu")
    shown = tdm.optimize(model, de, 10, device="cpu", progress=True)
    np.testing.assert_array_equal(quiet.theta, shown.theta)


def test_get_optimal_direction_minimize():
    model, de = rastrigin.make(n_dim=2, Np=6, n_groups=2)
    pop = tdm.optimize(model, de, 200, key=0, device="cpu")
    _, best = tdm.get_optimal(de, model, pop)
    assert best == pop.weight.min()
    up = de.replace(update_particle="maximize")
    _, top = tdm.get_optimal(up, model, pop)
    assert top == pop.weight.max()


def test_population_shapes():
    """``Population`` holds ``theta [C, d]`` and ``weight [C]``; its
    ``particles`` are the port's ``Particle`` objects, ids from 1."""
    model, de = rastrigin.make(n_dim=3, Np=5, n_groups=2)
    pop = tdm.optimize(model, de, 100, key=0, device="cpu")
    assert pop.theta.shape == (10, 3)
    assert pop.weight.shape == (10,)
    parts = pop.particles
    assert len(parts) == 10 and isinstance(parts[0], tdm.Particle)
    assert parts[3].id == 4 and parts[3].weight == float(pop.weight[3])
    np.testing.assert_array_equal(parts[3].theta[0], pop.theta[3])


@pytest.mark.parametrize("case", ["min-rastrigin", "max-mle"])
def test_float32_optimize_takes_k1_without_a_trajectory(monkeypatch, case):
    """A float32 greedy configuration of a model with a greedy CUDA
    objective takes the kernels' step (here K1's plain version, in the
    configuration's accept mode), as planned windows that store no row;
    its final population equals the one-launch-per-iteration loop's bit
    for bit.  The 2-d Rastrigin (32 × 16 chains, 400 iterations across
    burn-in 200) reaches 0 within a few ulp of A·n = 20; the bench
    Gaussian's MLE (8 × 16, 400 iterations) the closed form within the
    float32 objective's resolution, about 5e-4."""
    if case == "min-rastrigin":
        model, de = rastrigin.make(n_dim=2, Np=16, n_groups=32,
                                   dtype=np.float32, burnin=200)
    else:
        model, de = tgauss.make(data=DATA, Np=16, n_groups=8, burnin=200,
                                update_particle="maximize",
                                evaluate_fitness="fun")
    spec = tdm.make_spec(model, de)
    step = tdm.build_step(model, de, spec, "cpu")
    assert type(step) is sampler.Step and step.cfg.mode == case[:3]
    outs = []
    orig = tfused.de_step

    def rec(cfg, *a, out=None, K=1, emit=(0, 1), **kw):
        outs.append((out, tfused.n_emitted(K, emit)))
        return orig(cfg, *a, out=out, K=K, emit=emit, **kw)
    monkeypatch.setattr(tfused, "de_step", rec)
    pop = tdm.optimize(model, de, 400, key=3, device="cpu")
    assert outs and all(o is None and n == 0 for o, n in outs)
    state = sampler._grow_history(tdm.init_state(
        model, de, spec, 3, device="cpu", start_iteration=1), 400)
    loop, ys = sampler.run_loop(step, state, 400, collect=False)
    assert ys is None
    assert torch.equal(loop.theta, torch.from_numpy(pop.theta))
    assert torch.equal(loop.weight, torch.from_numpy(pop.weight))
    theta, best = tdm.get_optimal(de, model, pop)
    if case == "min-rastrigin":
        assert 0.0 <= best <= 4 * np.spacing(np.float32(20.0))
        np.testing.assert_allclose(theta["x"], 0.0, atol=1e-3)
    else:
        x = DATA.astype(np.float64)
        assert theta["mu"] == pytest.approx(x.mean(), abs=5e-4)
        assert theta["sigma"] == pytest.approx(x.std(), abs=5e-4)


def test_init_state_scores_with_the_fitness_slot():
    """F1: ``init_state`` scores the initial population with the
    configuration's fitness slot, as the JAX ``init_state`` does
    (``demcmc_tpu/sampler.py:1159-1165``): the objective alone when
    optimizing (it scored the posterior), the posterior when sampling."""
    model, de = tgauss.make(data=DATA, Np=6, n_groups=4)
    opt = de.replace(update_particle="maximize", evaluate_fitness="fun")
    spec = tdm.make_spec(model, de)
    s_opt = tdm.init_state(model, opt, spec, 7, device="cpu")
    s_mh = tdm.init_state(model, de, spec, 7, device="cpu")
    assert torch.equal(s_opt.theta, s_mh.theta)
    assert torch.equal(s_opt.weight, taccept.evaluate_fun(
        model, spec, opt, s_opt.theta))
    assert torch.equal(s_mh.weight, taccept.compute_posterior(
        model, spec, de, s_mh.theta))
    assert not torch.equal(s_opt.weight, s_mh.weight)


def test_model_without_prior():
    """F2: a ``DEModel`` may have no prior (an optimization-only model, as
    the JAX ``DEModel`` allows): it optimizes with the objective, and a
    posterior of it raises a clear error instead of running."""
    model, de = rastrigin.make(n_dim=2, Np=6, n_groups=2)
    assert model.prior_loglike is model.prior_loglike_batched is None
    spec = tdm.make_spec(model, de)
    x = torch.zeros(2, 1, dtype=torch.float64)
    assert float(model.log_like_cols(spec, x)[0]) == 0.0
    with pytest.raises(ValueError, match="no prior"):
        model.log_posterior_cols(spec, x)
    with pytest.raises(ValueError, match="no prior"):
        tdm.sample(model, de.replace(update_particle="mh",
                                     evaluate_fitness="posterior"), 4,
                   device="cpu")
    pop = tdm.optimize(model, de, 20, device="cpu")
    assert np.isfinite(pop.weight).all()


def test_demcmc_and_mh_only_densities_optimize_on_the_unfused_step():
    """DE-MCz optimization takes the unfused step (the JAX kernel fuses no
    greedy DE-MCz, ``fused_step.py:287-288``) and starts at iteration
    n_initial + 1; a density whose K1 is built for MH only (the discrete
    binomial) and a float64 configuration of a greedy one take it too;
    the kernels' step refuses a greedy DE-MCz configuration."""
    model, de = tgauss.make(data=DATA, Np=6, n_groups=4,
                            update_particle="maximize",
                            evaluate_fitness="fun", sample="resample",
                            n_initial=10)
    spec = tdm.make_spec(model, de)
    assert isinstance(tdm.build_step(model, de, spec, "cpu"),
                      tdm.UnfusedStep)
    with pytest.raises(ValueError, match="unfused"):
        sampler.Step(model, de, spec, "cpu")
    pop = tdm.optimize(model, de, 12, key=2, device="cpu")
    assert pop.theta.shape == (24, 2) and np.isfinite(pop.weight).all()
    disc, disc_de = tdisc.make(dtype=np.float32, update_particle="maximize",
                               evaluate_fitness="fun")
    assert not sampler.fused_supported(disc, disc_de)
    r64, de64 = rastrigin.make()
    assert not sampler.fused_supported(r64, de64)
    assert sampler.fused_supported(r64, de64.replace(dtype=np.float32))
