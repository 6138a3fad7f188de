"""Stochastic models in the port's unfused step, and the fixed-noise ABC
binomial, against the JAX package on the CPU.

* The fixed-noise ABC binomial (``abc=True, fresh_noise=False``) on the
  JAX model's own panel, ``jax.random.uniform(PRNGKey(123), (n_sim, N))``
  (its ``bernoulli`` is that uniform < θ), carried across: the hit counts
  equal to the JAX model's exactly, the hit fraction bit for bit (XLA
  lowers ``jnp.mean`` to a product with 1 / n_sim, as the port takes it)
  and its log within one float32 ulp (XLA's CPU ``log`` and torch's part
  by an ulp on a seventh of the fractions); four iterations of the port's
  unfused step fed the JAX pool against the JAX XLA step, the weights
  within 2.4e-7 relative (one ulp) and 5e-7 absolute (the JAX model's
  Beta(1, 1) prior is XLA's float32 ``betaln``, −4.77e-7; the port's, as
  the JAX fused kernel's, is 0), θ as ``test_torch_unfused_step.py``
  states it, the accept flags exactly.
* The fresh-noise abc_kde density on a panel of uniforms equals the
  fixed-panel density on the panel's normals Φ⁻¹(u + 2⁻²⁴), bit for bit,
  and the JAX fixed-panel density on them within 1e-5 relative and 1e-4
  absolute (``test_torch_unfused_models.py``'s tolerance).
* The JAX package's ``tests/test_pseudo_marginal.py``, ported (the port's
  per-evaluation key is the evaluation's ``EVAL_NS`` panel): a stochastic
  fitness reproducible for one panel, different across iterations,
  blocks, members and cells; the fixed-noise models deterministic; the
  fresh-noise binomial and abc_kde near their targets at n_sim = 1,000
  with the JAX tests' bounds, in half their iterations (the binomial 450
  with burn-in 150, against 900 and 300, and n_sim = 10,000 there: a
  pseudo-marginal chain targets the exact posterior at any n_sim, fewer
  simulations only mix slower; abc_kde 400 with burn-in 150, against
  1,200 and 400).  Each bound stays over ten Monte Carlo standard errors
  of the kept draws (the binomial's mean 0.1 against a posterior sd of
  0.137 over 300 draws of 16 chains; abc_kde's 0.2 and 0.25 against
  posterior sds near 0.15 and 0.1 over 250 draws of 24 chains).
* The port's contracts: the panel of an evaluation is ``rng.words``'
  uniforms of ``EVAL_NS`` at its rows and the population's chains; a
  fresh-noise run is bit for bit the same on 2 CPU shards.
"""

import jax
import numpy as np
import pytest
import torch

import demcmc_tpu as jdm
from demcmc_tpu.models import abc_kde as jabc
from demcmc_tpu.models import binomial as jbin
from demcmc_tpu.sampler import make_spec as jmake_spec
from demcmc_tpu.utils.kde import epanechnikov_logpdf

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch import rng as trng
from demcmc_tpu_torch.models import abc_kde as tabc
from demcmc_tpu_torch.models import binomial as tbin
from demcmc_tpu_torch.ops import accept as taccept
from demcmc_tpu_torch.ops import fused_step as tfused
from demcmc_tpu_torch.ops import kde as tkde_ops
from test_torch_unfused_step import (_check, fed_pool, jax_run,
                                     margins)  # noqa: F401


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test (many small torch operations)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, K_OBS, N_SIM = 10, 6, 1000


@pytest.fixture(scope="module")
def jax_panel():
    """The JAX fixed-noise ABC binomial's panel (x64 off)."""
    with jax.enable_x64(False):
        return np.asarray(jax.random.uniform(jax.random.PRNGKey(123),
                                             (N_SIM, N)))


def test_fixed_abc_density_equals_jax(jax_panel):
    """The fixed-panel ABC likelihood of the port on the JAX panel at θ
    across [0, 1]: its hit counts are the JAX model's, its hit fraction
    the JAX fraction bit for bit, its log (the JAX model's loglike)
    within one ulp."""
    theta = np.concatenate([np.linspace(0.0, 1.0, 101),
                            np.random.default_rng(0).uniform(0, 1, 155)])
    theta = theta.astype(np.float32)
    with jax.enable_x64(False):
        jm, jde = jbin.make(N=N, k=K_OBS, abc=True, n_sim=N_SIM)
        want = np.asarray(jax.vmap(lambda t: jm.loglike(jm.data, t))(
            theta))

        def jax_hits(t):
            sims = jax.random.bernoulli(jax.random.PRNGKey(123), t,
                                        (N_SIM, N))
            return jax.numpy.sum(sims.sum(1) == K_OBS)
        hits = np.asarray(jax.vmap(jax_hits)(theta))
        frac = np.asarray(jax.jit(jax.vmap(lambda h: jax.numpy.mean(
            jax.numpy.arange(N_SIM) < h, dtype=jax.numpy.float32)))(hits))
    model, de = tbin.make(N=N, k=K_OBS, abc=True, n_sim=N_SIM,
                          panel=jax_panel)
    assert not model.stochastic and model.cuda_density is None
    t = torch.tensor(theta)
    got_hits = tbin.abc_hits(torch.tensor(jax_panel), N, K_OBS, t)
    np.testing.assert_array_equal(got_hits.numpy(), hits)
    np.testing.assert_array_equal(
        tbin.abc_fraction(torch.tensor(jax_panel), N, K_OBS, t).numpy(),
        frac)
    got = model.log_like_cols(tdm.make_spec(model, de), t[None]).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_max_ulp(got[fin], want[fin], maxulp=1)
    assert fin.sum() > 100


def test_fixed_abc_step_matches_jax_xla_step(margins, jax_panel):
    """Four iterations (G = 4, Np = 8, across burn-in, α = 0.1) of the
    port's unfused step on the JAX panel, fed the JAX pool and scalars,
    against the JAX XLA step: the weights within one ulp and the JAX
    prior's offset."""
    G, Np, key = 4, 8, 36
    kw = dict(N=N, k=K_OBS, abc=True, n_sim=N_SIM, Np=Np, n_groups=G,
              burnin=2, alpha=0.1)
    jm, jde = jbin.make(**kw)
    model, de = tbin.make(panel=jax_panel, **kw)
    C = G * Np
    theta0 = np.random.default_rng(key).uniform(0.3, 0.8, (C, 1)).astype(
        np.float32)
    spec = tdm.make_spec(model, de)
    w0 = taccept.make_fitness(model, spec, de)(torch.tensor(theta0)).numpy()
    n_words, pools, scalars, outs = jax_run(jm, jde, theta0, w0, key, 1, 4)
    step = tdm.build_step(model, de, spec, device="cpu")
    assert isinstance(step, tdm.UnfusedStep) and step.pool_words == n_words
    th = torch.tensor(theta0).view(G, Np, -1)
    w = torch.tensor(w0).view(G, Np)
    for k in range(4):
        draws = fed_pool(pools[k], scalars[k])
        th, w, acc = step.step_core(draws, th, w, 1 + k, step.fitness)
        _check(th.reshape(C, -1).numpy(), w.reshape(C).numpy(),
               acc.reshape(C).numpy(), outs[k], (2.4e-7, 5e-7))
    assert all((m.abs() > 1e-3).all() for m in margins), "near-tie"


def test_fresh_kde_density_is_the_fixed_density_on_its_normals():
    """The fresh-noise abc_kde density on a panel of uniforms shared by
    every chain equals the fixed-panel density on Φ⁻¹(u + 2⁻²⁴) bit for
    bit, and the JAX fixed-panel density within tolerance."""
    n_sim, C = 1537, 24
    u = trng.to_uni(trng.words(5, 1, n_sim, 1, ns=trng.EVAL_NS))[:, 0]
    z = torch.special.ndtri(u + 2.0 ** -24)
    assert torch.isfinite(z).all()
    data = np.random.default_rng(3).standard_normal(50).astype(np.float32)
    fresh, de = tabc.make(data=data, n_sim=n_sim, fresh_noise=True)
    fixed, _ = tabc.make(data=data, noise=z.numpy())
    assert fresh.stochastic and fresh.noise_shape == (n_sim,)
    rng = np.random.default_rng(1)
    theta = np.stack([rng.normal(0.0, 0.4, C), rng.uniform(-0.1, 2.0, C)],
                     1).astype(np.float32)
    spec = tdm.make_spec(fresh, de)
    x = torch.tensor(theta)
    got = taccept.compute_posterior(fresh, spec, de, x,
                                    u[:, None].expand(n_sim, C)).numpy()
    np.testing.assert_array_equal(
        got, taccept.compute_posterior(fixed, spec, de, x).numpy())
    with jax.enable_x64(False):
        jm, jde = jabc.make(data=data, n_sim=n_sim, use_pallas=False)
        jm = jdm.DEModel(loglike=lambda d, mu, sigma: jax.numpy.sum(
            epanechnikov_logpdf(d, mu + sigma * z.numpy())),
            prior_loglike=jm.prior_loglike, sample_prior=jm.sample_prior,
            names=jm.names, data=jm.data)
        jspec = jmake_spec(jm, jde)
        want = np.asarray(jax.vmap(lambda t: jdm.compute_posterior(
            jm, jspec, jde, t))(theta))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-4)


def test_custom_fitness_on_fresh_kde_folds_into_one_kde_call(monkeypatch):
    """A custom ``evaluate_fitness`` on the fresh-noise abc_kde model runs
    per cell under ``torch.func.vmap`` with the cell's panel: the tempered
    slot equals half the built-in fitness on the same panel bit for bit,
    and the cells' densities take one call of K4's plain version (one K4
    launch on the card), not one per cell."""
    calls = []
    plain = tkde_ops.kde_logpdf_plain

    def counted(x, sims, h, floor):
        calls.append(tuple(sims.shape))
        return plain(x, sims, h, floor)

    monkeypatch.setattr(tkde_ops, "kde_logpdf_plain", counted)
    n_sim, G, Np = 300, 2, 4
    model, de = tabc.make(n_sim=n_sim, Np=Np, n_groups=G, fresh_noise=True)

    def tempered(model, spec, de, x, noise):
        return 0.5 * taccept.compute_posterior(model, spec, de, x, noise)

    spec = tdm.make_spec(model, de)
    rng = np.random.default_rng(2)
    x = torch.tensor(np.stack([rng.normal(0.0, 0.4, (G, Np)),
                               rng.uniform(0.5, 1.5, (G, Np))], -1),
                     dtype=torch.float32)
    noise = trng.to_uni(trng.words(5, 1, n_sim, G * Np, ns=trng.EVAL_NS))
    want = 0.5 * taccept.make_fitness(model, spec, de)(x, noise)
    calls.clear()
    got = taccept.make_fitness(model, spec, de.replace(
        evaluate_fitness=tempered))(x, noise)
    assert calls == [(G * Np, n_sim)]
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---- the JAX package's tests/test_pseudo_marginal.py

def _fresh_binomial(**kw):
    return tbin.make(N=N, k=K_OBS, abc=True, fresh_noise=True, **kw)


def test_stochastic_fitness_varies_with_panel_and_is_reproducible():
    """The step's panel is a pure function of (seed, iteration, block,
    member, chain): the same evaluation twice gives the same weights; the
    iteration, the block and the member each change them; equal θ in
    every cell scores differently across cells."""
    model, de = _fresh_binomial(n_sim=400, Np=4, n_groups=2)
    assert model.stochastic
    step = tdm.build_step(model, de, tdm.make_spec(model, de), "cpu",
                          allow_fused=False)
    theta = torch.full((2, 4, 1), 0.55)

    def w(it, block=None, member=None, seed=0):
        return step.fitness(theta, step._panel(None, seed, it, block,
                                               member)).numpy()

    np.testing.assert_array_equal(w(1), w(1))
    for other in (w(2), w(1, block=0), w(1, member=0), w(1, seed=1)):
        assert np.any(other != w(1))
    assert np.unique(w(1)).size > 1
    rows = {trng.eval_row(b, m, 4, 400) for b in (None, 0, 1, 2)
            for m in (None, 0, 1, 2, 3)}
    assert len(rows) == 20 and all(r % 400 == 0 for r in rows)


def test_fixed_noise_models_not_stochastic():
    model, _ = tbin.make(N=N, k=K_OBS, abc=True, fresh_noise=False,
                         n_sim=100)
    assert not model.stochastic
    model2, _ = tabc.make(fresh_noise=False, n_sim=100)
    assert not model2.stochastic


def test_binomial_abc_fresh_noise_recovers_posterior():
    """The fresh-noise ABC binomial through the unfused step (sequential
    sweep at Np = 4: a panel per member) near Beta(7, 5)."""
    model, de = _fresh_binomial(n_sim=1000, Np=4, burnin=150)
    chains = tdm.sample(model, de, 450, key=5, device="cpu",
                        allow_fused=False)
    truth = tbin.conjugate_posterior(N, K_OBS)
    assert abs(chains["theta"].mean() - truth["mean"]) < 0.1
    assert abs(chains["theta"].std() - truth["std"]) < 0.07


def test_abc_kde_fresh_noise_recovers_location():
    model, de = tabc.make(key=3, n_obs=50, n_sim=1000, Np=6, n_groups=4,
                          burnin=150, fresh_noise=True)
    chains = tdm.sample(model, de, 400, key=4, device="cpu")
    data = np.asarray(model.data, dtype=np.float64)
    assert abs(chains.mean("mu") - data.mean()) < 0.2
    assert abs(chains.mean("sigma") - data.std()) < 0.25


def test_fresh_noise_weights_differ_across_iterations():
    """The initial weights are scored on the INIT_NOISE_NS panel (the
    fused path's), and a step's evaluation of the same population on its
    own EVAL_NS panel differs from them and from the next iteration's."""
    model, de = _fresh_binomial(n_sim=400, Np=4, burnin=10)
    spec = tdm.make_spec(model, de)
    st = tdm.init_state(model, de, spec, 0, device="cpu")
    fit = taccept.make_fitness(model, spec, de)
    C = de.n_chains
    init = trng.to_uni(trng.words(0, 0, 400, C, ns=trng.INIT_NOISE_NS))
    assert torch.equal(st.weight, fit(st.theta, init))
    step = tdm.build_step(model, de, spec, "cpu", allow_fused=False)
    th = st.theta.view(de.n_groups, de.Np, 1)
    w1 = step.fitness(th, step._panel(None, 0, 1, None, None))
    w2 = step.fitness(th, step._panel(None, 0, 2, None, None))
    assert torch.any(w1 != w2)
    assert torch.any(w1.reshape(-1) != st.weight)


# ---- the port's contracts

def test_eval_panel_is_the_words_at_its_rows():
    """An evaluation's panel is ``rng.words``' uniforms of EVAL_NS at its
    rows (block, member, index) and the shard's chains: the plain version
    of the card's one ``philox_fill`` launch."""
    seed, it, n_noise, Np = 9, 4, 37, 4
    row0 = trng.eval_row(1, 2, Np, n_noise)
    got = tfused.philox_uniforms(seed, it, n_noise, 8, trng.EVAL_NS, "cpu",
                                 row0=row0, chain0=8)
    whole = trng.to_uni(trng.words(seed, it, row0 + n_noise, 24,
                                   ns=trng.EVAL_NS))
    assert torch.equal(got, whole[row0:, 8:16])
    out = torch.empty((5, 3), dtype=torch.uint32)
    tfused.philox_fill(out, seed, it, trng.CUSTOM_NS, row0=6, chain0=2)
    assert torch.equal(out, trng.words(seed, it, 5, 3, trng.CUSTOM_NS,
                                       row0=6, chain0=2))
    with pytest.raises(ValueError, match="2\\*\\*32"):
        tfused.philox_uniforms(seed, it, 8, 2, trng.EVAL_NS, "cpu",
                               row0=(1 << 32) - 4)


@pytest.mark.parametrize("case", ["binomial-sequential", "kde-blocks"])
def test_fresh_noise_sharded_equals_unsharded(case):
    """A fresh-noise run on 2 CPU shards is the unsharded run bit for bit:
    each shard's panels are its chains' columns of the population's."""
    if case == "binomial-sequential":
        model, de = _fresh_binomial(n_sim=300, Np=4, n_groups=4, burnin=6,
                                    alpha=0.5, discard_burnin=False)
    else:
        model, de = tabc.make(n_sim=200, Np=6, n_groups=4, burnin=6,
                              alpha=0.5, discard_burnin=False,
                              fresh_noise=True,
                              blocks=[[True, False], [False, True]],
                              blocking_on=lambda v: v.iter % 2 == 0)
    kw = dict(key=3, device="cpu", allow_fused=False, return_state=True)
    ref, ref_state = tdm.sample(model, de, 12, **kw)
    got, state = tdm.sample(model, de, 12,
                            mesh=tdm.chain_mesh(devices=["cpu"] * 2), **kw)
    np.testing.assert_array_equal(got.data, ref.data)
    np.testing.assert_array_equal(got.lp, ref.lp)
    np.testing.assert_array_equal(got.acceptance, ref.acceptance)
    assert torch.equal(state.weight, ref_state.weight)
    assert 0.0 < ref.acceptance.mean() < 1.0
