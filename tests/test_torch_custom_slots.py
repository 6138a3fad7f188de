"""The custom strategy slots of the port (``generate_proposal``,
``sample``, ``update_particle``, ``evaluate_fitness`` as callables with
the JAX signatures) against the JAX package, on the CPU.

* Bits-in: the port's unfused step, fed the JAX XLA step's pool and
  scalars (``test_torch_unfused_step.py``'s ``jax_run``), against the
  JAX step with the same slot written against the JAX API: a ``sample``
  slot delegating to ``sample_current`` (four and five arguments), a
  ``generate_proposal`` delegating to ``random_gamma``, the tempered
  ``evaluate_fitness`` (T = 2) and the always-accept ``update_particle``.
  Tolerances as ``test_torch_unfused_step.py`` states them (θ within
  1e-6 + 1e-6·|θ|, w within 1e-5 + 1e-5·|w|, accept flags exactly, away
  from near-ties).
* The JAX package's ``tests/test_custom_slots.py``, ported: ``next_key``
  distinct across copies of the context, not aliasing the pool, raising
  without a key; the custom slot invoked; the random-walk proposal
  (1,500 iterations, burn-in 750, against the JAX test's 4,000 and 1,000:
  750 kept draws of 24 chains, whose mean is within ~0.01 of the
  posterior's, against bounds of 0.05 and 0.07), tempering (1,500
  iterations against 3,000: 1,000 kept draws of 24 chains put each sd
  within a few per cent, and the ratio's limit √2 is 13% above the 1.25
  bound) and always-accept.
* The port's contracts: a custom slot's run is bit for bit the same on 2
  CPU shards; a slot that delegates to a built-in gives the built-in's
  unfused run bit for bit; ``fused_supported`` is False for each slot.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import demcmc_tpu as jdm
from demcmc_tpu.models import binomial as jbin
from demcmc_tpu.models import gaussian as jgauss
from demcmc_tpu.ops import proposals as jprop

import demcmc_tpu_torch as tdm
from demcmc_tpu_torch import rng as trng
from demcmc_tpu_torch.models import binomial as tbin
from demcmc_tpu_torch.models import gaussian as tgauss
from demcmc_tpu_torch.ops import accept as taccept
from demcmc_tpu_torch.ops import proposals as tprop
from test_torch_unfused_step import (DATA, _check, _theta0, fed_pool,
                                     jax_run, margins)  # noqa: F401


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test (many small torch operations)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- each slot written against each package's API (torch for jax)

def jax_partners4(ctx, key, n, exclude_self):
    return jprop.sample_current(ctx, key, n, exclude_self)


def port_partners4(ctx, key, n, exclude_self):
    return tprop.sample_current(ctx, key, n, exclude_self)


def jax_partners5(ctx, key, n, exclude_self, replace):
    return jprop.sample_current(ctx, key, n, exclude_self, replace)


def port_partners5(ctx, key, n, exclude_self, replace):
    return tprop.sample_current(ctx, key, n, exclude_self, replace)


def jax_proposal(ctx, key):
    return jprop.random_gamma(ctx, key)


def port_proposal(ctx, key):
    return tprop.random_gamma(ctx, key)


def jax_tempered(model, spec, de, x):
    return 0.5 * jdm.compute_posterior(model, spec, de, x)


def port_tempered(model, spec, de, x):
    return 0.5 * tdm.compute_posterior(model, spec, de, x)


def jax_always(key, w_cur, w_prop, log_adj):
    return jnp.ones(w_cur.shape, bool)


def port_always(key, w_cur, w_prop, log_adj):
    return torch.ones(w_cur.shape, dtype=torch.bool, device=w_cur.device)


def port_random_walk(ctx, key):
    return ctx.theta + 0.15 * key.normal(ctx.theta.shape, ctx.theta.dtype)


def port_keyed_mh(key, w_cur, w_prop, log_adj):
    """MH with its uniform drawn from the update's own key."""
    return tdm.mh_update(key, w_cur, w_prop, log_adj)


def _gauss(kw):
    return jgauss.make(data=DATA, **kw[0]), tgauss.make(data=DATA, **kw[1])


def _binomial(kw):
    """The exact binomial (per-cell densities on both sides), the JAX
    test's model for the always-accept rule: accepting every proposal
    takes the Gaussian to weights of order 1e5, where its per-observation
    sum (JAX) and sufficient statistics (the port) part by more than the
    stated tolerance."""
    return (jbin.make(N=10, k=5, **kw[0]), tbin.make(N=10, k=5, **kw[1]))


# (case, model, slot, JAX slot, port slot, DE settings, key)
CASES = [
    ("sample-4", _gauss, "sample", jax_partners4, port_partners4,
     dict(burnin=2, alpha=0.1), 21),
    ("sample-5", _gauss, "sample", jax_partners5, port_partners5,
     dict(burnin=2, theta_snooker=0.5), 22),
    ("proposal", _gauss, "generate_proposal", jax_proposal, port_proposal,
     dict(burnin=2, alpha=0.1), 23),
    ("tempered", _gauss, "evaluate_fitness", jax_tempered, port_tempered,
     dict(burnin=2), 24),
    ("always-accept", _binomial, "update_particle", jax_always, port_always,
     dict(burnin=2), 25),
]


@pytest.mark.parametrize("name,maker,slot,jslot,tslot,kw,key", CASES,
                         ids=[c[0] for c in CASES])
def test_custom_slot_step_matches_jax_xla_step(margins, name, maker, slot,
                                               jslot, tslot, kw, key):
    """Four iterations (G = 4, Np = 8, across burn-in) of the port's step
    core with the custom slot, fed the JAX pool and scalars, against the
    JAX XLA step with its JAX twin: the pool as wide and used to its last
    column; θ, w and the accept flags after each."""
    G, Np, K = 4, 8, 4
    size = dict(Np=Np, n_groups=G, **kw)
    (jm, jde), (model, de) = maker(({slot: jslot, **size},
                                    {slot: tslot, **size}))
    assert de.custom_slots == (slot,)
    C = G * Np
    rng = np.random.default_rng(key)
    theta0 = (_theta0("gauss", C, rng) if maker is _gauss
              else rng.uniform(0.2, 0.8, (C, 1)).astype(np.float32))
    spec = tdm.make_spec(model, de)
    w0 = taccept.make_fitness(model, spec, de)(torch.tensor(theta0)).numpy()
    n_words, pools, scalars, outs = jax_run(jm, jde, theta0, w0, key, 1, K)
    step = tdm.build_step(model, de, spec, device="cpu")
    assert isinstance(step, tdm.UnfusedStep)
    assert step.pool_words == n_words
    th = torch.tensor(theta0).view(G, Np, -1)
    w = torch.tensor(w0).view(G, Np)
    for k in range(K):
        draws = fed_pool(pools[k], scalars[k])
        th, w, acc = step.step_core(draws, th, w, 1 + k, step.fitness,
                                    seed=key)
        assert draws.offset == n_words
        _check(th.reshape(C, -1).numpy(), w.reshape(C).numpy(),
               acc.reshape(C).numpy(), outs[k], (1e-5, 1e-5))
    assert all((m.abs() > 1e-3).all() for m in margins), "near-tie"
    if name == "always-accept":
        assert acc.all()


# ---- the JAX package's tests/test_custom_slots.py

def _ctx(key=None):
    return tprop.ProposalContext(
        de=None, spec=None, theta=torch.zeros((1, 4, 2)),
        weight=torch.zeros((1, 4)), iteration=1, history=None, key=key)


def test_next_key_distinct_across_context_copies():
    """The counter survives ``dataclasses.replace`` copies, so successive
    calls never reuse a key: three keys, three different streams."""
    ctx = _ctx(trng.Key(0, 1, 1))
    k1 = ctx.next_key()
    k2 = replace(ctx, theta=torch.ones((1, 4, 2))).next_key()
    k3 = ctx.next_key()
    words = [k.words for k in (k1, k2, k3)]
    assert len(set(words)) == 3
    draws = [k.bits((1, 8)) for k in (k1, k2, k3)]
    assert not torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[1], draws[2])


def test_next_key_does_not_alias_the_pool():
    """A context key's words are not the iteration's pool words (another
    Philox namespace under other key words): no word of four next_key()
    draws is among the pool's."""
    seed, it, G = 7, 3, 4
    ctx = _ctx(trng.Key(seed, it, G).fold_in(trng.CUSTOM))
    pool = set(trng.words(seed, it, 64, G, ns=trng.POOL_NS).to(
        torch.int64).reshape(-1).tolist())
    for _ in range(4):
        got = ctx.next_key().bits((G, 16)).reshape(-1).tolist()
        assert not pool & set(got)


def test_next_key_without_key_raises():
    with pytest.raises(ValueError, match="key"):
        _ctx().next_key()


def test_key_draws_follow_the_pool_idiom_and_shard():
    """A key's group-shaped draws take columns per group in call order,
    and a shard's key (its first group ``chain0``) draws the rows of the
    population's draw; other shapes come from one global stream, the same
    on every shard."""
    whole = trng.Key(3, 5, 8).fold_in(11)
    shard = trng.Key(3, 5, 4, chain0=4).fold_in(11)
    a, b = whole.normal((8, 6, 2)), shard.normal((4, 6, 2))
    assert torch.equal(a[4:], b)
    assert torch.equal(whole.randint((2, 8), 0, 5)[:, 4:],
                       shard.randint((2, 4), 0, 5))
    assert torch.equal(whole.uniform((3,)), shard.uniform((3,)))
    u = trng.Key(3, 5, 8).uniform((8, 1000))
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01


def _bounded_prior(uniform, n):
    """μ ~ N(0, 1), σ ~ U(0.5, 2): a bounded start, as the JAX test's (a
    ±0.15 walk cannot come down from the half-Cauchy's σ ≈ 10² draws)."""
    u = uniform(3)
    mu = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u[0], trng.TINY))) \
        * torch.cos(2.0 * np.pi * u[1])
    return [mu, 0.5 + 1.5 * u[2]]


def test_custom_generate_proposal():
    """A plain random-walk proposal drawing from its key instead of DE:
    still a valid MH chain, near the quadrature posterior."""
    model, de = tgauss.make(key=5, n_obs=50, burnin=750,
                            generate_proposal=port_random_walk)
    model.sample_prior = _bounded_prior
    chains = tdm.sample(model, de, 1500, key=1, device="cpu")
    truth = tgauss.posterior_grid(model.data)
    assert abs(chains.mean("mu") - truth["mu"]["mean"]) < 0.05
    assert abs(chains.mean("sigma") - truth["sigma"]["mean"]) < 0.07


def test_custom_sample_slot():
    """A custom partner source receiving (ctx, key, n, exclude_self) is
    called and the chain lands on the posterior."""
    calls = []

    def partners(ctx, key, n, exclude_self):
        calls.append(n)
        return tprop.sample_current(ctx, key, n, exclude_self)

    model, de = tgauss.make(key=5, n_obs=30, burnin=300, sample=partners)
    chains = tdm.sample(model, de, 1200, key=2, device="cpu")
    truth = tgauss.posterior_grid(model.data)
    assert calls, "custom sample slot was never invoked"
    assert abs(chains.mean("mu") - truth["mu"]["mean"]) < 0.08


def test_custom_evaluate_fitness_tempering():
    """A tempered posterior (T = 2) widens the chains measurably (sd ×
    √2 in the limit)."""
    model, de = tgauss.make(key=5, n_obs=50, burnin=500)
    cold = tdm.sample(model, de, 1500, key=3, device="cpu",
                      allow_fused=False)
    hot = tdm.sample(model, de.replace(evaluate_fitness=port_tempered),
                     1500, key=3, device="cpu")
    assert hot.std("mu") > 1.25 * cold.std("mu")


def test_custom_update_particle():
    """A custom acceptance rule (always-accept) is honoured."""
    model, de = tbin.make(N=10, k=5, burnin=10, discard_burnin=False,
                          update_particle=port_always)
    chains = tdm.sample(model, de, 100, key=4, device="cpu")
    assert chains.acceptance.mean() == 1.0


# ---- the port's contracts

SLOTS = {"generate_proposal": port_random_walk, "sample": port_partners5,
         "update_particle": port_keyed_mh,
         "evaluate_fitness": port_tempered}


@pytest.mark.parametrize("slot", list(SLOTS))
def test_custom_slot_runs_unfused_and_never_fuses(slot):
    """``fused_supported`` is False for each custom slot (the kernels take
    built-ins only), so ``build_step`` gives it the unfused step."""
    model, de = tgauss.make(data=DATA, Np=8, n_groups=4, **{slot:
                                                            SLOTS[slot]})
    assert model.cuda_density is not None
    assert not tdm.sampler.fused_supported(model, de)
    assert isinstance(tdm.build_step(model, de, tdm.make_spec(model, de),
                                     device="cpu"), tdm.UnfusedStep)


def test_custom_slots_sharded_equal_unsharded():
    """Every slot custom at once, two of them drawing from their keys (the
    random walk, MH from the update's key), three blocks' sweeps: the run
    on 2 CPU shards is the unsharded run bit for bit."""
    model, de = tgauss.make(data=DATA, Np=4, n_groups=8, burnin=10,
                            alpha=0.5, discard_burnin=False,
                            blocks=[[True, False], [False, True],
                                    [True, True]], blocking_on=True,
                            **SLOTS)
    ref, ref_state = tdm.sample(model, de, 24, key=9, device="cpu",
                                return_state=True)
    got, state = tdm.sample(model, de, 24, key=9, device="cpu",
                            mesh=tdm.chain_mesh(devices=["cpu"] * 2),
                            return_state=True)
    np.testing.assert_array_equal(got.data, ref.data)
    np.testing.assert_array_equal(got.lp, ref.lp)
    np.testing.assert_array_equal(got.acceptance, ref.acceptance)
    assert torch.equal(state.theta, ref_state.theta)
    assert 0.0 < ref.acceptance.mean() < 1.0


@pytest.mark.parametrize("slot,custom,kw", [
    ("sample", port_partners4, {}),
    ("sample", port_partners5, dict(theta_snooker=0.3)),
    ("generate_proposal", port_proposal, dict(sweep="sequential")),
], ids=["sample-4", "sample-5-snooker", "proposal-sequential"])
def test_delegating_slot_is_the_builtin_bit_for_bit(slot, custom, kw):
    """A custom slot that only calls its built-in draws from the pool as
    the built-in does: ``sample()`` equals the built-in's unfused run bit
    for bit."""
    model, de = tgauss.make(data=DATA, Np=6, n_groups=4, burnin=15,
                            discard_burnin=False, **kw)
    ref = tdm.sample(model, de, 30, key=4, device="cpu", allow_fused=False)
    got = tdm.sample(model, de.replace(**{slot: custom}), 30, key=4,
                     device="cpu")
    np.testing.assert_array_equal(got.data, ref.data)
    np.testing.assert_array_equal(got.lp, ref.lp)
    np.testing.assert_array_equal(got.acceptance, ref.acceptance)


def test_slot_configurations_compare_by_identity():
    """``DE`` keeps a callable as it is: equal and hashing alike for the
    same function, unequal for another; a function named like a built-in
    is not the built-in."""
    def random_gamma(ctx, key):
        return tprop.random_gamma(ctx, key)

    a = tdm.DE(Np=4, generate_proposal=port_proposal)
    assert a == tdm.DE(Np=4, generate_proposal=port_proposal)
    assert hash(a) == hash(tdm.DE(Np=4, generate_proposal=port_proposal))
    assert a != tdm.DE(Np=4, generate_proposal=random_gamma)
    assert tdm.DE(Np=4, generate_proposal=random_gamma).generate_proposal \
        is random_gamma
    assert tdm.DE(Np=4, generate_proposal=tdm.random_gamma) \
        .generate_proposal == "random_gamma"
    de = tdm.DE(Np=4, update_particle=port_always,
                evaluate_fitness=port_tempered)
    assert not (de.is_mh or de.is_maximize or de.is_minimize
                or de.fun_fitness)
    with pytest.raises(TypeError):
        tdm.DE(Np=4, sample=3)


def test_optimize_takes_custom_slots():
    """``optimize()`` shares the step, so it takes custom slots: a
    custom fitness (the negated log posterior: out of bounds +inf) with
    the built-in ``minimize`` (which the port refused with any fitness but
    'fun' before the slots were ported; the JAX package refuses only the
    posterior) finds the MAP, and a custom greedy update runs through the
    unfused step."""
    def neg_posterior(model, spec, de, x):
        return -tdm.compute_posterior(model, spec, de, x)

    def keep_smaller(key, w_cur, w_prop, log_adj):
        return w_prop < w_cur

    x = DATA.astype(np.float64)
    for slots in (dict(update_particle="minimize",
                       evaluate_fitness=neg_posterior),
                  dict(update_particle=keep_smaller,
                       evaluate_fitness=neg_posterior)):
        model, de = tgauss.make(data=DATA, Np=8, n_groups=4, burnin=100,
                                **slots)
        assert not tdm.sampler.fused_supported(model, de)
        pop = tdm.optimize(model, de, 400, key=2, device="cpu")
        theta, best = tdm.get_optimal(de, model, pop)
        assert abs(theta["mu"] - x.mean()) < 0.02
        assert abs(theta["sigma"] - x.std()) < 0.05
        assert np.isfinite(best)
